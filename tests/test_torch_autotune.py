"""The port's plan autotuner (``repro_torch/engine/autotune.py``) on the
CPU: the checks of ``tests/test_autotune.py`` that apply to the port (not
the TPU's VMEM pruning, ``tile_w_candidates`` / ``_vmem_bytes``), and
``tests/test_int5.py::test_layer_key_has_w_bits_axis``, with the
measurement monkeypatched as the JAX tests do it and the cache in
``tmp_path``; plus:

- ``layer_key`` equals the JAX package's for every VGG-16 and AlexNet
  layer on every datapath, at batch 1 and 8;
- no port cache file is a name the JAX package writes;
- the overrides of ``u8_tile`` / ``f32_tile`` (and the policy's knobs at
  plan time, and ``trim_conv2d``'s ``schedule``) are checked, the illegal
  ones raising;
- every schedule the tuner would search leaves the plain path's output as
  it is (on the CPU the kernel's wrapper runs the plain version);
- ``--tuning`` maps onto the policy in ``serve_cnn``, ``train`` and
  ``dryrun_cnn``; a serving bucket plans at its own batch.

Tuning measures on ``policy.tune_device``: "cpu" throughout here.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import CNN_REGISTRY as JAX_CNN_REGISTRY
from repro.engine import autotune as jax_autotune
from repro_torch.configs import CNN_REGISTRY, CNN_SMOKES
from repro_torch.engine import (ExecutionPolicy, autotune, execute,
                                plan_conv_layer, plan_model,
                                tune_conv_layer, tune_model)
from repro_torch.kernels import trim_conv2d as kern

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ExecutionPolicy(tune_device="cpu")
INT8_KW = dict(stride=1, padding=1, groups=1, relu=True, has_bias=False,
               requant_kind="mult_shift", in_sz=1, w_sz=1, out_sz=1)
INT8_ARGS = ((12, 16), 8, 3, 8)


def _pol(**kw) -> ExecutionPolicy:
    return CPU.with_overrides(**kw)


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    """Isolated plan-cache dir; the plan caches reset around the test."""
    monkeypatch.setenv("REPRO_TUNED_PLANS_DIR", str(tmp_path))
    autotune.reset_cache()
    yield tmp_path
    autotune.reset_cache()


def _fast_measure(monkeypatch, scripted=None, counter=None):
    """Deterministic measurement: real outputs (the identity gate stays
    honest), scripted per-substrate timings, optional call counting."""
    real = autotune._measure_plan

    def fake(plan, *, in_sz, warmup=1, reps=5, batch=1, device="cpu"):
        if counter is not None:
            counter.append(plan.substrate)
        us, out = real(plan, in_sz=in_sz, warmup=0, reps=1, batch=batch,
                       device=device)
        if scripted is not None:
            us = scripted[plan.substrate]
        return us, out

    monkeypatch.setattr(autotune, "_measure_plan", fake)
    return fake


def _cache_path():
    return autotune.cache_path("cpu")


# -- candidates ------------------------------------------------------------------

def test_candidate_policies_int8_cpu():
    """On the CPU integer layers search f32exact and oracle beside the
    default; float layers have only the default; a pinned substrate leads
    its own list."""
    cands = autotune.candidate_policies((16, 64), 16, 3, 16, in_sz=1,
                                        policy=CPU)
    assert [c.substrate for c in cands] == ["auto", "f32exact", "oracle"]
    assert all(c.tuning == "off" for c in cands)
    fl = autotune.candidate_policies((16, 64), 16, 3, 16, in_sz=4,
                                     policy=CPU)
    assert [c.substrate for c in fl] == ["auto"]
    pinned = autotune.candidate_policies((16, 64), 16, 3, 16, in_sz=1,
                                         policy=_pol(substrate="oracle"))
    assert [c.substrate for c in pinned] == ["oracle", "f32exact"]


@pytest.mark.parametrize("in_sz", [1, 2, 4])
def test_candidate_policies_kernel_sweep(in_sz):
    """With the kernel in the search each launch knob moves one at a time,
    every candidate plans (its lane's planner takes it) and differs from
    the default."""
    hw, c, k, f = (56, 56), 128, 3, 128
    cands = autotune.candidate_policies(hw, c, k, f, in_sz=in_sz,
                                        policy=CPU, include_kernel=True)
    kernel = [p for p in cands[1:] if p.substrate == "auto"]
    assert len(kernel) >= 4
    assert len(cands) == len(set(cands))
    moved = {name for p in kernel for name in autotune.SCHEDULE_FIELDS[1:]
             if getattr(p, name) is not None}
    want = ({"tile_h", "tile_w", "block_c", "n_split"} if in_sz == 4
            else {"path", "tile_h", "tile_w", "n_split", "stages"})
    assert moved == want
    default = plan_conv_layer(hw, c, k, f, in_sz=in_sz, policy=CPU)
    for p in kernel:
        lp = plan_conv_layer(hw, c, k, f, in_sz=in_sz, policy=p)
        assert lp != default and not lp.schedule.default


# -- the plan cache: persist, hit, key sensitivity, degradation -----------------

def test_bf16_lane_knobs_operands_and_key_match_jax(monkeypatch):
    """The bf16 lane (``in_sz`` 2): its moves are the bf16 planner's own
    (no ``block_c``, no slide path, the gather path only at C <= 8), its
    synthetic operands are bf16 x, w and bias as the JAX package's
    ``_measure_plan`` builds them, and its cache key is JAX's
    (``sz2.2.2``)."""
    for hw, c in (((56, 56), 128), ((24, 24), 3)):
        moves = autotune._knob_moves(hw, c, 3, 64, stride=1, padding=None,
                                     groups=1, in_sz=2, batch=8,
                                     decimate=False)
        assert moves and all("block_c" not in m for m in moves)
        assert all(m.get("path") in ("window", "gather") for m in moves)
        # the gather path only at C <= 8, where it is the default
        assert any(m.get("path") == "gather" for m in moves) == (c <= 8)
        for m in moves:
            plan_conv_layer(hw, c, 3, 64, in_sz=2,
                            policy=CPU.with_overrides(**m))
    with pytest.raises(ValueError):
        plan_conv_layer((56, 56), 128, 3, 64, in_sz=2,
                        policy=CPU.with_overrides(path="slide"))

    from repro.engine.plan import plan_conv_layer as jax_plan_conv_layer

    seen = {}

    def spy(plan, x, w, bias=None, requant=None, **kw):
        seen.update(x=x.dtype, w=w.dtype, bias=bias.dtype)
        return x[..., :1]

    monkeypatch.setattr(jax_autotune.execute, "run_conv2d", spy)
    jplan = jax_plan_conv_layer((8, 8), 4, 3, 8, relu=True, has_bias=True)
    jax_autotune._measure_plan(jplan, in_sz=2, warmup=0, reps=1)
    plan = plan_conv_layer((8, 8), 4, 3, 8, relu=True, has_bias=True,
                           in_sz=2, policy=CPU)
    x, w, bias, requant, shift = autotune._operands(plan, 2, 1, "cpu")
    assert {str(seen[k]) for k in ("x", "w", "bias")} == {"bfloat16"}
    assert x.dtype == w.dtype == bias.dtype == torch.bfloat16
    assert requant is None and shift is None
    kw = dict(stride=1, padding=None, groups=1, relu=True, has_bias=True,
              requant_kind=None, in_sz=2, w_sz=2, out_sz=2, emulate_hw=False)
    key = autotune.layer_key((8, 8), 4, 3, 8, **kw)
    assert key == jax_autotune.layer_key((8, 8), 4, 3, 8, **kw)
    assert " sz2.2.2 " in key


def test_tune_on_miss_persists_and_applies(plan_cache, monkeypatch):
    calls = []
    _fast_measure(monkeypatch, counter=calls)
    lp = plan_conv_layer(*INT8_ARGS, **INT8_KW, policy=_pol(tuning="auto"))
    assert calls, "auto tuning must measure on a miss"
    assert lp.tuned
    assert os.path.exists(_cache_path())
    data = json.load(open(_cache_path()))
    assert data["version"] == autotune.PLAN_CACHE_VERSION
    [(key, entry)] = list(data["plans"].items())
    assert key == autotune.layer_key(*INT8_ARGS, emulate_hw=False,
                                     **INT8_KW)
    assert entry["schedule"]["substrate"] == lp.substrate


def test_second_lookup_is_pure_cache_hit(plan_cache, monkeypatch):
    calls = []
    _fast_measure(monkeypatch, counter=calls)
    plan_conv_layer(*INT8_ARGS, **INT8_KW, policy=_pol(tuning="auto"))
    n_tune = len(calls)
    assert n_tune >= 2
    autotune.reset_cache()      # a fresh process: the file stays
    lp = plan_conv_layer(*INT8_ARGS, **INT8_KW, policy=_pol(tuning="auto"))
    assert len(calls) == n_tune, "a cache hit must not measure"
    assert lp.tuned
    autotune.reset_cache()
    lp2 = plan_conv_layer(*INT8_ARGS, **INT8_KW,
                          policy=_pol(tuning="cached"))
    assert lp2 == lp and len(calls) == n_tune


def test_cache_hit_reuses_the_executable(plan_cache, monkeypatch):
    """Plans rebuilt from the persisted cache are value-equal, so the
    executable cache (a captured graph on the card) is hit, not rebuilt;
    and the outputs are the same."""
    calls = []
    _fast_measure(monkeypatch, scripted={"auto": 100.0, "f32exact": 10.0,
                                         "oracle": 100.0}, counter=calls)
    cfg = CNN_SMOKES["vgg16"]
    p1 = plan_model(cfg, _pol(tuning="auto")).int8
    assert all(lp.tuned and lp.substrate == "f32exact" for lp in p1.layers)
    ex1 = execute.executable_for(p1, 2, "int8", device="cpu")
    n = len(calls)
    autotune.reset_cache()      # a fresh process: plans from the file
    p2 = plan_model(cfg, _pol(tuning="auto")).int8
    assert len(calls) == n
    assert p2 is not p1 and p2 == p1
    assert execute.executable_for(p2, 2, "int8", device="cpu") is ex1
    cached = plan_model(cfg, _pol(tuning="cached")).int8
    assert cached.layers == p1.layers


def test_cache_key_sensitivity():
    base = autotune.layer_key(*INT8_ARGS, emulate_hw=False, **INT8_KW)
    geom = autotune.layer_key((12, 17), *INT8_ARGS[1:], emulate_hw=False,
                              **INT8_KW)
    fdt = autotune.layer_key(*INT8_ARGS, emulate_hw=False,
                             **{**INT8_KW, "in_sz": 4})
    emu = autotune.layer_key(*INT8_ARGS, emulate_hw=True, **INT8_KW)
    epi = autotune.layer_key(*INT8_ARGS, emulate_hw=False,
                             **{**INT8_KW, "requant_kind": "shift"})
    assert len({base, geom, fdt, emu, epi}) == 5


def test_cache_key_carries_batch_axis():
    k1 = autotune.layer_key(*INT8_ARGS, emulate_hw=False, **INT8_KW)
    k4 = autotune.layer_key(*INT8_ARGS, emulate_hw=False, batch=4,
                            **INT8_KW)
    assert " n1 " in k1 and " n4 " in k4
    assert k1 != k4


def test_layer_key_has_w_bits_axis():
    kw = dict(stride=1, padding=1, groups=1, relu=True, has_bias=False,
              requant_kind="mult_shift", in_sz=1, w_sz=1, out_sz=1,
              emulate_hw=False)
    k8 = autotune.layer_key((12, 12), 8, 3, 8, **kw)
    k5 = autotune.layer_key((12, 12), 8, 3, 8, w_bits=5, **kw)
    assert k8.endswith(" w8") and k5.endswith(" w5") and k8 != k5


def _walk_keys(layer_key, cfg, datapath, batch, emulate_hw):
    """Every layer's key of ``tune_model``'s walk, by ``layer_key``."""
    int8 = datapath in ("int8", "int5")
    keys, c, last = [], cfg.layers[0].M, len(cfg.layers) - 1
    for i, l in enumerate(cfg.layers):
        keys.append(layer_key(
            (l.H_I, l.W_I), c, l.K, l.N, stride=l.stride, padding=l.padding,
            groups=c // l.M, relu=True, has_bias=not int8,
            requant_kind="mult_shift" if int8 and i != last else None,
            in_sz=1 if int8 else 4, w_sz=1 if int8 else 4,
            out_sz=(4 if i == last else 1) if int8 else 4,
            emulate_hw=emulate_hw, batch=batch,
            w_bits=5 if datapath == "int5" else 8))
        c = l.N
    return keys


@pytest.mark.parametrize("arch", ["vgg16", "alexnet"])
def test_layer_key_equals_jax(arch):
    n = 0
    for datapath in ("float", "int8", "int5"):
        for batch in (1, 8):
            for emu in (False, True):
                got = _walk_keys(autotune.layer_key, CNN_REGISTRY[arch],
                                 datapath, batch, emu)
                want = _walk_keys(jax_autotune.layer_key,
                                  JAX_CNN_REGISTRY[arch], datapath, batch,
                                  emu)
                assert got == want
                n += len(got)
    assert n == 12 * len(CNN_REGISTRY[arch].layers)


def test_tune_at_batch_persists_batch_keyed_winner(plan_cache, monkeypatch):
    _fast_measure(monkeypatch)
    plan_conv_layer(*INT8_ARGS, **INT8_KW, batch=4,
                    policy=_pol(tuning="auto"))
    data = json.load(open(_cache_path()))
    [(key, _)] = list(data["plans"].items())
    assert key == autotune.layer_key(*INT8_ARGS, emulate_hw=False, batch=4,
                                     **INT8_KW)
    lp1 = plan_conv_layer(*INT8_ARGS, **INT8_KW,
                          policy=_pol(tuning="cached"))
    assert not lp1.tuned


def test_cache_file_per_device_kind(plan_cache, monkeypatch):
    p_cpu = _cache_path()
    monkeypatch.setattr(autotune, "device_kind", lambda dev: "NVIDIA H100")
    p_card = _cache_path()
    assert p_cpu != p_card and "NVIDIA-H100" in p_card


def test_no_cache_file_the_jax_package_writes(plan_cache, monkeypatch):
    """The port's files are ``torch-<type>-<kind>.json``: never the JAX
    package's ``<backend>-<kind>.json`` (its ``cpu-cpu.json`` among them),
    whatever the device kind."""
    mine = os.path.basename(_cache_path())
    assert mine == "torch-cpu-cpu.json"
    assert mine != os.path.basename(jax_autotune.cache_path())
    real = autotune.device_kind
    for kind in ("cpu", "TPU v4", "NVIDIA H100 80GB HBM3"):
        monkeypatch.setattr(autotune, "device_kind", lambda dev, k=kind: k)
        assert os.path.basename(_cache_path()).startswith("torch-cpu-")
    monkeypatch.setattr(autotune, "device_kind", real)
    _fast_measure(monkeypatch)
    tune_model(CNN_SMOKES["vgg16"], CPU, datapath="int8", reps=1)
    assert os.listdir(plan_cache) == ["torch-cpu-cpu.json"]


def test_corrupt_cache_degrades_with_warning(plan_cache):
    path = _cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        lp = plan_conv_layer(*INT8_ARGS, **INT8_KW,
                             policy=_pol(tuning="cached"))
    default = plan_conv_layer(*INT8_ARGS, **INT8_KW, policy=CPU)
    assert not lp.tuned
    assert lp == default


def test_stale_cache_version_degrades_with_warning(plan_cache):
    path = _cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    key = autotune.layer_key(*INT8_ARGS, emulate_hw=False, **INT8_KW)
    sched = dict.fromkeys(autotune.SCHEDULE_FIELDS)
    sched["substrate"] = "f32exact"
    with open(path, "w") as f:
        json.dump({"version": autotune.PLAN_CACHE_VERSION + 1,
                   "plans": {key: {"schedule": sched}}}, f)
    with pytest.warns(RuntimeWarning, match="version"):
        lp = plan_conv_layer(*INT8_ARGS, **INT8_KW,
                             policy=_pol(tuning="cached"))
    assert not lp.tuned


@pytest.mark.parametrize("schedule", [
    {"substrate": "fpga"},
    dict(dict.fromkeys(("substrate", "tile_h", "tile_w", "block_c",
                        "n_split", "stages", "path")), substrate="auto",
         path="sideways"),
    dict(dict.fromkeys(("substrate", "tile_h", "tile_w", "block_c",
                        "n_split", "stages", "path")), substrate="auto",
         tile_h=8),
], ids=["substrate", "path", "half-tile"])
def test_invalid_entry_degrades_with_warning(plan_cache, schedule):
    path = _cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    key = autotune.layer_key(*INT8_ARGS, emulate_hw=False, **INT8_KW)
    with open(path, "w") as f:
        json.dump({"version": autotune.PLAN_CACHE_VERSION,
                   "plans": {key: {"schedule": schedule}}}, f)
    with pytest.warns(RuntimeWarning, match="invalid"):
        lp = plan_conv_layer(*INT8_ARGS, **INT8_KW,
                             policy=_pol(tuning="cached"))
    assert not lp.tuned


def test_pinned_substrate_beats_cache(plan_cache, monkeypatch):
    """Tuning composes with substrate "auto" only: a cached f32exact
    winner does not take over a pinned substrate, per policy or per layer
    through ``layer_substrates``."""
    _fast_measure(monkeypatch, scripted={"auto": 100.0, "oracle": 100.0,
                                         "f32exact": 10.0})
    plan_conv_layer(*INT8_ARGS, **INT8_KW, policy=_pol(tuning="auto"))
    for pin in ("oracle", "kernel"):
        lp = plan_conv_layer(*INT8_ARGS, **INT8_KW,
                             policy=_pol(substrate=pin, tuning="cached"))
        assert lp.substrate == pin and not lp.tuned
    lp = plan_conv_layer(*INT8_ARGS, **INT8_KW, policy=_pol(tuning="cached"))
    assert lp.substrate == "f32exact" and lp.tuned
    cfg = CNN_SMOKES["vgg16"]
    tune_model(cfg, CPU, datapath="int8", reps=1)
    plan = plan_model(cfg, _pol(tuning="cached"), datapath="int8",
                      layer_substrates=("oracle", None, None))
    assert plan.layers[0].substrate == "oracle" and not plan.layers[0].tuned
    assert plan.layers[1].tuned


def test_cached_miss_is_default_plan(plan_cache):
    lp = plan_conv_layer(*INT8_ARGS, **INT8_KW, policy=_pol(tuning="cached"))
    assert not lp.tuned and lp.substrate == "auto"
    assert lp == plan_conv_layer(*INT8_ARGS, **INT8_KW, policy=CPU)


def test_tuning_on_a_missing_card_raises(plan_cache, monkeypatch):
    """The default ``tune_device`` is the card: without one, tuning raises
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan_conv_layer(*INT8_ARGS, **INT8_KW,
                        policy=ExecutionPolicy(tuning="cached"))


# -- winner selection ----------------------------------------------------------

def test_winner_never_slower_than_default(plan_cache, monkeypatch):
    """A candidate inside the MIN_GAIN margin loses to the default."""
    _fast_measure(monkeypatch, scripted={"auto": 100.0, "oracle": 100.0,
                                         "f32exact": 98.0})
    res = tune_conv_layer(*INT8_ARGS, **INT8_KW, policy=CPU)
    assert res.schedule["substrate"] == "auto"
    assert res.us == res.us_default == 100.0


def test_winner_beats_default_outside_margin(plan_cache, monkeypatch):
    _fast_measure(monkeypatch, scripted={"auto": 100.0, "oracle": 100.0,
                                         "f32exact": 10.0})
    res = tune_conv_layer(*INT8_ARGS, **INT8_KW, policy=CPU)
    assert res.schedule["substrate"] == "f32exact"
    assert res.speedup == pytest.approx(10.0)
    assert set(res.schedule) == set(autotune.SCHEDULE_FIELDS)
    res2 = tune_conv_layer(*INT8_ARGS, **INT8_KW, policy=CPU)
    assert res2.cached and res2.schedule == res.schedule


def test_inexact_candidate_is_rejected(plan_cache, monkeypatch):
    """The identity gate: a candidate whose output differs from the
    default's never wins, however fast."""
    real = autotune._measure_plan

    def fake(plan, *, in_sz, warmup=1, reps=5, batch=1, device="cpu"):
        us, out = real(plan, in_sz=in_sz, warmup=0, reps=1, batch=batch,
                       device=device)
        if plan.substrate == "f32exact":
            return 1.0, out + 1
        return 100.0, out

    monkeypatch.setattr(autotune, "_measure_plan", fake)
    res = tune_conv_layer(*INT8_ARGS, **INT8_KW, policy=CPU)
    assert res.schedule["substrate"] == "auto"
    assert [c.schedule["substrate"] for c in res.candidates] == [
        "auto", "oracle"]


def test_a_failing_candidate_is_discarded(plan_cache, monkeypatch):
    real = autotune._measure_plan

    def fake(plan, *, in_sz, warmup=1, reps=5, batch=1, device="cpu"):
        if plan.substrate == "oracle":
            raise RuntimeError("launch refused")
        return real(plan, in_sz=in_sz, warmup=0, reps=1, batch=batch,
                    device=device)

    monkeypatch.setattr(autotune, "_measure_plan", fake)
    with pytest.warns(RuntimeWarning, match="discarded"):
        res = tune_conv_layer(*INT8_ARGS, **INT8_KW, policy=CPU)
    assert "oracle" not in [c.schedule["substrate"] for c in res.candidates]


# -- model level ---------------------------------------------------------------

def test_plan_model_layer_substrates_override():
    cfg = CNN_SMOKES["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy(),
                      layer_substrates=("f32exact", None, "oracle"))
    assert [lp.substrate for lp in plan.layers] == [
        "f32exact", "auto", "oracle"]
    with pytest.raises(ValueError, match="layer_substrates"):
        plan_model(cfg, ExecutionPolicy(), layer_substrates=("oracle",))


def test_tuned_model_plan_bit_identical_vgg16_smoke(plan_cache):
    """A cached tuned ModelPlan gives the default plan's bits, float
    forward and fused int8 forward (real measurement)."""
    cfg = CNN_SMOKES["vgg16"]
    tune_model(cfg, CPU, datapath="float", reps=2)
    tune_model(cfg, CPU, datapath="int8", reps=2)
    autotune.reset_cache()
    default = plan_model(cfg, CPU)
    tuned = plan_model(cfg, _pol(tuning="cached"))
    assert all(lp.tuned for lp in tuned.layers)
    assert all(lp.tuned for lp in tuned.int8.layers)
    gen = torch.Generator().manual_seed(0)
    params = default.init(gen, "cpu")
    img = torch.randn((2, 16, 16, 3), generator=gen)
    assert torch.equal(default.forward(params, img),
                       tuned.forward(params, img))
    qp, _ = default.quantize(params)
    u8 = torch.randint(0, 255, (1, 16, 16, 3), generator=gen,
                       dtype=torch.uint8)
    pairs = default.calibrate_requant(qp, u8)
    feat_d = default.forward_int8(qp, u8, requant=pairs)
    feat_t = tuned.forward_int8(qp, u8, requant=pairs)
    assert feat_d.dtype == feat_t.dtype
    assert torch.equal(feat_d, feat_t)


def test_tune_model_walk_matches_plan_model(plan_cache, monkeypatch):
    _fast_measure(monkeypatch)
    cfg = CNN_SMOKES["alexnet"]
    results = tune_model(cfg, CPU, datapath="int8", reps=1)
    assert len(results) == len(cfg.layers)
    autotune.reset_cache()
    plan = plan_model(cfg, _pol(tuning="cached"))
    assert all(lp.tuned for lp in plan.int8.layers)
    assert not any(lp.tuned for lp in plan.layers)   # float keys untouched


def test_bucket_plans_take_their_batch_winner(plan_cache, monkeypatch):
    """A serving engine plans each bucket at its batch: the winners tuned
    at batch 4 reach bucket 4's plan and not bucket 1's, and the lane's
    executable is built from that plan."""
    from repro_torch.serve.engine import ServeEngine
    _fast_measure(monkeypatch, scripted={"auto": 100.0, "oracle": 100.0,
                                         "f32exact": 10.0})
    cfg = CNN_SMOKES["vgg16"]
    tune_model(cfg, CPU, datapath="int8", batch=4, reps=1)
    plan = plan_model(cfg, _pol(tuning="cached"))
    gen = torch.Generator().manual_seed(0)
    qp, _ = plan.quantize(plan.init(gen, "cpu"))
    u8 = torch.randint(0, 255, (2, 16, 16, 3), generator=gen,
                       dtype=torch.uint8)
    pairs = plan.calibrate_requant(qp, u8)
    eng = ServeEngine.build_for_plan(plan, qp, buckets=(1, 4),
                                     datapath="int8", requant=pairs,
                                     device="cpu")
    assert eng.bucket_plan(4).batch == 4
    assert all(lp.tuned for lp in eng.bucket_plan(4).int8.layers)
    assert not any(lp.tuned for lp in eng.bucket_plan(1).int8.layers)
    lane = eng.lanes[0]
    assert eng._lane_key(lane, 4)[0] == eng.bucket_plan(4)
    assert eng._lane_exec(lane, 4).plan == eng.bucket_plan(4)
    out4 = eng.run_bucket(4, u8.repeat(2, 1, 1, 1).numpy())
    out1 = eng.run_bucket(1, u8[:1].numpy())
    assert torch.equal(torch.as_tensor(out4)[:1], torch.as_tensor(out1))


# -- the overrides ---------------------------------------------------------------

VGG_L = CNN_REGISTRY["vgg16"].layers


@pytest.mark.parametrize("bad,match", [
    (dict(tile=(8, 8)), "not in"),
    (dict(block_c=10 ** 5), "block_c"),
    (dict(n_split=10 ** 6), "n_split"),
    (dict(n_split=0), "n_split"),
])
def test_f32_tile_rejects_illegal_overrides(bad, match):
    with pytest.raises(ValueError, match=match):
        kern.f32_tile((14, 14), 512, 3, 512, stride=1, padding=None, **bad)


@pytest.mark.parametrize("bad,match", [
    (dict(path=kern.U8_SLIDE, tile=(8, 16)), "slide"),
    (dict(path=kern.U8_SLIDE, n_split=2), "slide"),
    (dict(path=kern.U8_WINDOW, tile=(16, 16)), "128"),
    (dict(stages=4), "stages"),
    (dict(n_split=10 ** 4), "n_split"),
])
def test_u8_tile_rejects_illegal_overrides(bad, match):
    with pytest.raises(ValueError, match=match):
        kern.u8_tile((56, 56), 256, 3, 256, stride=1, padding=None, **bad)


def test_slide_path_needs_k3_stride1():
    with pytest.raises(ValueError, match="does not take"):
        kern.u8_tile((227, 227), 3, 11, 96, stride=4, padding=0,
                     path=kern.U8_SLIDE)


def test_overrides_reach_the_geometry():
    t = kern.u8_tile((56, 56), 256, 3, 256, stride=1, padding=None,
                     path=kern.U8_WINDOW, tile=(4, 32), n_split=2, stages=2)
    assert (t.path, t.TH, t.TW, t.n_split, t.stages) == (
        kern.U8_WINDOW, 4, 32, 2, 2)
    assert t.smem_bytes <= kern.SMEM_MAX
    f = kern.f32_tile((56, 56), 256, 3, 256, stride=1, padding=None,
                      tile=(8, 32), block_c=4, n_split=3)
    assert (f.TH, f.TW, f.Cb, f.n_split) == (8, 32, 4, 3)
    assert f.smem_bytes <= kern.SMEM_MAX
    # and the launch arguments carry them
    _, args = kern.u8_launch_args((2, 56, 56, 256), 3, 256, 1, None,
                                  kern.Schedule(tile=(4, 32), n_split=2,
                                                stages=2, path="window"))
    assert args[-6:] == (kern.U8_WINDOW, 4, 32, t.steps, 2, 2)
    _, args = kern.f32_launch_args((2, 56, 56, 256), 3, 256, 1, None, True,
                                   kern.Schedule(tile=(8, 32), block_c=4,
                                                 n_split=3))
    assert args[11:15] == (8, 32, 4, 3)


def test_policy_knobs_are_checked_at_plan_time():
    l = VGG_L[2]
    with pytest.raises(ValueError, match="128"):
        plan_conv_layer((l.H_I, l.W_I), l.M, l.K, l.N, in_sz=1,
                        policy=ExecutionPolicy(tile_h=16, tile_w=16,
                                               path="window"))
    with pytest.raises(ValueError, match="not in"):
        plan_conv_layer((l.H_I, l.W_I), l.M, l.K, l.N,
                        policy=ExecutionPolicy(tile_h=8, tile_w=16))
    with pytest.raises(ValueError, match="together"):
        ExecutionPolicy(tile_h=8)
    with pytest.raises(ValueError, match="path"):
        ExecutionPolicy(path="diagonal")
    lp = plan_conv_layer((l.H_I, l.W_I), l.M, l.K, l.N, in_sz=1,
                         policy=ExecutionPolicy(path="window", n_split=2))
    assert lp.tile.path == kern.U8_WINDOW and lp.tile.n_split == 2
    assert lp.launch(8).n_split == 2
    rec = lp.describe((1, 8))
    assert rec["schedule"] == {"path": "window", "n_split": 2}
    assert "schedule" not in plan_conv_layer(
        (l.H_I, l.W_I), l.M, l.K, l.N, in_sz=1).describe()


def test_trim_conv2d_checks_its_schedule_on_the_cpu():
    x = torch.zeros((1, 14, 14, 16), dtype=torch.uint8)
    w = torch.zeros((3, 3, 16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="128"):
        kern.trim_conv2d(x, w, schedule=kern.Schedule(tile=(16, 16),
                                                      path="window"))
    with pytest.raises(TypeError, match="Schedule"):
        kern.trim_conv2d(x, w, schedule={"tile": (4, 4)})
    with pytest.raises(ValueError, match="not in"):
        kern.trim_conv2d(x.float(), w.float(),
                         schedule=kern.Schedule(tile=(4, 4)))
    # dx's conv (16 channels into 16 filters from 8) takes its schedule
    from repro_torch.kernels.trim_conv2d_vjp import trim_conv2d_input_grad
    g = torch.zeros((1, 14, 14, 8))
    with pytest.raises(ValueError, match="block_c"):
        trim_conv2d_input_grad(g, w.float(), x_hw=(14, 14),
                               schedule=kern.Schedule(block_c=9))
    dx = trim_conv2d_input_grad(g, w.float(), x_hw=(14, 14),
                                schedule=kern.Schedule(block_c=8))
    assert dx.shape == (1, 14, 14, 16)


@pytest.mark.parametrize("in_sz", [1, 4])
def test_plain_output_unchanged_by_any_schedule(in_sz):
    """Every schedule the tuner searches at a small shape (kernel knobs
    included) gives the default plan's output bit for bit on the CPU."""
    hw, c, k, f = (18, 18), 16, 3, 32
    kw = dict(relu=True, has_bias=in_sz == 4, in_sz=in_sz, w_sz=in_sz,
              out_sz=in_sz,
              requant_kind="mult_shift" if in_sz == 1 else None)
    policies = autotune.candidate_policies(
        hw, c, k, f, in_sz=in_sz, policy=CPU, include_kernel=True)
    assert len(policies) > 3
    plans = [plan_conv_layer(hw, c, k, f, policy=p, **kw) for p in policies]
    outs = [autotune._measure_plan(p, in_sz=in_sz, warmup=0, reps=1,
                                   batch=2, device="cpu")[1] for p in plans]
    for p, o in zip(plans[1:], outs[1:]):
        assert o.dtype == outs[0].dtype
        np.testing.assert_array_equal(o, outs[0], err_msg=str(p.schedule))


# -- policy / CLI mapping ----------------------------------------------------------

def test_policy_tuning_validation():
    assert ExecutionPolicy().tuning == "off"
    assert ExecutionPolicy(tuning="auto").tuning == "auto"
    with pytest.raises(ValueError, match="tuning"):
        ExecutionPolicy(tuning="always")
    with pytest.raises(ValueError, match="tune_device"):
        ExecutionPolicy(tune_device="meta")


def test_cli_tuning_maps_to_policy():
    from repro_torch.launch.cli import execution_parent, policy_from_args
    ap = argparse.ArgumentParser(parents=[execution_parent()])
    ap.add_argument("--device", default="cuda")
    for mode in ("off", "cached", "auto"):
        args = ap.parse_args(["--tuning", mode, "--device", "cpu"])
        assert policy_from_args(args) == ExecutionPolicy(tuning=mode,
                                                         tune_device="cpu")
    assert policy_from_args(ap.parse_args([])).tuning == "off"
    assert policy_from_args(argparse.Namespace()) == ExecutionPolicy()


def _launch(module, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TUNED_PLANS_DIR=str(tmp_path / "plans"),
               REPRO_DRYRUN_DEVICES="8", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_launchers_take_tuning(tmp_path):
    """``serve_cnn`` and ``train`` tune the smoke VGG-16 and AlexNet on the
    CPU under
    ``--tuning auto`` (the port's cache file, and only it, appears), and
    ``dryrun_cnn`` plans from it under ``--tuning cached``."""
    _launch("repro_torch.launch.serve_cnn",
            ["--arch", "vgg16", "--smoke", "--int8", "--device", "cpu",
             "--tuning", "auto", "--buckets", "1,4", "--requests", "8",
             "--check", "--out", str(tmp_path / "serve.json")], tmp_path)
    plans = tmp_path / "plans"
    assert os.listdir(plans) == ["torch-cpu-cpu.json"]
    keys = json.load(open(plans / "torch-cpu-cpu.json"))["plans"]
    assert any(" n4 " in k for k in keys) and any(" n1 " in k for k in keys)
    served = json.load(open(tmp_path / "serve.json"))
    assert all(layer.get("tuned") for layer in served["plan"])
    assert sorted(served["bucket_plans"]) == ["1", "4"]
    assert all(layer.get("tuned") for layer in served["bucket_plans"]["4"])
    _launch("repro_torch.launch.train",
            ["--arch", "alexnet", "--smoke", "--steps", "1", "--batch", "2",
             "--device", "cpu", "--tuning", "auto"], tmp_path)
    n = len(json.load(open(plans / "torch-cpu-cpu.json"))["plans"])
    assert n > len(keys)
    out = tmp_path / "dry"
    _launch("repro_torch.launch.dryrun_cnn",
            ["--arch", "alexnet", "--batch", "8", "--tuning", "cached",
             "--out", str(out)], tmp_path)
    [rec] = [json.load(open(out / f)) for f in os.listdir(out)]
    assert rec["tuning"] == "cached"
