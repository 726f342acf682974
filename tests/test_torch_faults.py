"""The port's fault plane on the CPU against the JAX package's.

Every check of ``tests/test_faults.py`` runs on the port, and where a check
is about a value both packages compute, on both and across them: the
``FaultPlan`` / ``RetryPolicy`` / ``CircuitBreaker`` primitives on each
package's classes (``pkg`` = "jax" / "port"), with equal plans, delays and
breaker states; ``PackedWire`` built from the same float weights (JAX's
``init_cnn`` carried across by ``repro_torch.weights``) with its packed
bytes and CRC-32s equal byte for byte, the same planned bit-flips, and its
``qparams`` equal to ``plan.quantize_int5``'s; inline chaos on a fake
clock with conservation and bit-exact results; int5 -> int8 degradation
whose outputs equal a native int8 engine's and the JAX package's degraded
outputs bit for bit; the restore before serving; the faults-off snapshot
with no resilience keys; the armed-but-empty plan equal to a fault-free
snapshot; and the threaded chaos property under the runtime lock
sanitizer, with a faulthandler guard, in which every executable is built
once (the port's stand-in for the JAX ``retrace_sentinel``).  Then the
launcher's ladders through ``serve_cnn.build_server(device="cpu")``:
int8 -> ``int8-f32exact`` bit-identical, float -> ``float-oracle``
equal to an oracle engine's outputs, and the ``--faults`` launcher run
with ``--device cpu --check``.
"""
import faulthandler
import functools
import json
import os
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import repro.serve.faults as j_faults
import repro_torch.serve.faults as p_faults
from repro.configs import CNN_SMOKES as JAX_SMOKES
from repro.data.pipeline import SyntheticRequestStream as JaxStream
from repro.engine import ExecutionPolicy as JaxPolicy
from repro.engine import execute as jax_execute
from repro.engine import plan_model as jax_plan_model
from repro.serve import Lane as JaxLane
from repro.serve import PackedWire as JaxWire
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch.configs import CNN_SMOKES
from repro_torch.data.pipeline import SyntheticRequestStream
from repro_torch.engine import ExecutionPolicy, execute, plan_model
from repro_torch.launch import serve_cnn
from repro_torch.serve import (FaultPlan, Lane, PackedWire, ServeConfig,
                               ServeEngine, Server)
from repro_torch.serve.faults import FaultInjector
from repro_torch.weights import from_jax_params
from tools.analysis.runtime import sanitize_server

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = CNN_SMOKES["vgg16"]
JCFG = JAX_SMOKES["vgg16"]
FAULTS = {"jax": j_faults, "port": p_faults}
BOTH = pytest.mark.parametrize("pkg", sorted(FAULTS))

#: resilience counters that must NOT appear in a faults-off snapshot
RESILIENCE_KEYS = {"failed", "retried", "degraded", "worker_restarts",
                   "integrity_restored"}


class FakeClock:
    """Deterministic clock + sleep pair; a sleep returns one nanosecond
    late, as a real one does (``tests/test_torch_serve.py``)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(dt, 0.0) + 1e-9


def _stream(cls=SyntheticRequestStream, n=6, process="bursts",
            dtype="float32", seed=0, **kw):
    return cls(hw=CFG.input_hw, channels=CFG.layers[0].M,
               n_classes=CFG.n_classes, n_requests=n, seed=seed,
               process=process, dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _jax_plan_params():
    jplan = jax_plan_model(JCFG, JaxPolicy())
    return jplan, jplan.init(jax.random.PRNGKey(0))


def _float_plan_params():
    """The port's plan and the JAX package's float weights, carried over."""
    _, jparams = _jax_plan_params()
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return plan_model(CFG, ExecutionPolicy()), params


def _int5_ladder_server(faults, buckets=(1, 4), clock=None, **cfgkw):
    """The port's int5 server with its whole ladder: the PackedWire
    payload and an int8 fallback lane calibrated on the same sample from
    the same float master (what ``serve_cnn.build_server`` arms)."""
    plan, params = _float_plan_params()
    calib = torch.from_numpy(_stream(dtype="uint8").sample_batch(4))
    qparams, _ = plan.quantize_int5(params)
    requant = plan.calibrate_requant_int5(qparams, calib)
    q8, _ = plan.quantize(params)
    fallbacks = [Lane("int8", "int8", q8, plan.calibrate_requant(q8, calib))]
    cfg = ServeConfig(buckets=buckets, datapath="int5", faults=faults,
                      **cfgkw)
    kw = {} if clock is None else dict(clock=clock, sleep=clock.sleep)
    return Server.from_plan(plan, qparams, cfg, requant=requant,
                            fallbacks=fallbacks,
                            wire=PackedWire(CFG, params), device="cpu", **kw)


def _jax_int5_ladder_server(faults, buckets, clock, **cfgkw):
    jplan, jparams = _jax_plan_params()
    calib = _stream(JaxStream, dtype="uint8").sample_batch(4)
    qparams, _ = jplan.quantize_int5(jparams)
    requant = jplan.calibrate_requant_int5(qparams, calib)
    q8, _ = jplan.quantize(jparams)
    fallbacks = [JaxLane("int8", "int8", q8,
                         jplan.calibrate_requant(q8, calib))]
    cfg = JaxServeConfig(buckets=buckets, datapath="int5", faults=faults,
                         **cfgkw)
    return JaxServer.from_plan(jplan, qparams, cfg, requant=requant,
                               fallbacks=fallbacks,
                               wire=JaxWire(JCFG, jparams), clock=clock,
                               sleep=clock.sleep)


@pytest.fixture
def deadlock_guard():
    """A stuck thread fails the test fast instead of hanging the run."""
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def test_serve_exports_what_the_jax_package_exports_from_faults():
    import repro.serve as jserve
    import repro_torch.serve as pserve

    names = {n for n in jserve.__all__
             if getattr(getattr(jserve, n), "__module__", None)
             == "repro.serve.faults"}
    assert "PackedWire" in names and "CircuitBreaker" in names
    for n in names:
        assert n in pserve.__all__, n
        assert getattr(pserve, n) is getattr(p_faults, n)


# ---------------------------------------------------------------------------
# FaultPlan: the seeded chaos schedule
# ---------------------------------------------------------------------------


@BOTH
def test_fault_plan_parse_aliases_and_describe(pkg):
    plan = FAULTS[pkg].FaultPlan.parse(
        "seed=7,stage=2,worker=1,bitflip=1,latency=2,latency-ms=25")
    assert plan.seed == 7
    assert plan.stage_faults == 2 and plan.worker_crashes == 1
    assert plan.bitflips == 1 and plan.latency_spikes == 2
    assert plan.latency_spike_ms == 25.0
    assert plan.total_budget == 6
    d = plan.describe()
    assert d["seed"] == 7 and d["stage_faults"] == 2
    assert "exec_faults" not in d
    assert d == j_faults.FaultPlan.parse(
        "seed=7,stage=2,worker=1,bitflip=1,latency=2,latency-ms=25"
    ).describe()


@BOTH
def test_fault_plan_parse_rejects_unknown_and_negative(pkg):
    with pytest.raises(ValueError, match="unknown --faults"):
        FAULTS[pkg].FaultPlan.parse("seed=1,frobnicate=3")
    with pytest.raises(ValueError):
        FAULTS[pkg].FaultPlan.parse("stage=-1")


@BOTH
def test_fault_plan_empty_spec_is_armed_but_inert(pkg):
    assert FAULTS[pkg].FaultPlan.parse("seed=9").total_budget == 0


# ---------------------------------------------------------------------------
# RetryPolicy: bounded backoff with replayable jitter
# ---------------------------------------------------------------------------


@BOTH
def test_retry_delay_is_deterministic_and_grows(pkg):
    pol = FAULTS[pkg].RetryPolicy(max_attempts=4, backoff_s=0.01,
                                  multiplier=2.0, jitter=0.5, seed=3)
    d = [pol.delay(k, salt="x") for k in range(3)]
    assert d == [pol.delay(k, salt="x") for k in range(3)]
    assert d[0] != pol.delay(0, salt="y")
    for k, dk in enumerate(d):
        base = 0.01 * 2.0 ** k
        assert base <= dk <= base * 1.5
    jpol = j_faults.RetryPolicy(max_attempts=4, backoff_s=0.01,
                                multiplier=2.0, jitter=0.5, seed=3)
    assert d == [jpol.delay(k, salt="x") for k in range(3)]


@BOTH
def test_with_retries_recovers_transients_and_reraises_exhausted(pkg):
    f = FAULTS[pkg]
    clk = FakeClock()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise f.TransientFault("boom")
        return "ok"

    pol = f.RetryPolicy(max_attempts=3, backoff_s=0.01)
    assert f.with_retries(flaky, pol, sleep=clk.sleep, salt="t") == "ok"
    assert len(calls) == 3 and clk.t > 0

    def always():
        raise f.TransientFault("never")

    with pytest.raises(f.TransientFault):
        f.with_retries(always, pol, sleep=clk.sleep, salt="t")


@BOTH
def test_with_retries_never_retries_worker_crash(pkg):
    f = FAULTS[pkg]
    calls = []

    def crash():
        calls.append(1)
        raise f.WorkerCrash("dead")

    with pytest.raises(f.WorkerCrash):
        f.with_retries(crash, f.RetryPolicy(max_attempts=5),
                       sleep=lambda s: None, salt="w")
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# CircuitBreaker: closed -> open, success resets, open is permanent
# ---------------------------------------------------------------------------


@BOTH
def test_breaker_trips_once_at_threshold_and_stays_open(pkg):
    br = FAULTS[pkg].CircuitBreaker(threshold=3)
    assert [br.failure("k") for _ in range(3)] == [False, False, True]
    assert br.tripped("k")
    assert br.failure("k") is False
    assert not br.tripped("other")
    assert br.state() == {"k": {"failures": 3, "tripped": 1}}


@BOTH
def test_breaker_success_resets_the_count(pkg):
    br = FAULTS[pkg].CircuitBreaker(threshold=2)
    assert br.failure("k") is False
    br.success("k")
    assert br.failure("k") is False
    assert br.failure("k") is True


# ---------------------------------------------------------------------------
# PackedWire: checksummed int5 payload, restore-from-master
# ---------------------------------------------------------------------------


def _wires():
    plan, params = _float_plan_params()
    _, jparams = _jax_plan_params()
    return plan, params, PackedWire(CFG, params), JaxWire(JCFG, jparams)


def _same_bytes(wire, jwire):
    assert wire.n_layers == jwire.n_layers == len(CFG.layers)
    assert wire.nbytes() == jwire.nbytes()
    assert wire._crcs == jwire._crcs
    for a, b in zip(wire._packed, jwire._packed):
        assert a.dtype == b.dtype == np.uint8
        assert a.tobytes() == b.tobytes()
    for a, b in zip(wire._shifts, jwire._shifts):
        np.testing.assert_array_equal(a, b)
    assert wire._shapes == jwire._shapes


def test_packed_wire_bytes_and_crcs_equal_the_jax_package():
    """The same float weights give the same packed int5 bytes, the same
    shifts and the same CRC-32 per layer; the seeded injector flips the
    same bit in both, and both restore to the same bytes."""
    _, _, wire, jwire = _wires()
    _same_bytes(wire, jwire)
    plan = FaultPlan.parse("seed=3,bitflip=2")
    inj, jinj = FaultInjector(plan), j_faults.FaultInjector(
        j_faults.FaultPlan.parse("seed=3,bitflip=2"))
    inj.wire, jinj.wire = wire, jwire
    for _ in range(2):
        assert inj.maybe_flip() and jinj.maybe_flip()
        assert wire.verify() == jwire.verify() != []
        for a, b in zip(wire._packed, jwire._packed):
            assert a.tobytes() == b.tobytes()
    assert not inj.maybe_flip() and not jinj.maybe_flip()
    assert wire.verify_or_restore() == jwire.verify_or_restore() >= 1
    assert wire.restored == jwire.restored
    _same_bytes(wire, jwire)


def test_packed_wire_verifies_flips_and_restores():
    _, _, wire, _ = _wires()
    assert wire.verify() == []
    ref = wire.qparams()
    assert wire.qparams() is ref  # cached while the version stands
    wire.flip_bit(0, 13)
    assert wire.verify() == [0]
    restored = []
    wire.on_restore = restored.append
    fixed = wire.qparams()  # verify-first: decode never sees the flip
    assert restored == [1] and wire.verify() == []
    assert fixed is not ref  # a restore gives new tensors, once
    assert wire.qparams() is fixed
    for a, b in zip(ref["conv"], fixed["conv"]):
        torch.testing.assert_close(a["kernel"], b["kernel"], rtol=0, atol=0)
        torch.testing.assert_close(a["shift"], b["shift"], rtol=0, atol=0)


def test_packed_wire_restores_only_the_flipped_layers():
    """Flips in two of the three layers re-encode those two alone from the
    fp32 master and decode new tensors for them alone: the other keeps its
    tensors (and with them the conv kernel's weight pre-pass), and the
    restored bytes equal the JAX wire's restore."""
    _, _, wire, jwire = _wires()
    ref = wire.qparams()
    encoded, encode = [], wire._encode
    wire._encode = lambda i: (encoded.append(i), encode(i))[1]
    for w in (wire, jwire):
        w.flip_bit(1, 21)
        w.flip_bit(2, 8)
    got = wire.qparams()
    assert sorted(encoded) == [1, 2] and wire.restored == 2
    for i, (a, b) in enumerate(zip(ref["conv"], got["conv"])):
        assert (a is b) == (i == 0), i
        assert torch.equal(a["kernel"], b["kernel"])
        assert torch.equal(a["shift"], b["shift"])
    assert jwire.verify_or_restore() == 2
    _same_bytes(wire, jwire)


def test_packed_wire_params_match_plan_quantize_int5():
    """Materialized wire params are the plan's own int5 quantization, bit
    for bit (so the calibrated requant pairs stay valid through a
    restore), and equal the JAX wire's."""
    plan, params, wire, jwire = _wires()
    qparams, _ = plan.quantize_int5(params)
    got, jgot = wire.qparams(), jwire.qparams()
    assert len(got["conv"]) == len(qparams["conv"]) == len(jgot["conv"])
    for w, q, j in zip(got["conv"], qparams["conv"], jgot["conv"]):
        assert w["kernel"].dtype == torch.int8
        assert w["shift"].dtype == torch.int32
        assert w["kernel"].device.type == "cpu"
        assert not w["kernel"].is_inference()
        np.testing.assert_array_equal(w["kernel"].numpy(),
                                      q["kernel"].numpy())
        np.testing.assert_array_equal(w["shift"].numpy(), q["shift"].numpy())
        np.testing.assert_array_equal(w["kernel"].numpy(),
                                      np.asarray(j["kernel"]))
        np.testing.assert_array_equal(w["shift"].numpy(),
                                      np.asarray(j["shift"]))


def test_wire_is_int5_only_and_lane_names_unique():
    plan, params = _float_plan_params()
    with pytest.raises(ValueError, match="only backs the int5"):
        ServeEngine.build_for_plan(plan, params, buckets=(1,), warm=False,
                                   wire=PackedWire(CFG, params),
                                   device="cpu")
    with pytest.raises(ValueError, match="duplicate lane name"):
        ServeEngine.build_for_plan(
            plan, params, buckets=(1,), warm=False, device="cpu",
            fallbacks=[Lane("float", "float", params, substrate="oracle")])


# ---------------------------------------------------------------------------
# inline chaos on the fake clock: conservation + bit-exactness
# ---------------------------------------------------------------------------


def test_inline_chaos_serves_bit_exact_with_conservation():
    """Transient staging faults, one NaN batch, one latency spike: every
    request still serves, retries are counted, every served result is the
    bit-exact unbatched answer, and within 1e-4 of the JAX server's."""
    plan, params = _float_plan_params()
    spec = "seed=5,stage=2,nonfinite=1,latency=1"
    clk = FakeClock()
    srv = Server.from_plan(plan, params, ServeConfig(
        buckets=(1, 4), faults=FaultPlan.parse(spec)), clock=clk,
        sleep=clk.sleep, device="cpu")
    metrics = srv.run_stream(_stream(n=6))
    srv.close()
    tot = metrics.snapshot()["totals"]
    assert tot["submitted"] == 6 == tot["images"]
    assert tot.get("failed", 0) == 0
    assert tot["retried"] >= 3  # 2 stage faults + the NaN batch redo
    assert (tot["images"] + tot["shed"] + tot["expired"]
            + tot.get("failed", 0)) == tot["submitted"]
    for r, (_, img, _) in zip(metrics.requests, list(_stream(n=6))):
        assert r.status == "served"
        np.testing.assert_array_equal(
            r.result, srv.engine.infer(img[None])[0])
    assert srv.engine.injector.exhausted()
    # the JAX server under the same plan on the same clock
    jplan, jparams = _jax_plan_params()
    jclk = FakeClock()
    jsrv = JaxServer.from_plan(jplan, jparams, JaxServeConfig(
        buckets=(1, 4), faults=j_faults.FaultPlan.parse(spec)), clock=jclk,
        sleep=jclk.sleep)
    jmetrics = jsrv.run_stream(_stream(JaxStream, n=6))
    jsrv.close()
    jtot = jmetrics.snapshot()["totals"]
    for k in ("submitted", "images", "flushes", "retried", "shed",
              "expired"):
        assert tot[k] == jtot[k], k
    assert dict(srv.engine.injector.fired) == dict(jsrv.engine.injector.fired)
    for r, jr in zip(metrics.requests, jmetrics.requests):
        np.testing.assert_allclose(r.result, jr.result, rtol=1e-4, atol=1e-4)


def test_inline_chaos_latency_spike_can_expire_requests():
    plan, params = _float_plan_params()
    clk = FakeClock()
    cfg = ServeConfig(
        buckets=(1,), request_timeout_ms=20.0,
        faults=FaultPlan.parse("seed=2,latency=1,latency-ms=100"))
    srv = Server.from_plan(plan, params, cfg, clock=clk, sleep=clk.sleep,
                           device="cpu")
    metrics = srv.run_stream(_stream(n=4, process="uniform", rate_hz=1e3))
    srv.close()
    tot = metrics.snapshot()["totals"]
    assert (tot["images"] + tot["shed"] + tot["expired"]
            + tot.get("failed", 0)) == tot["submitted"] == 4


# ---------------------------------------------------------------------------
# degradation: breaker trips int5 -> int8, bit-identical to native int8
# ---------------------------------------------------------------------------


def test_degradation_int5_to_int8_is_bit_identical():
    """Persistent executable faults on the primary int5 lane trip the
    breaker; the bucket degrades to the int8 lane and keeps serving, and
    every degraded output equals a native int8 engine's and the JAX
    package's degraded output bit for bit.  A planned bit-flip rides
    along: the trip-time sweep restores the payload from the master."""
    spec, conf = "seed=4,exec=2,bitflip=1", dict(breaker_threshold=2)
    clk = FakeClock()
    srv = _int5_ladder_server(FaultPlan.parse(spec), buckets=(1,),
                              clock=clk, **conf)
    built = dict(execute.EXECUTABLE_COMPILES)  # every lane x bucket, warm
    metrics = srv.run_stream(_stream(n=3, dtype="uint8"))
    srv.close()
    snap = metrics.snapshot()
    tot = snap["totals"]
    assert tot["images"] == 3 == tot["submitted"]
    assert tot.get("failed", 0) == 0
    assert tot["degraded"] == 1
    assert tot["integrity_restored"] >= 1
    assert snap["degraded_lanes"] == {f"{CFG.name} int5 n1": "int8"}
    assert srv.engine.lane_of(1).name == "int8"
    assert all(v == 1 for v in srv.engine.compile_counts.values())
    assert execute.EXECUTABLE_COMPILES == built  # nothing built after warmup
    int8_lane = srv.engine.lanes[1]
    plan, _ = _float_plan_params()
    eng8 = ServeEngine.build_for_plan(
        plan, int8_lane.params, buckets=(1,), datapath="int8",
        requant=int8_lane.requant, device="cpu")
    jclk = FakeClock()
    jsrv = _jax_int5_ladder_server(j_faults.FaultPlan.parse(spec), (1,),
                                   jclk, **conf)
    jmetrics = jsrv.run_stream(_stream(JaxStream, n=3, dtype="uint8"))
    jsrv.close()
    assert jmetrics.snapshot()["totals"]["degraded"] == 1
    for r, jr, (_, img, _) in zip(metrics.requests, jmetrics.requests,
                                  _stream(n=3, dtype="uint8")):
        assert r.status == jr.status == "served"
        assert r.result.dtype == np.int32
        np.testing.assert_array_equal(r.result, eng8.infer(img[None])[0])
        np.testing.assert_array_equal(r.result, np.asarray(jr.result))


def test_flipped_payload_is_restored_before_serving():
    """A bit-flip with no executable faults: the next materialization's
    verify-first sweep restores the payload, and outputs stay bit-exact
    (equal to the JAX package's int5 server's)."""
    clk = FakeClock()
    srv = _int5_ladder_server(FaultPlan.parse("seed=8,bitflip=1"),
                              buckets=(1,), clock=clk)
    ref = [srv.engine.infer(img[None])[0]
           for _, img, _ in _stream(n=3, dtype="uint8")]
    before = srv.engine._wire_params
    metrics = srv.run_stream(_stream(n=3, dtype="uint8"))
    srv.close()
    tot = metrics.snapshot()["totals"]
    assert tot["images"] == 3 and tot.get("failed", 0) == 0
    assert tot["integrity_restored"] >= 1
    assert srv.engine.wire.verify() == []
    assert srv.engine._wire_params is not before  # re-read once, restored
    jclk = FakeClock()
    jsrv = _jax_int5_ladder_server(
        j_faults.FaultPlan.parse("seed=8,bitflip=1"), (1,), jclk)
    jmetrics = jsrv.run_stream(_stream(JaxStream, n=3, dtype="uint8"))
    jsrv.close()
    for r, jr, want in zip(metrics.requests, jmetrics.requests, ref):
        np.testing.assert_array_equal(r.result, want)
        np.testing.assert_array_equal(r.result, np.asarray(jr.result))


# ---------------------------------------------------------------------------
# zero-cost-off: an unarmed server's snapshot carries no resilience keys
# ---------------------------------------------------------------------------


def test_faults_off_snapshot_has_no_resilience_keys():
    plan, params = _float_plan_params()
    clk = FakeClock()
    srv = Server.from_plan(plan, params, ServeConfig(buckets=(1, 4)),
                           clock=clk, sleep=clk.sleep, device="cpu")
    snap = srv.run_stream(_stream(n=6)).snapshot()
    srv.close()
    assert not RESILIENCE_KEYS & set(snap["totals"])
    assert "degraded_lanes" not in snap
    assert srv.engine.injector is None
    assert len(srv.engine.lanes) == 1 and srv.engine.wire is None


def test_armed_but_empty_plan_matches_fault_free_snapshot():
    plan, params = _float_plan_params()

    def run(cfg):
        clk = FakeClock()
        srv = Server.from_plan(plan, params, cfg, clock=clk,
                               sleep=clk.sleep, device="cpu")
        snap = srv.run_stream(_stream(n=6)).snapshot()
        srv.close()
        return snap

    plain = run(ServeConfig(buckets=(1, 4)))
    armed = run(ServeConfig(buckets=(1, 4),
                            faults=FaultPlan.parse("seed=6")))
    assert plain == armed


# ---------------------------------------------------------------------------
# threaded chaos: worker crashes + stage faults under producer threads
# ---------------------------------------------------------------------------


def test_threaded_chaos_conserves_and_serves_bit_exact(deadlock_guard):
    """N producers through an armed fault plane (one worker crash
    mid-batch, transient stage faults) still conserve requests exactly,
    every request terminal once with a unique id, and every served
    result is the bit-exact unbatched answer (and within 1e-4 of the JAX
    package's); the watchdog replaced the crashed worker; the runtime
    sanitizer saw no lock-order cycle or unguarded access; every
    executable was built once."""
    plan, params = _float_plan_params()
    cfg = ServeConfig(buckets=(1, 4), max_delay_ms=2.0,
                      faults=FaultPlan.parse("seed=11,worker=1,stage=2"))
    srv = Server.from_plan(plan, params, cfg, device="cpu")
    registry = sanitize_server(srv)
    built = dict(execute.EXECUTABLE_COMPILES)
    n_threads, per_thread = 4, 8
    results = [[] for _ in range(n_threads)]

    def producer(k):
        imgs = _stream(n=per_thread, seed=k).sample_batch(per_thread)
        for i in range(per_thread):
            results[k].append(srv.submit(imgs[i]))

    threads = [threading.Thread(target=producer, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "producer thread deadlocked"
    srv.drain()
    srv.close()
    reqs = [r for rs in results for r in rs]
    assert len(reqs) == n_threads * per_thread
    assert all(r.done.is_set() for r in reqs)
    statuses = [r.status for r in reqs]
    assert statuses.count("pending") == 0
    tot = srv.metrics.snapshot()["totals"]
    assert tot["submitted"] == len(reqs)
    assert (statuses.count("served") + statuses.count("shed")
            + statuses.count("expired")
            + statuses.count("failed")) == len(reqs)
    assert tot["images"] == statuses.count("served")
    assert tot.get("failed", 0) == statuses.count("failed")
    rids = [r.rid for r in reqs]
    assert len(set(rids)) == len(rids), "duplicate request ids"
    if srv.engine.injector.fired["worker"]:
        assert tot.get("worker_restarts", 0) >= 1
    for r in reqs:
        if r.status == "failed":
            assert r.error and r.result is None
    assert all(v == 1 for v in srv.engine.compile_counts.values())
    assert execute.EXECUTABLE_COMPILES == built
    assert registry.errors == [], registry.errors
    jplan, jparams = _jax_plan_params()
    for k in range(n_threads):
        imgs = _stream(n=per_thread, seed=k).sample_batch(per_thread)
        for i, r in enumerate(results[k]):
            if r.status == "served":
                np.testing.assert_array_equal(
                    r.result, srv.engine.infer(imgs[i:i + 1])[0])
        want = np.asarray(jax_execute.serve_forward(jplan, jparams, imgs))
        got = np.stack([srv.engine.infer(imgs[i:i + 1])[0]
                        for i in range(per_thread)])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the launcher's ladders (serve_cnn.build_server) and --faults
# ---------------------------------------------------------------------------


def _launcher_server(datapath, spec, threshold, buckets=(1, 4)):
    """``serve_cnn.build_server``'s engine (its ladder armed), served by a
    Server on a fake clock under the same config."""
    conf = ServeConfig(buckets=buckets, datapath=datapath,
                       faults=FaultPlan.parse(spec),
                       breaker_threshold=threshold)
    built = serve_cnn.build_server(CFG, ExecutionPolicy(), conf,
                                   device="cpu")
    built.close()
    clk = FakeClock()
    return Server(built.engine, conf, clock=clk, sleep=clk.sleep)


def _lanes_served(srv):
    """Record, per request id, the lane its last dispatch ran on (the
    dispatch that served it, for a served request)."""
    lanes, dispatch = {}, srv._dispatch

    def recorded(bucket, reqs):
        for r in reqs:
            lanes[r.rid] = srv.engine.lane_of(bucket).name
        return dispatch(bucket, reqs)

    srv._dispatch = recorded
    return lanes


@pytest.mark.parametrize("datapath,ladder", [
    ("float", ["float", "float-oracle"]),
    ("int8", ["int8", "int8-f32exact"]),
    ("int5", ["int5", "int8"]),
])
def test_build_server_arms_its_ladder_only_with_faults(datapath, ladder):
    conf = ServeConfig(buckets=(1,), datapath=datapath)
    srv = serve_cnn.build_server(CFG, ExecutionPolicy(), conf, device="cpu")
    assert [ln.name for ln in srv.engine.lanes] == [datapath]
    assert srv.engine.wire is None
    srv.close()
    srv = serve_cnn.build_server(
        CFG, ExecutionPolicy(), ServeConfig(
            buckets=(1,), datapath=datapath,
            faults=FaultPlan.parse("seed=1")), device="cpu")
    assert [ln.name for ln in srv.engine.lanes] == ladder
    assert (srv.engine.wire is not None) == (datapath == "int5")
    assert set(srv.engine.compile_counts.values()) == {1}
    assert len(srv.engine.compile_counts) == len(ladder)
    srv.close()


def test_int8_to_f32exact_ladder_is_bit_identical():
    """Executable faults trip every bucket of the int8 lane onto
    ``int8-f32exact``: the same integer sums, exact in fp32 channel
    chunks, so every served feature map equals a native int8 engine's."""
    srv = _launcher_server("int8", "seed=2,exec=2", 1)
    stream = _stream(n=8, dtype="uint8", burst_sizes=(1, 4, 1),
                     gap_s=0.05)
    metrics = srv.run_stream(stream)
    srv.close()
    tot = metrics.snapshot()["totals"]
    assert tot["images"] == 8 and tot.get("failed", 0) == 0
    assert tot["degraded"] == 2
    assert {srv.engine.lane_of(b).name for b in (1, 4)} == {"int8-f32exact"}
    lane = srv.engine.lanes[0]
    eng8 = ServeEngine.build_for_plan(
        srv.engine.plan, lane.params, buckets=(1,), datapath="int8",
        requant=lane.requant, device="cpu")
    for r in metrics.requests:
        assert r.status == "served" and r.result.dtype == np.int32
        np.testing.assert_array_equal(r.result, eng8.infer(r.payload[None])[0])


def test_float_to_oracle_ladder_serves_the_oracle_engine():
    """One NaN batch at threshold 1 trips its bucket onto ``float-oracle``;
    the retried batch and every later one of that bucket serve the oracle
    engine's logits bit for bit, the rest the kernel lane's, and the two
    lanes agree within 1e-4."""
    srv = _launcher_server("float", "seed=5,nonfinite=1", 1)
    lanes = _lanes_served(srv)
    metrics = srv.run_stream(_stream(n=6))
    srv.close()
    tot = metrics.snapshot()["totals"]
    assert tot["images"] == 6 and tot.get("failed", 0) == 0
    assert tot["degraded"] == 1 and tot["retried"] >= 1
    (key, to), = metrics.snapshot()["degraded_lanes"].items()
    assert to == "float-oracle"
    assert srv.engine.lane_of(int(key.rsplit("n", 1)[1])).name == to
    assert set(lanes.values()) == {"float", "float-oracle"}
    params = srv.engine.lanes[0].params
    oracle = plan_model(CFG, ExecutionPolicy(substrate="oracle"))
    eng = {"float-oracle": ServeEngine.build_for_plan(
        oracle, params, buckets=(1,), device="cpu"),
        "float": ServeEngine.build_for_plan(
        srv.engine.plan, params, buckets=(1,), device="cpu")}
    for r in metrics.requests:
        assert r.status == "served" and np.isfinite(r.result).all()
        want = {k: e.infer(r.payload[None])[0] for k, e in eng.items()}
        np.testing.assert_array_equal(r.result, want[lanes[r.rid]])
        np.testing.assert_allclose(want["float"], want["float-oracle"],
                                   rtol=1e-4, atol=1e-4)


def test_launcher_faults_run_checks_and_stamps(tmp_path):
    """``serve_cnn --int5 --faults ... --device cpu --check``: check OK,
    the payload stamped with the plan, the fault ledger and the lanes,
    and degradation, a worker restart and a restore counted; without
    ``--faults`` no resilience key at all."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    base = [sys.executable, "-m", "repro_torch.launch.serve_cnn", "--arch",
            "vgg16", "--smoke", "--int5", "--device", "cpu", "--buckets",
            "1,4", "--requests", "32", "--producers", "4", "--check"]
    chaos = ["--faults", "seed=3,worker=1,stage=2,bitflip=1,exec=2",
             "--breaker-threshold", "1"]
    out = {}
    for name, extra in (("chaos", chaos), ("plain", [])):
        path = tmp_path / f"{name}.json"
        proc = subprocess.run(base + extra + ["--out", str(path)], env=env,
                              capture_output=True, text=True, timeout=300,
                              cwd=str(REPO))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "check OK" in proc.stdout
        out[name] = json.loads(path.read_text())
    chaos_p, plain_p = out["chaos"], out["plain"]
    assert chaos_p["faults"]["exec_faults"] == 2
    assert chaos_p["lanes"] == ["int5", "int8"]
    assert chaos_p["fault_ledger"]["worker"] == 1
    tot = chaos_p["metrics"]["totals"]
    for k in ("degraded", "worker_restarts", "integrity_restored"):
        assert tot[k] >= 1, (k, tot)
    assert not {"faults", "fault_ledger", "lanes"} & set(plain_p)
    assert not RESILIENCE_KEYS & set(plain_p["metrics"]["totals"])
    assert "degraded_lanes" not in plain_p["metrics"]
