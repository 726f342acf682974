"""Per-layer plan autotuner: search launch schedules, persist the winners.

Port of ``repro/engine/autotune.py``.  Given one conv layer's static
description (the arguments :func:`repro_torch.engine.plan.plan_conv_layer`
takes), it

1. enumerates candidate schedules (:func:`candidate_policies`): the
   default first; on integer layers the substrate switches "f32exact"
   (the exact chunked fp32 lane) and "oracle"; then a one-factor-at-a-time
   sweep of the lane's launch knobs (``kernels.trim_conv2d.Schedule``):
   on the fp32 lane the output tile of ``F32_TILES``, the channel chunk
   and the split; on the u8 x s8 lane the path, the output tile, the
   stages and the split.  Each candidate is checked by the lane's planner,
   and one the kernel cannot take is not a candidate;
2. runs each through the one dispatch site (``execute.run_conv2d``) on
   synthetic operands from a seeded ``torch.Generator`` and times it,
   warmup + median of k: on the card a CUDA graph of the call replayed
   between CUDA events (the device's time, as a served bucket replays
   it), on the CPU the wall clock (:func:`_measure_plan`);
3. keeps only candidates whose output is bit-identical to the default
   plan's (``allow_inexact=False``): integer paths and splits pass (int32
   sums are exact in any order), fp32 changes that reorder the channel sum
   do not;
4. ships the fastest only if a paired re-measure (:func:`aggregate_pair`)
   shows it beating the default by more than :data:`MIN_GAIN`, so a tuned
   plan is never slower than the default it replaces;
5. persists the winner in a JSON cache file per (device type, device
   kind), stamped with :data:`PLAN_CACHE_VERSION`, under ``tuned_plans/``
   (or ``REPRO_TUNED_PLANS_DIR``).  The port's files are named
   ``torch-<type>-<kind>.json``: never a name the JAX package writes.

``plan_conv_layer`` asks :func:`tuned_schedule` under
``policy.tuning`` "cached" (a miss plans from the policy) or "auto" (a
miss tunes, then persists).  Tuning measures on ``policy.tune_device``.
"""
from __future__ import annotations

import functools
import json
import os
import re
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine import execute
from repro_torch.engine.plan import DATAPATHS, plan_conv_layer, plan_model
from repro_torch.engine.policy import (SUBSTRATES, ExecutionPolicy,
                                       resolve_device)
from repro_torch.kernels.trim_conv2d import (F32_MAX_CB, F32_TILES, U8_M,
                                             U8_PATH_NAMES, U8_SLIDE,
                                             U8_STAGES, bf16_tile, f32_tile,
                                             u8_tile)

#: Bump when plan semantics change: cache files of another version are
#: ignored with a warning, so stale winners never misconfigure a kernel.
#: The JAX package's is 3 (batch axis ``n{N}``, weight-width axis
#: ``w{bits}``); the port's keys are the same and its schedules its own.
PLAN_CACHE_VERSION = 3

#: The policy fields a persisted schedule sets (None: the planner's
#: choice).  JAX's are ("substrate", "tile_h", "tile_w", "block_c",
#: "block_f"); the port's launch has no ``block_f`` (its filter tile is
#: compiled in) and adds the split, the u8 stages and the u8 path.
SCHEDULE_FIELDS = ("substrate", "tile_h", "tile_w", "block_c", "n_split",
                   "stages", "path")

#: A non-default candidate must beat the default by this fraction to ship.
MIN_GAIN = 0.05

#: The fp32 lane's channel chunks and the u8 lane's tile widths searched.
BLOCK_C_CANDIDATES = (1, 2, 4, F32_MAX_CB)
U8_TW_CANDIDATES = (8, 16, 32)


# ---------------------------------------------------------------------------
# Cache keys and the JSON plan cache
# ---------------------------------------------------------------------------


def cache_dir() -> str:
    """Plan-cache directory (``REPRO_TUNED_PLANS_DIR``, default
    ``tuned_plans/`` under the current working directory)."""
    return os.environ.get("REPRO_TUNED_PLANS_DIR", "tuned_plans")


def device_kind(device) -> str:
    """The hardware class whose measurements a cache file holds: the
    card's name, or "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def cache_path(device) -> str:
    """One cache file per (device type, device kind), prefixed ``torch-``
    so that no port run can touch the JAX package's files (its are
    ``<backend>-<kind>.json``)."""
    dev = resolve_device(device)
    slug = re.sub(r"[^A-Za-z0-9_.-]+", "-", device_kind(dev))
    return os.path.join(cache_dir(), f"torch-{dev.type}-{slug}.json")


def layer_key(
    x_hw: Tuple[int, int],
    c_in: int,
    k: int,
    c_out: int,
    *,
    stride: int,
    padding: Optional[int],
    groups: int,
    relu: bool,
    has_bias: bool,
    requant_kind: Optional[str],
    in_sz: int,
    w_sz: int,
    out_sz: int,
    emulate_hw: bool,
    batch: int = 1,
    w_bits: int = 8,
) -> str:
    """The layer's plan-cache key, the JAX package's string for the same
    layer: geometry, dtype byte sizes, epilogue, emulate_hw, the batch the
    schedule was measured at (``n{N}``) and the stored weight width
    (``w{bits}``).  Device and code version live at the file level."""
    pad = "same" if padding is None else str(padding)
    epi = f"{int(relu)}{int(has_bias)}.{requant_kind or 'none'}"
    return (
        f"conv2d n{batch} h{x_hw[0]}x{x_hw[1]} c{c_in} k{k} f{c_out} "
        f"s{stride} p{pad} g{groups} ep{epi} "
        f"sz{in_sz}.{w_sz}.{out_sz} emu{int(emulate_hw)} w{w_bits}"
    )


#: In-process mirror of the cache files: path -> {key -> entry}.
_LOADED: Dict[str, Dict[str, dict]] = {}


def reset_cache() -> None:
    """Forget the in-process cache state and the plan caches (cached
    plans bake tuned schedules in)."""
    _LOADED.clear()
    plan_conv_layer.cache_clear()
    plan_model.cache_clear()


def _load_plans(path: str) -> Dict[str, dict]:
    if path in _LOADED:
        return _LOADED[path]
    plans: Dict[str, dict] = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
            version = data.get("version") if isinstance(data, dict) else None
            if version != PLAN_CACHE_VERSION:
                raise ValueError(
                    f"cache version {version!r} != {PLAN_CACHE_VERSION}")
            plans = data.get("plans")
            if not isinstance(plans, dict):
                raise ValueError("'plans' is not a mapping")
        except (OSError, ValueError) as e:  # corrupt/stale: degrade
            warnings.warn(
                f"tuned-plan cache {path} is unreadable ({e}); "
                "falling back to default plans", RuntimeWarning,
                stacklevel=3)
            plans = {}
    _LOADED[path] = plans
    return plans


def _valid_schedule(sched: object) -> bool:
    if not isinstance(sched, dict) or set(sched) != set(SCHEDULE_FIELDS):
        return False
    if sched["substrate"] not in SUBSTRATES:
        return False
    for name in ("tile_h", "tile_w", "block_c", "n_split", "stages"):
        v = sched[name]
        if v is not None and (not isinstance(v, int) or v < 1):
            return False
    if (sched["tile_h"] is None) != (sched["tile_w"] is None):
        return False
    return sched["path"] is None or sched["path"] in U8_PATH_NAMES


def load_schedule(key: str, device) -> Optional[Dict[str, object]]:
    """The persisted winner for ``key`` on ``device``'s kind, or None on a
    miss (an invalid entry warns and is a miss)."""
    entry = _load_plans(cache_path(device)).get(key)
    if entry is None:
        return None
    sched = entry.get("schedule") if isinstance(entry, dict) else None
    if not _valid_schedule(sched):
        warnings.warn(
            f"tuned-plan cache entry for {key!r} is invalid; falling back "
            "to the default plan", RuntimeWarning, stacklevel=3)
        return None
    return dict(sched)


def store_schedule(key: str, entry: Dict[str, object], device) -> None:
    """Persist one tuning result (atomic write) and refresh the in-process
    mirror and the plan caches, so the winner is seen at once."""
    path = cache_path(device)
    plans = dict(_load_plans(path))
    plans[key] = entry
    payload = {
        "version": PLAN_CACHE_VERSION,
        "backend": f"torch-{resolve_device(device).type}",
        "device_kind": device_kind(device),
        "plans": plans,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    _LOADED[path] = plans
    plan_conv_layer.cache_clear()
    plan_model.cache_clear()


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------


def _knob_moves(x_hw, c_in, k, c_out, *, stride, padding, groups, in_sz,
                batch, decimate) -> List[Dict[str, object]]:
    """One-factor-at-a-time overrides of the lane's planner at ``batch``,
    each one the lane's planner takes and each different from its own
    choice: the fp32 lane's (``in_sz`` 4) tile, chunk and split; the u8 x
    s8 (1) and bf16 (2) lanes' path, tile, split and stages (the bf16
    lane's planner refuses the slide path and ignores the batch)."""
    cg, fg = c_in // groups, c_out // groups
    shape = ((tuple(x_hw), cg, k, fg),
             dict(stride=1 if decimate else stride, padding=padding))
    moves: List[Dict[str, object]] = []

    def legal(plan_fn, **kw) -> bool:
        try:
            plan_fn(*shape[0], **shape[1], **kw)
        except ValueError:
            return False
        return True

    if in_sz not in (1, 2):
        t = f32_tile(*shape[0], **shape[1])
        moves += [{"tile_h": th, "tile_w": tw} for th, tw in F32_TILES
                  if (th, tw) != (t.TH, t.TW)
                  and legal(f32_tile, tile=(th, tw))]
        moves += [{"block_c": cb} for cb in BLOCK_C_CANDIDATES
                  if cb != t.Cb and cb <= cg and legal(f32_tile, block_c=cb)]
        splits = {1, max(1, t.n_split // 2), t.n_split * 2}
        moves += [{"n_split": n} for n in sorted(splits)
                  if n != t.n_split and legal(f32_tile, n_split=n)]
        return moves
    plan_fn = (functools.partial(u8_tile, batch=batch) if in_sz == 1
               else bf16_tile)
    t = plan_fn(*shape[0], **shape[1])
    name = U8_PATH_NAMES[t.path]
    for p, pname in enumerate(U8_PATH_NAMES):
        # the gather path only where it is built for: C <= 8
        if p != t.path and (pname != "gather" or cg <= 8) and legal(
                plan_fn, path=p):
            moves.append({"path": pname})
    if t.path != U8_SLIDE:
        for tw in U8_TW_CANDIDATES:
            th = max(1, min(U8_M // tw, t.H_O))
            if (th, tw) != (t.TH, t.TW) and legal(
                    plan_fn, path=t.path, tile=(th, tw)):
                moves.append({"path": name, "tile_h": th, "tile_w": tw})
        splits = {1, max(1, t.n_split // 2), t.n_split * 2}
        moves += [{"path": name, "n_split": n} for n in sorted(splits)
                  if n != t.n_split and legal(plan_fn, path=t.path,
                                              n_split=n)]
    moves += [{"path": name, "stages": st} for st in U8_STAGES
              if st != t.stages and legal(plan_fn, path=t.path, stages=st)]
    return moves


def candidate_policies(
    x_hw: Tuple[int, int],
    c_in: int,
    k: int,
    c_out: int,
    *,
    stride: int = 1,
    padding: Optional[int] = None,
    groups: int = 1,
    in_sz: int = 4,
    w_sz: int = 4,
    out_sz: int = 4,
    policy: ExecutionPolicy = ExecutionPolicy(),
    batch: int = 1,
    include_kernel: Optional[bool] = None,
) -> List[ExecutionPolicy]:
    """Candidate policies for one layer, the default first.

    Substrate moves: integer layers (``in_sz == 1``) add "f32exact" and
    "oracle".  The kernel's launch knobs get a one-factor-at-a-time sweep
    (:func:`_knob_moves`) where the default runs the kernel: on the card
    (``include_kernel`` None: ``policy.tune_device`` is a card) or where a
    test asks for it.  On the CPU every knob runs the same plain version.
    """
    base = policy.with_overrides(tuning="off")
    cands = [base]
    if in_sz == 1:
        for sub in ("f32exact", "oracle"):
            if sub != base.substrate:
                cands.append(base.with_overrides(substrate=sub))
    if include_kernel is None:
        include_kernel = torch.device(policy.tune_device).type == "cuda"
    if include_kernel and base.substrate in ("auto", "kernel"):
        for move in _knob_moves(
                x_hw, c_in, k, c_out, stride=stride, padding=padding,
                groups=groups, in_sz=in_sz, batch=batch,
                decimate=base.emulate_hw and stride > 1):
            cands.append(base.with_overrides(**move))
    return list(dict.fromkeys(cands))


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def _operands(plan, in_sz: int, batch: int, device):
    """Synthetic operands for ``plan`` from a seeded generator (uint8 x /
    int8 w with representative requant pairs on the integer lane, bf16
    x, w and bias where ``in_sz`` is 2, fp32 otherwise, as the JAX
    package's ``_measure_plan`` builds them): (x, w, bias, requant,
    requant_shift)."""
    gen = torch.Generator().manual_seed(0)
    x_shape = (int(batch), plan.x_hw[0], plan.x_hw[1], plan.c_in)
    w_shape = (plan.k, plan.k, plan.c_in // plan.groups, plan.c_out)
    F = plan.c_out
    requant = requant_shift = bias = None
    if in_sz == 1:
        wmax = (1 << plan.w_bits) - 1 if plan.w_bits < 8 else 127
        x = torch.randint(0, 255, x_shape, generator=gen, dtype=torch.uint8)
        w = torch.randint(-wmax, wmax, w_shape, generator=gen,
                          dtype=torch.int8)
        if plan.requant_kind == "mult_shift":
            requant = (torch.full((F,), 16384, dtype=torch.int32,
                                  device=device),
                       torch.full((F,), 20, dtype=torch.int32,
                                  device=device))
        elif plan.requant_kind == "shift":
            requant_shift = 8
        if plan.has_bias:
            bias = torch.zeros((F,), dtype=torch.int32, device=device)
    else:
        dt = torch.bfloat16 if in_sz == 2 else torch.float32
        x = torch.randn(x_shape, generator=gen).to(dt)
        w = torch.randn(w_shape, generator=gen).to(dt)
        if plan.has_bias:
            bias = torch.randn((F,), generator=gen).to(device, dt)
    return x.to(device), w.to(device), bias, requant, requant_shift


#: The layer being measured: its key, its operands (kept, as a served
#: layer's weights are: the u8 lane's transposed weights are written once)
#: and, on the card, each plan's captured graph.
_LAYER: Dict[str, object] = {"key": None}


def _measure_plan(
    plan,
    *,
    in_sz: int,
    warmup: int = 1,
    reps: int = 5,
    batch: int = 1,
    device="cuda",
) -> Tuple[float, np.ndarray]:
    """Run ``plan`` through ``execute.run_conv2d`` and time it.

    Returns (median microseconds over ``reps`` timed calls after
    ``warmup`` more, the output as numpy for the identity gate).  On the
    card the call is captured once per plan into a CUDA graph (as the
    serving executables are) and each replay is timed by CUDA events: the
    device's time, not the host's time to issue the call, which at batch
    1 is the larger and would reward fewer launches over faster ones.  On
    the CPU each call is timed by the wall clock.
    """
    dev = resolve_device(device)
    key = (plan.x_hw, plan.c_in, plan.k, plan.c_out, plan.groups,
           plan.has_bias, plan.requant_kind, plan.w_bits, in_sz, int(batch),
           str(dev))
    if _LAYER["key"] != key:
        _LAYER.clear()         # one layer's operands and graphs at a time
        _LAYER.update(key=key, operands=_operands(plan, in_sz, batch, dev),
                      graphs={})
    x, w, bias, requant, requant_shift = _LAYER["operands"]

    def call():
        return execute.run_conv2d(plan, x, w, bias, requant,
                                  requant_shift=requant_shift)

    with torch.no_grad():
        if dev.type == "cuda":
            from repro_torch.engine import graphs

            g = _LAYER["graphs"].get(plan)
            if g is None:
                g = graphs.capture(call, graphs.GraphPool(dev),
                                   label=f"autotune {key}")
                _LAYER["graphs"][plan] = g
            g.graph.replay()
            out = g.output.cpu().numpy()
            for _ in range(max(warmup, 0)):
                g.graph.replay()
            times = []
            for _ in range(max(reps, 1)):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                g.graph.replay()
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1) * 1e3)
        else:
            out = call().numpy()
            for _ in range(max(warmup, 0)):
                call()
            times = []
            for _ in range(max(reps, 1)):
                t0 = time.perf_counter()
                call()
                times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times)), out


def aggregate_pair(ta, tb):
    """The drift-robust A/B statistic: each round's ``tb / ta`` from two
    adjacent calls, the median of those ratios as the decision, and each
    arm's minimum as its least-contended time.  Returns (t_a, t_b,
    ratio_b_over_a)."""
    ratio = float(np.median([b / a for a, b in zip(ta, tb)]))
    return float(np.min(ta)), float(np.min(tb)), ratio


def _measure_pair(plan_a, plan_b, *, in_sz: int, reps: int = 5,
                  batch: int = 1, device="cuda"):
    """Alternate single-rep measurements of two plans, aggregated by
    :func:`aggregate_pair`: (us_a, us_b, ratio_b_over_a)."""
    kw = dict(in_sz=in_sz, warmup=0, reps=1, batch=batch, device=device)
    _measure_plan(plan_a, **kw)
    _measure_plan(plan_b, **kw)
    ta, tb = [], []
    for _ in range(max(reps, 1)):
        ta.append(_measure_plan(plan_a, **kw)[0])
        tb.append(_measure_plan(plan_b, **kw)[0])
    return aggregate_pair(ta, tb)


# ---------------------------------------------------------------------------
# Tuning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CandidateTiming:
    schedule: Dict[str, object]
    us: float
    exact: bool


@dataclass(frozen=True)
class TuneResult:
    """One layer's tuning outcome (also what is persisted)."""

    key: str
    schedule: Dict[str, object]
    us: float
    us_default: float
    candidates: Tuple[CandidateTiming, ...]
    cached: bool = False

    @property
    def speedup(self) -> float:
        """Default over tuned time (>= 1: the winner is never slower)."""
        return self.us_default / self.us if self.us else float("inf")


def _schedule_of_plan(plan) -> Dict[str, object]:
    """The persistable schedule a plan encodes: its substrate and its
    launch overrides (None: the planner's choice)."""
    s = plan.schedule
    return {
        "substrate": plan.substrate,
        "tile_h": None if s.tile is None else s.tile[0],
        "tile_w": None if s.tile is None else s.tile[1],
        "block_c": s.block_c,
        "n_split": s.n_split,
        "stages": s.stages,
        "path": s.path,
    }


def _key(x_hw, c_in, k, c_out, policy, batch, kw) -> str:
    return layer_key(x_hw, c_in, k, c_out, emulate_hw=policy.emulate_hw,
                     batch=batch, **kw)


def tune_conv_layer(
    x_hw: Tuple[int, int],
    c_in: int,
    k: int,
    c_out: int,
    *,
    stride: int = 1,
    padding: Optional[int] = None,
    groups: int = 1,
    relu: bool = False,
    has_bias: bool = False,
    requant_kind: Optional[str] = None,
    in_sz: int = 4,
    w_sz: int = 4,
    out_sz: int = 4,
    w_bits: int = 8,
    policy: ExecutionPolicy = ExecutionPolicy(),
    batch: int = 1,
    warmup: int = 1,
    reps: int = 5,
    allow_inexact: bool = False,
    persist: bool = True,
    force: bool = False,
    include_kernel: Optional[bool] = None,
) -> TuneResult:
    """Tune one conv layer on ``policy.tune_device``: measure the
    candidates, pick the winner and persist it.

    Unless ``force``, a persisted winner for the key is returned as it is
    (``cached=True``, nothing measured).  ``batch`` is part of the key and
    sizes the operands.  Candidates whose output is not bit-identical to
    the default plan's are dropped (``allow_inexact``: an fp32 ``allclose``
    gate instead); a candidate that raises (the kernel refuses it) is
    dropped with a warning.  The fastest survivor ships only if a paired
    re-measure shows it more than :data:`MIN_GAIN` faster; else the
    default ships.
    """
    kw = dict(stride=stride, padding=padding, groups=groups, relu=relu,
              has_bias=has_bias, requant_kind=requant_kind, in_sz=in_sz,
              w_sz=w_sz, out_sz=out_sz, w_bits=w_bits)
    key = _key(x_hw, c_in, k, c_out, policy, batch, kw)
    dev = policy.tune_device
    if not force:
        sched = load_schedule(key, dev)
        if sched is not None:
            entry = _load_plans(cache_path(dev))[key]
            return TuneResult(key=key, schedule=sched,
                              us=float(entry.get("us", 0.0)),
                              us_default=float(entry.get("us_default", 0.0)),
                              candidates=(), cached=True)
    base = policy.with_overrides(tuning="off")

    def build(pol):
        return plan_conv_layer(tuple(x_hw), c_in, k, c_out, policy=pol,
                               batch=batch, **kw)

    policies = candidate_policies(
        x_hw, c_in, k, c_out, stride=stride, padding=padding, groups=groups,
        in_sz=in_sz, w_sz=w_sz, out_sz=out_sz, policy=base, batch=batch,
        include_kernel=include_kernel)
    plans = list(dict.fromkeys(build(p) for p in policies))
    default_plan = plans[0]
    mkw = dict(in_sz=in_sz, batch=batch, device=dev)
    us_default, ref_out = _measure_plan(default_plan, warmup=warmup,
                                        reps=reps, **mkw)
    timings = [CandidateTiming(_schedule_of_plan(default_plan), us_default,
                               True)]
    best_plan, best_us = default_plan, us_default
    for plan in plans[1:]:
        try:
            us, out = _measure_plan(plan, warmup=warmup, reps=reps, **mkw)
        except (RuntimeError, ValueError) as e:
            warnings.warn(
                f"autotune candidate {_schedule_of_plan(plan)} failed to "
                f"run ({e}); discarded", RuntimeWarning, stacklevel=2)
            continue
        if out.dtype == ref_out.dtype and np.array_equal(out, ref_out):
            exact = True
        elif allow_inexact and np.allclose(
                out.astype(np.float64), ref_out.astype(np.float64),
                rtol=1e-4, atol=1e-4):
            exact = False
        else:
            continue  # changes the math: never a legal schedule move
        timings.append(CandidateTiming(_schedule_of_plan(plan), us, exact))
        if us < best_us:
            best_plan, best_us = plan, us
    ratio = None
    if best_plan is not default_plan:
        # the never-slower rule against a paired ratio, not two timings
        # taken apart on a drifting machine
        try:
            us_d2, us_b2, ratio = _measure_pair(default_plan, best_plan,
                                                reps=reps, **mkw)
        except (RuntimeError, ValueError):
            ratio = float("inf")
        if ratio > 1 - MIN_GAIN:
            best_plan, best_us = default_plan, us_default
        else:
            best_us, us_default = us_b2, us_d2
    schedule = _schedule_of_plan(best_plan)
    result = TuneResult(key=key, schedule=schedule, us=best_us,
                        us_default=us_default, candidates=tuple(timings))
    if persist:
        store_schedule(key, {
            "schedule": schedule,
            "us": round(best_us, 1),
            "us_default": round(us_default, 1),
            "speedup": round(result.speedup, 3),
            # the paired re-measure's median ratio (None: not taken)
            "ratio": (round(ratio, 3) if ratio is not None
                      and np.isfinite(ratio) else None),
            "candidates": len(plans),
            "reps": reps,
        }, dev)
    return result


def tuned_schedule(
    x_hw: Tuple[int, int],
    c_in: int,
    k: int,
    c_out: int,
    *,
    stride: int,
    padding: Optional[int],
    groups: int,
    relu: bool,
    has_bias: bool,
    requant_kind: Optional[str],
    in_sz: int,
    w_sz: int,
    out_sz: int,
    w_bits: int = 8,
    policy: ExecutionPolicy,
    batch: int = 1,
) -> Optional[Dict[str, object]]:
    """The schedule ``plan_conv_layer`` applies under ``policy.tuning``:
    "cached", the persisted winner or None; "auto", the persisted winner,
    tuned and persisted on a miss.  ``batch`` selects the batch's
    winner."""
    kw = dict(stride=stride, padding=padding, groups=groups, relu=relu,
              has_bias=has_bias, requant_kind=requant_kind, in_sz=in_sz,
              w_sz=w_sz, out_sz=out_sz, w_bits=w_bits)
    sched = load_schedule(_key(x_hw, c_in, k, c_out, policy, batch, kw),
                          policy.tune_device)
    if sched is None and policy.tuning == "auto":
        sched = tune_conv_layer(x_hw, c_in, k, c_out, policy=policy,
                                batch=batch, **kw).schedule
    return sched


def tune_model(
    cfg,
    policy: ExecutionPolicy = ExecutionPolicy(),
    c_in: Optional[int] = None,
    datapath: str = "float",
    **tune_kw,
) -> List[Tuple[str, TuneResult]]:
    """Tune every conv layer of a ``CNNConfig`` (the ``plan_model`` walk):
    ``[(layer label, TuneResult), ...]``; ``tune_kw`` goes to
    :func:`tune_conv_layer` (``batch``, ``reps``, ``force``, ...)."""
    if datapath not in DATAPATHS:
        raise ValueError(f"datapath {datapath!r} not in {DATAPATHS}")
    int8 = datapath in ("int8", "int5")
    results = []
    c = cfg.layers[0].M if c_in is None else int(c_in)
    last_i = len(cfg.layers) - 1
    for i, l in enumerate(cfg.layers):
        res = tune_conv_layer(
            (l.H_I, l.W_I), c, l.K, l.N, stride=l.stride,
            padding=l.padding, groups=c // l.M, relu=True,
            has_bias=not int8,
            requant_kind="mult_shift" if int8 and i != last_i else None,
            in_sz=1 if int8 else 4, w_sz=1 if int8 else 4,
            out_sz=(4 if i == last_i else 1) if int8 else 4,
            w_bits=5 if datapath == "int5" else 8, policy=policy,
            **tune_kw)
        results.append((f"{cfg.name}/{l.name}.{datapath}", res))
        c = l.N
    return results
