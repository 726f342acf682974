"""Production-mesh dry-run: build every (architecture x input shape x mesh)
cell on a fake world of the production size, run its step once on fake
tensors, and record what the roofline reads: per-device memory, flops,
bytes and collective bytes (port of ``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun             # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k --multi-pod                               # one cell
  ... --out experiments/dryrun_torch                             # records

How, where the JAX module lowers and compiles:

- :func:`scaled_mesh` starts a one-process fake world of the mesh's size
  (``torch.testing._internal.distributed.fake_pg``'s ``FakeStore``,
  ``init_process_group("fake", rank=0, world_size=N)``: collectives are
  accepted and do nothing) and a ``DeviceMesh`` with the JAX module's
  axis names and shapes, (16, 16) or (2, 16, 16), scaled down as the JAX
  module scales it where ``REPRO_DRYRUN_DEVICES`` is set.
- :func:`build_cell` places the state, batch and cache as DTensors whose
  local shards are fake tensors of rank 0's shard shapes, under the JAX
  module's specs (``state_pspec``, ``param_pspec`` / ``fsdp_pspec``,
  ``batch_pspec``, ``cache_pspec``; the "2d" decode layout's batch rule).
  Nothing is allocated: arctic-480b's train state is built in one CPU
  process.
- The step (``make_train_step`` on the mesh, the prefill or the decode
  step) runs once under ``FakeTensorMode`` inside
  :class:`~repro_torch.launch.hlo_stats.StepRecorder`, which counts the
  collectives it issues and the flops and bytes of its local operators.
  On fake CPU tensors the kernels' plain versions run, so the attention
  counted is the full S x S, as the JAX module's XLA count is (record
  key ``counted_on``).  This is a dry-run, not a fallback: the card runs
  the kernels (``chip_smoke.py``).

The roofline uses the card's figures (``launch/mesh.py``): bf16 peak,
HBM bandwidth, 80 GiB per card, and NVLink's bandwidth where the JAX
module has ICI's.  Its seconds are MODEL figures, not measurements.

The JAX module's ``--save-hlo`` has no meaning here (there is no HLO) and
is not taken.  Every failure here (a placement DTensor refuses, a shape
that does not divide) is a bug in the port, not in the dry-run.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time
import traceback
from contextlib import nullcontext
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, shape_cells
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed.sharding import (activate_mesh, fsdp_pspec,
                                              mesh_shape, param_pspec,
                                              to_placements)
from repro_torch.distributed.steps import (StepConfig, batch_pspec,
                                           cache_pspec, make_decode_step,
                                           make_prefill_step,
                                           make_train_step, state_pspec,
                                           train_state_shapes)
from repro_torch.launch.hlo_stats import (StepRecorder, collective_stats,
                                          cost_dict, hbm_bytes_estimate,
                                          total_collective_bytes)
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.launch.specs import input_specs, model_flops
from repro_torch.nn.blocks import REMAT_MODES
from repro_torch.nn.models import build_model, decoder_schedule

#: what the step ran on in the dry-run
COUNTED_ON = "plain versions, fake tensors"
#: cards one NVLink domain joins (an HGX H100 board)
NVLINK_DOMAIN = 8


def _fake_world(n: int) -> None:
    """A one-process fake process group of world size ``n`` (rank 0),
    replacing one of another size.  A new world's meshes equal an earlier
    world's by value, so DTensor's sharding-propagation caches (Python's
    and the dispatch fast path's) are cleared: they would hand back
    output specs on the earlier meshes, whose process groups are gone."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
        .cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)          # the dispatch fast path's (newer torch)
    if native is not None:
        native()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh_dims(multi_pod: bool):
    """The production mesh's shape and axis names, or a proportionally
    scaled one where ``REPRO_DRYRUN_DEVICES`` overrides the device count
    (512 by default), as ``repro/launch/dryrun.py:49-67`` scales it."""
    n = int(os.environ.get("REPRO_DRYRUN_DEVICES") or 512)
    if n >= 512:
        if multi_pod:
            return (2, 16, 16), ("pod", "data", "model")
        return (16, 16), ("data", "model")
    if multi_pod:
        pod = 2
        rest = n // pod
        side = int(math.sqrt(rest))
        while rest % side:
            side -= 1
        return (pod, rest // side, side), ("pod", "data", "model")
    side = int(math.sqrt(n))
    while n % side:
        side -= 1
    return (n // side, side), ("data", "model")


def scaled_mesh(multi_pod: bool):
    """The production mesh as a ``DeviceMesh`` over a fake world of its
    size (rank 0 in this process), or a scaled one (see
    :func:`_mesh_dims`)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = _mesh_dims(multi_pod)
    _fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def _local_shape(shape, placements, mesh) -> tuple:
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def fake_place(tree, specs, mesh):
    """Each tensor leaf of ``tree`` (``meta`` tensors) as a DTensor on
    ``mesh`` placed by its spec in ``specs``, its local shard a fake
    tensor of rank 0's shard shape (under the active ``FakeTensorMode``).
    Specs cut only dims their axes divide, so every shard is even."""
    from torch.distributed.tensor import DTensor

    def leaf(t, spec):
        pl = to_placements(spec, mesh)
        local = torch.empty(_local_shape(t.shape, pl, mesh), dtype=t.dtype,
                            device="cpu")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def walk(node, spec):
        if isinstance(node, torch.Tensor):
            return leaf(node, spec)
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        kids = [walk(v, spec[i]) for i, v in enumerate(node)]
        return type(node)(*kids) if hasattr(node, "_fields") \
            else type(node)(kids)
    return walk(tree, specs)


def _real(fn, *args):
    """``fn(*args)`` outside the fake mode: the train step's construction
    makes its process groups from the mesh's rank tensor."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return fn(*args)


class Cell:
    """A built cell: ``run()`` runs its step once; ``arguments`` are the
    leaves live before it (state, batch, cache)."""

    def __init__(self, fn, args, mesh, no_grad: bool, extra_rules=None):
        self.fn, self.args, self.mesh = fn, args, mesh
        self.no_grad, self.extra_rules = no_grad, extra_rules

    @property
    def arguments(self) -> List[torch.Tensor]:
        return [t for t in tree_leaves(self.args)
                if isinstance(t, torch.Tensor)]

    def run(self):
        grad = torch.no_grad() if self.no_grad else nullcontext()
        with activate_mesh(self.mesh, extra_rules=self.extra_rules), grad:
            return self.fn(*self.args)


def build_cell(cfg: ModelConfig, cell: ShapeCell, mesh, fsdp: bool = False,
               accum: int = 1) -> Cell:
    """The cell's step and its placed fake arguments (call under the
    ``FakeTensorMode`` the step will run in)."""
    tp = mesh_shape(mesh)["model"]
    model = build_model(cfg, tp=tp)
    # "2d" serve layout: batch replicated over data (only pod, if present);
    # the data axis carries the weight 2D shard + the KV sequence shard.
    serve_2d = (cell.kind == "decode"
                and getattr(cfg, "decode_kv_seqshard", "") == "2d")
    extra_rules = {"batch": (("pod",),)} if serve_2d else None
    with activate_mesh(mesh, extra_rules=extra_rules) as ctx:
        if cell.kind == "train":
            batch = input_specs(cfg, model, cell)
            shapes = train_state_shapes(model)
            state = fake_place(shapes, state_pspec(shapes, ctx, fsdp=fsdp),
                               mesh)
            b = fake_place(batch, batch_pspec(batch, ctx), mesh)
            fn = _real(make_train_step, model, StepConfig(accum=accum),
                       mesh)
            return Cell(fn, (state, b), mesh, no_grad=False)
        pshapes = model.init(0, "meta")
        if cell.kind == "decode" and serve_2d and fsdp:
            # 2D weight sharding: TP dim over model, other dim over data
            # (pod stays free for batch) -> partial-sum matmuls
            pspec = fsdp_pspec(pshapes, ctx, dp_axes=("data",))
        else:
            pspec = (fsdp_pspec if fsdp else param_pspec)(pshapes, ctx)
        params = fake_place(pshapes, pspec, mesh)
        batch, cache = input_specs(cfg, model, cell)
        cache = fake_place(cache, cache_pspec(cache, ctx), mesh)
        if cell.kind == "prefill":
            b = fake_place(batch, batch_pspec(batch, ctx), mesh)
            return Cell(make_prefill_step(model), (params, b, cache), mesh,
                        no_grad=True, extra_rules=extra_rules)
        if cell.kind != "decode":
            raise ValueError(cell.kind)
        tok = fake_place({"t": batch["token"]},
                         batch_pspec({"t": batch["token"]}, ctx), mesh)["t"]
        # the position: a 0-d int32 on every rank, as the JAX cell's
        pos = torch.empty((), dtype=batch["pos"].dtype, device="cpu")
        return Cell(make_decode_step(model), (params, tok, cache, pos), mesh,
                    no_grad=True, extra_rules=extra_rules)


def run_recorded(cfg: ModelConfig, cell: ShapeCell, mesh, fsdp: bool = False,
                 accum: int = 1):
    """(the recorder after one run of the cell's step, the cell's
    memory estimate, seconds to build, seconds to run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        c = build_cell(cfg, cell, mesh, fsdp=fsdp, accum=accum)
        t_build = time.time() - t0
        rec = StepRecorder(c.arguments)
        with rec:
            out = c.run()
            del out
        mem = hbm_bytes_estimate(c.arguments, rec)
    return rec, mem, t_build, time.time() - t0 - t_build


def _cell_costs(cfg: ModelConfig, cell: ShapeCell, mesh,
                fsdp: bool = False, raw: Optional[dict] = None,
                accum: int = 1) -> Dict[str, float]:
    """flops / bytes / collective_bytes of one variant, per device; with
    ``raw`` (a dict), its memory estimate, cost, collectives and times are
    put there too."""
    rec, mem, t_build, t_run = run_recorded(cfg, cell, mesh, fsdp=fsdp,
                                            accum=accum)
    cost = cost_dict(rec)
    out = {"flops": cost["flops"], "bytes": cost["bytes accessed"],
           "collective_bytes": total_collective_bytes(rec.collectives)}
    stats = collective_stats(rec.collectives)
    for op, s in stats.items():
        out[f"coll_{op}"] = s["bytes"]
    if raw is not None:
        raw.update(memory=mem, cost=cost, collectives=stats,
                   lower_s=t_build, compile_s=t_run, marked=rec.marked)
    return out


def _extrapolate(variants, n_periods, n_enc: int = 0) -> Dict[str, float]:
    """const + n * per from the variants' counts: [(n, count dict)] for
    two depths, or [(n_dec, n_enc, count dict)] for (2, 2), (4, 2), (2, 4)
    (encdec)."""
    keys = sorted(set().union(*[v[-1].keys() for v in variants]))
    out = {}
    if len(variants) == 3:
        (_, _, c22), (_, _, c42), (_, _, c24) = variants
        for k in keys:
            per_dec = (c42.get(k, 0) - c22.get(k, 0)) / 2
            per_enc = (c24.get(k, 0) - c22.get(k, 0)) / 2
            const = c22.get(k, 0) - 2 * per_dec - 2 * per_enc
            out[k] = max(const + n_periods * per_dec + n_enc * per_enc, 0.0)
        return out
    (_, c2), (_, c4) = variants
    for k in keys:
        per = (c4.get(k, 0) - c2.get(k, 0)) / 2
        const = c2.get(k, 0) - 2 * per
        out[k] = max(const + n_periods * per, 0.0)
    return out


def calibrated_costs(cfg: ModelConfig, cell: ShapeCell, mesh,
                     fsdp: bool = False, details: Optional[dict] = None,
                     accum: int = 1) -> Dict[str, float]:
    """Per-device cost of the FULL model, extrapolated linearly from 2- and
    4-period variants (encdec: (2, 2), (4, 2), (2, 4) decoder/encoder
    layers).  The JAX module does this because XLA counts a scan body
    once; the port has no scan, and does it to bound the run time (a cell
    runs 6 periods, not its full depth): layer costs are additive, so
    const + n_periods * per_period recovers the full model's count.

    With ``details`` (a dict), it also gets ``memory``: the full depth's
    argument bytes (exact: they are linear in the periods) and peak live
    bytes (extrapolated the same way), and ``first``: the smallest
    variant's own readings (``_cell_costs``'s ``raw``)."""
    period = len(decoder_schedule(cfg)[0])
    raws: list = []

    def variant(n_lay: int, n_enc: int = 0) -> Dict[str, float]:
        over = {"n_layers": n_lay, "scan_layers": False}
        if cfg.family == "encdec":
            over["n_enc_layers"] = n_enc
        raws.append({})
        return _cell_costs(cfg.with_overrides(**over), cell, mesh,
                           fsdp=fsdp, raw=raws[-1], accum=accum)

    if cfg.family == "encdec":
        depths = ((2, 2), (4, 2), (2, 4))
        variants = [(d, e, variant(d, e)) for d, e in depths]
        n, n_enc = cfg.n_layers, cfg.n_enc_layers
    else:
        depths = ((2 * period, 0), (4 * period, 0))
        variants = [(d // period, variant(d)) for d, _ in depths]
        n, n_enc = cfg.n_layers // period, 0
    out = _extrapolate(variants, n, n_enc)
    if details is not None:
        mems = [v[:-1] + (r["memory"],) for v, r in zip(variants, raws)]
        details["memory"] = _extrapolate(mems, n, n_enc)
        details["first"] = raws[0]
    return out


def run_cell(arch: str, cell: ShapeCell, multi_pod: bool, fsdp: bool = False,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             accum: int = 1, mesh=None) -> Dict[str, Any]:
    """One cell's record, with the JAX module's keys.  ``cost_calibrated``
    and the roofline come from the 2/4-period variants; ``memory`` is the
    full depth's (argument bytes exact, the peak extrapolated);
    ``cost``, ``collectives`` and ``collective_bytes_raw`` are the
    smallest variant's own (``raw_from``), as the JAX module's come from
    its scanned artifact.  ``mesh`` overrides :func:`scaled_mesh` (a
    ``DeviceMesh`` over a fake world).  With ``accum`` > 1 each train run
    takes that many microbatches."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.with_overrides(**cfg_overrides)
    fsdp = fsdp or getattr(cfg, "fsdp", False)
    mesh = mesh if mesh is not None else scaled_mesh(multi_pod)
    chips = mesh.size()
    sizes = mesh_shape(mesh)
    record: Dict[str, Any] = {
        "arch": arch, "shape": cell.name, "kind": cell.kind,
        "mesh": {ax: int(n) for ax, n in sizes.items()},
        "chips": chips, "multi_pod": multi_pod,
    }
    record["fsdp"] = fsdp
    record["accum"] = accum
    # what the train step's backward keeps of each period (its peak and
    # its recomputed flops follow it); prefill and decode build no graph
    record["remat"] = cfg.remat
    if cfg_overrides:
        record["cfg_overrides"] = {k: str(v) for k, v in
                                   cfg_overrides.items()}
    record["counted_on"] = COUNTED_ON

    details: dict = {}
    calib = calibrated_costs(cfg, cell, mesh, fsdp=fsdp, details=details,
                             accum=accum)
    raw, mem = details["first"], details["memory"]
    record["raw_from"] = "the 2-period variant's run"
    mem["tracked_by"] = (
        "StepRecorder: arguments are the local shard bytes of the placed "
        "state, batch and cache; peak is arguments + the live storages "
        "the step's operators made (weakref.finalize on each); both "
        "extrapolated to the full depth from the 2/4-period variants")
    # the JAX keys' times: lowering is building the placed fake cell,
    # compiling is running its step once (of the run ``raw_from`` names)
    record["lower_s"] = round(raw["lower_s"], 2)
    record["compile_s"] = round(raw["compile_s"], 2)
    record["memory"] = mem
    record["cost"] = dict(raw["cost"], bytes_accessed_is=(
        "an upper bound: every operator's local inputs and outputs, "
        "unfused"))
    # False where this torch's DTensor names its propagation otherwise:
    # the global-shaped operators it runs are then counted too
    record["sharding_prop_excluded"] = raw["marked"]
    record["collectives"] = raw["collectives"]
    record["collective_bytes_raw"] = sum(
        v["bytes"] for v in raw["collectives"].values())
    record["cost_calibrated"] = calib
    record["collective_bytes"] = calib.get("collective_bytes", 0.0)

    # --- roofline terms (per step, the card's constants; model figures) ---
    flops = calib.get("flops", 0.0)
    bytes_acc = calib.get("bytes", 0.0)
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_acc / HBM_BW
    collective_s = record["collective_bytes"] / NVLINK_BW
    mf = model_flops(cfg, cell)
    record["roofline"] = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": max((("compute", compute_s), ("memory", memory_s),
                         ("collective", collective_s)),
                        key=lambda kv: kv[1])[0],
        "model_flops_total": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_ratio": (mf / chips) / flops if flops else 0.0,
        "step_time_bound_s": max(compute_s, memory_s, collective_s),
        "constants": {"peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
                      "link_bw": NVLINK_BW, "hbm_bytes": HBM_BYTES},
        "seconds_are": "model figures (counts over the card's spec-sheet "
                       "rates), not measurements",
    }
    if any(n > NVLINK_DOMAIN for n in sizes.values()):
        record["roofline"]["collective_note"] = (
            f"an axis of {max(sizes.values())} spans more than one "
            f"{NVLINK_DOMAIN}-card NVLink domain: its collectives cross the "
            "slower inter-node network, so collective_s (at NVLink's rate) "
            "is a lower bound")
    # per-device HBM check: the step's peak of live bytes, else arguments
    peak = mem.get("peak_memory_in_bytes", 0)
    args_b = mem.get("argument_size_in_bytes", 0)
    per_dev = max(peak, args_b)
    record["fits_hbm"] = bool(per_dev <= HBM_BYTES) if per_dev else None
    record["per_device_bytes"] = per_dev
    return record


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Production-mesh dry-run of the port's LM cells on a "
                    "fake world (no card, nothing allocated).")
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape cell (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--out", default="experiments/dryrun_torch",
                    help="record directory")
    ap.add_argument("--fsdp", action="store_true",
                    help="FSDP/ZeRO-3 parameter sharding over the DP axes")
    ap.add_argument("--remat", choices=REMAT_MODES, default=None,
                    help="what the train step's backward keeps of each "
                         "period (default: the config's remat)")
    args = ap.parse_args()
    over = {"remat": args.remat} if args.remat else None
    # DTensor's note on two sequential all-reduces, and the fake tensors'
    # trace of an operator that refuses: the failure itself is reported
    for name in ("torch.distributed.tensor._redistribute",
                 "torch._subclasses.fake_tensor"):
        logging.getLogger(name).setLevel(logging.CRITICAL)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        cells = [c for c in shape_cells(cfg)
                 if args.shape is None or c.name == args.shape]
        for cell in cells:
            for mp in meshes:
                tag = (f"{arch}__{cell.name}__{'multi' if mp else 'single'}"
                       + (f"__remat-{args.remat}" if args.remat else ""))
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, cell, mp, fsdp=args.fsdp,
                                   cfg_overrides=over)
                except Exception as e:
                    print(f"[dryrun] FAIL {tag}: {e}")
                    traceback.print_exc()
                    failures.append(tag)
                    continue
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                r = rec["roofline"]
                print(f"[dryrun]   ok: run {rec['compile_s']:.1f}s  "
                      f"compute {r['compute_s']*1e3:.2f}ms  "
                      f"memory {r['memory_s']*1e3:.2f}ms  "
                      f"collective {r['collective_s']*1e3:.2f}ms  "
                      f"dominant={r['dominant']}  "
                      f"useful={r['useful_flops_ratio']:.2f}  "
                      f"per-device {rec['per_device_bytes'] / 2**30:.2f} GiB"
                      f" fits={rec['fits_hbm']}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("[dryrun] all cells passed.")


if __name__ == "__main__":
    main()
