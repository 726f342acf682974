"""The paper's own CNN workloads (VGG-16 / AlexNet) as a pod-scale
data-parallel training step through the TrIM conv path, dry-run on a fake
world (port of ``repro/launch/dryrun_cnn.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_cnn --arch vgg16

The step is the mesh arm of ``make_train_step`` with AdamW
(``optim/adamw.py``): the params and the AdamW state replicated, the
images and labels cut over the data axes ("pod", "data"); each conv runs
its filters cut over "model" (``engine/execute.py:_conv_layer_on_mesh``,
as the JAX package's GSPMD cuts them at ``nn/blocks.py:345``).  It runs
once on fake tensors inside
:class:`~repro_torch.launch.hlo_stats.StepRecorder` on the mesh of
:func:`~repro_torch.launch.dryrun.scaled_mesh`, and the record has the
JAX module's keys, the roofline at the card's figures (model figures, not
measurements; see :mod:`repro_torch.launch.dryrun`).

Execution flags (``--substrate`` / ``--emulate-hw`` / ``--int8`` /
``--int5``) come from the shared launcher parent (``launch.cli``) and
map onto one ``ExecutionPolicy``; the per-layer plan
(``plan_model(...).describe()``) is recorded.  ``--int8`` adds the
integer inference forward with placeholder requant pairs (16384, 20) in
every non-last layer, ``--int5`` the MSR weight lane's: each rank runs
it on its rows of the batch (the integer lanes have no mesh arm; a
data-parallel forward issues no collective).  ``--tuning cached`` plans
each layer with the autotuner's persisted CPU winners and ``auto``
measures a miss on the CPU first (the dry-run runs no card; the records'
``plan`` shows ``"tuned": true`` where a winner applied).  Plans are made
before the fake mode is entered: a measurement on fake tensors measures
nothing.
"""
import argparse
import json
import logging
import os
import time

import torch

from repro_torch.configs import CNN_REGISTRY
from repro_torch.core.model import layer_ops
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed.sharding import P, activate_mesh, mesh_shape
from repro_torch.distributed.steps import (StepConfig, batch_pspec,
                                           make_train_state, make_train_step)
from repro_torch.engine import plan_model
from repro_torch.launch.cli import execution_parent, policy_from_args
from repro_torch.launch.dryrun import (COUNTED_ON, _real, fake_place,
                                      scaled_mesh)
from repro_torch.launch.hlo_stats import (StepRecorder, collective_stats,
                                          cost_dict, hbm_bytes_estimate,
                                          total_collective_bytes)
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.optim import AdamWConfig


def _roofline(flops: float, byts: float, coll: float, useful: float,
              chips: int) -> dict:
    times = {"compute": flops / PEAK_FLOPS_BF16, "memory": byts / HBM_BW,
             "collective": coll / NVLINK_BW}
    return {
        "compute_s": times["compute"],
        "memory_s": times["memory"],
        "collective_s": times["collective"],
        "dominant": max(times, key=times.get),
        "model_flops_total": useful,
        "useful_flops_ratio": (useful / chips) / flops if flops else 0.0,
        "seconds_are": "model figures (counts over the card's spec-sheet "
                       "rates), not measurements",
    }


def _local_rows(mesh, dp) -> int:
    """How many ways the data axes cut the batch."""
    sizes = mesh_shape(mesh)
    n = 1
    for a in dp:
        n *= sizes[a]
    return n


def _int_record(cfg, args, mesh, dp, policy, datapath="int8"):
    """An integer inference forward (fused multiplier+shift requant in
    every non-last layer) on this rank's rows, and its roofline.  The
    requant constants are placeholder calibrations: the dry-run studies
    the schedule, not accuracy.  ``datapath="int5"`` runs the MSR weight
    lane (per-channel exponent operands)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    H, W = cfg.input_hw
    int5 = datapath == "int5"
    mplan = plan_model(cfg, policy)
    lane = mplan.int5 if int5 else mplan.int8     # planned (tuned) here
    rows = args.batch // _local_rows(mesh, dp)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        qp = {"conv": [
            dict({"kernel": torch.empty((l.K, l.K, l.M, l.N),
                                        dtype=torch.int8)},
                 **({"shift": torch.empty((l.N,), dtype=torch.int32)}
                    if int5 else {}))
            for l in cfg.layers]}
        requant = [(torch.full((l.N,), 16384, dtype=torch.int32),
                    torch.full((l.N,), 20, dtype=torch.int32))
                   for l in cfg.layers[:-1]]
        imgs = torch.empty((rows, H, W, cfg.layers[0].M), dtype=torch.uint8)
        args_in = [t for t in tree_leaves(qp)] + [imgs]
        rec = StepRecorder(args_in)
        with rec, torch.no_grad():
            if int5:
                out = mplan.forward_int5(qp, imgs, requant=requant)
            else:
                out = mplan.forward_int8(qp, imgs, requant=requant)
            del out
        mem = hbm_bytes_estimate(args_in, rec)
    cost = cost_dict(rec)
    coll = total_collective_bytes(rec.collectives)
    conv_flops = sum(layer_ops(l) for l in cfg.layers) * args.batch
    return {
        "arch": cfg.name, "shape": f"{datapath}_infer_{H}x{W}_b{args.batch}",
        "kind": f"{datapath}_infer", "chips": mesh.size(),
        "multi_pod": args.multi_pod,
        "mesh": {ax: int(n) for ax, n in mesh_shape(mesh).items()},
        "tuning": policy.tuning,
        "plan": list(lane.describe()),
        "counted_on": COUNTED_ON + ", each rank's rows",
        "compile_s": round(time.time() - t0, 1),
        "memory": mem,
        "cost": cost,
        "collectives": collective_stats(rec.collectives),
        "collective_bytes": coll,
        "roofline": _roofline(cost["flops"], cost["bytes accessed"], coll,
                              conv_flops, mesh.size()),
    }


def train_record(cfg, args, mesh, policy) -> dict:
    """The data-parallel train step's record on ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    chips = mesh.size()
    plan = plan_model(cfg, policy)
    H, W = cfg.input_hw
    dp = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        shapes = make_train_state(plan, 0, "meta")
        state = fake_place(shapes, tree_map(lambda _: P(), shapes), mesh)
        batch = {"images": torch.empty((args.batch, H, W, cfg.layers[0].M),
                                       dtype=torch.float32, device="meta"),
                 "labels": torch.empty((args.batch,), dtype=torch.int32,
                                       device="meta")}
        with activate_mesh(mesh) as ctx:
            b = fake_place(batch, batch_pspec(batch, ctx), mesh)
        step = _real(make_train_step, plan, StepConfig(adamw=AdamWConfig()),
                     mesh)
        arguments = tree_leaves(state) + tree_leaves(b)
        rec = StepRecorder(arguments)
        with rec:
            out = step(state, b)
            del out
        mem = hbm_bytes_estimate(arguments, rec)
    cost = cost_dict(rec)
    coll = total_collective_bytes(rec.collectives)
    conv_flops = 3 * sum(layer_ops(l) for l in cfg.layers) * args.batch
    return {
        "arch": args.arch, "shape": f"train_{H}x{W}_b{args.batch}",
        "kind": "train", "chips": chips, "emulate_hw": args.emulate_hw,
        "mesh": {ax: int(n) for ax, n in mesh_shape(mesh).items()},
        "tuning": policy.tuning,
        "plan": list(plan.describe()),
        "counted_on": COUNTED_ON,
        "compile_s": round(time.time() - t0, 1),
        "memory": mem,
        "cost": cost,
        "collectives": collective_stats(rec.collectives),
        "collective_bytes": coll,
        "roofline": _roofline(cost["flops"], cost["bytes accessed"], coll,
                              conv_flops, chips),
    }


def main() -> None:
    ap = argparse.ArgumentParser(parents=[execution_parent(
        arch_choices=CNN_REGISTRY, arch_default="vgg16")])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()
    for name in ("torch.distributed.tensor._redistribute",
                 "torch._subclasses.fake_tensor"):
        logging.getLogger(name).setLevel(logging.CRITICAL)

    # no card in a dry-run: the tuner's cache and measurements are the CPU's
    policy = policy_from_args(args).with_overrides(tune_device="cpu")
    cfg = CNN_REGISTRY[args.arch]
    mesh = scaled_mesh(args.multi_pod)
    rec = train_record(cfg, args, mesh, policy)
    os.makedirs(args.out, exist_ok=True)
    tag = (f"{args.arch}__cnn_train__"
           f"{'multi' if args.multi_pod else 'single'}"
           f"{'__emuhw' if args.emulate_hw else ''}")
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(f"[dryrun_cnn] {tag}: run {rec['compile_s']}s  "
          f"compute {r['compute_s']*1e3:.1f}ms  memory "
          f"{r['memory_s']*1e3:.1f}ms  collective "
          f"{r['collective_s']*1e3:.1f}ms  useful "
          f"{r['useful_flops_ratio']:.2f}")

    dp = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    lanes = [("int8", args.int8), ("int5", getattr(args, "int5", False))]
    for datapath, wanted in lanes:
        if not wanted:
            continue
        irec = _int_record(cfg, args, mesh, dp, policy, datapath)
        itag = (f"{args.arch}__cnn_{datapath}__"
                f"{'multi' if args.multi_pod else 'single'}")
        with open(os.path.join(args.out, itag + ".json"), "w") as f:
            json.dump(irec, f, indent=1)
        ir = irec["roofline"]
        print(f"[dryrun_cnn] {itag}: run {irec['compile_s']}s  "
              f"compute {ir['compute_s']*1e3:.1f}ms  memory "
              f"{ir['memory_s']*1e3:.1f}ms  collective "
              f"{ir['collective_s']*1e3:.1f}ms")


if __name__ == "__main__":
    main()
