"""Train the paper's CNNs through the port's TrIM conv, in both
directions, and the LM architectures the port has.

  PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16 \\
      --steps 4 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16 --smoke \\
      --steps 3 --batch 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --smoke --steps 20 --batch 8 --seq 64 --device cpu --ckpt-dir ckpt

Port of ``repro/launch/train.py``.  The CNN arm: seeded params
(``init_cnn``), the deterministic ``SyntheticImageDataset`` stream; on
the card every conv runs forward in the TrIM kernel and backward through
``TrimConv2dFn``: dx in the same kernel, dw in the weight-gradient
kernel.  ``--int8`` then quantizes the trained convs and runs the
calibrated int8 lane once, ``--int5`` the int5 MSR lane
(exponent-folded pairs); either fails on a non-finite feature map.  The
LM arm (``--arch`` an LM id, ``--smoke`` for its reduced fp32 config):
``CausalLM.loss`` on the ``SyntheticLMDataset`` stream of ``--seq`` + 1
tokens a row (plus 0.01 times the MoE layers' aux loss on the moe and
hybrid archs); on the card the Mamba mixer's conv1d and the attention
core run their kernels forward, under ``autograd.Function``s whose
backward is the plain version's VJP.  The vlm arch trains on text
tokens alone (its batches carry no patch embeddings); the encdec arch is
refused, since its loss takes source frames the token stream does not
hold (``make_train_step`` trains it on a batch with ``src_embeds``; the
JAX launcher's LM arm feeds tokens only too).  The archs that do not fit one card
at full width (gemma-7b's AdamW state, and the larger ones) train on
their ``--smoke`` configs.  Both arms: the one-device
``make_train_step`` (AdamW, warmup-cosine, non-finite step skip,
``--accum`` microbatches) and ``train_loop``, which with ``--ckpt-dir``
saves every ``--ckpt-every`` steps and at the end and resumes from the
latest committed step (the JAX package's checkpoint format).
``--device`` defaults to ``cuda``; without a card pass ``--device cpu``
to run the kernels' plain versions.  The launcher exits non-zero when
any step's loss or grad_norm is not finite.  ``--substrate``,
``--emulate-hw`` and ``--tuning`` select the CNN arm's execution policy
(``launch.cli.execution_parent``; the decimated replay has no backward on
the kernel substrate; the tuned winners are the forward's, measured on
``--device``).  The LM arm applies its config's ``remat`` to the layer
stack.

The mesh arm: under ``torchrun --nproc-per-node N`` (or alone, at world
1, with ``--tp`` or ``--compress-grads``) the launcher joins the process
group (NCCL on the card, gloo with ``--device cpu``), builds a
("data", "model") host mesh with ``--tp`` ranks on "model", places the
state by ``state_pspec`` and trains with the mesh step: DP over "data",
TP over "model", ZeRO-1 moments, and with ``--compress-grads`` the int8
gradient reduction with error feedback.  Rank 0 prints.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch granite-3-2b --smoke --tp 2 --compress-grads --steps 4 \
      --batch 8 --seq 16 --device cpu
"""

import argparse
import os
import sys

import numpy as np
import torch

from repro_torch.configs import (CNN_REGISTRY, CNN_SMOKES, get_config,
                                 get_smoke)
from repro_torch.data.pipeline import SyntheticImageDataset, SyntheticLMDataset
from repro_torch.distributed import (StepConfig, TrainLoopConfig, add_ef,
                                     activate_mesh, make_train_state,
                                     make_train_step, place_state,
                                     state_pspec, train_loop)
from repro_torch.engine import plan_model
from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import trim_conv1d as conv1d
from repro_torch.kernels import trim_conv2d as kernel
from repro_torch.kernels import trim_conv2d_vjp as vjp
from repro_torch.launch.cli import execution_parent, policy_from_args
from repro_torch.launch.mesh import join_process_group, make_host_mesh
from repro_torch.nn.models import build_model


def _int_check(plan, params, images: np.ndarray, device, lane: str) -> None:
    """Quantize + calibrate + run one fused integer datapath once:
    ``lane`` "int8" or "int5" (the MSR weights, exponent-folded pairs)."""
    lo, hi = float(images.min()), float(images.max())
    u8 = np.clip((images - lo) / max(hi - lo, 1e-6) * 255, 0,
                 255).astype(np.uint8)
    u8 = torch.from_numpy(u8).to(device)
    with torch.no_grad():
        if lane == "int5":
            qp, _ = plan.quantize_int5(params)
            pairs = plan.calibrate_requant_int5(qp, u8)
            feat = plan.forward_int5(qp, u8, requant=pairs)
            how = "MSR weights, exponent-folded requant"
        else:
            qp, _ = plan.quantize(params)
            pairs = plan.calibrate_requant(qp, u8)
            feat = plan.forward_int8(qp, u8, requant=pairs)
            how = "fused per-channel requant"
    finite = bool(torch.isfinite(feat.double()).all())
    print(f"[train] {lane} datapath: output {tuple(feat.shape)} dtype "
          f"{feat.dtype} finite={finite} ({how})")
    if not finite:
        raise SystemExit(f"[train] FAIL: non-finite {lane} feature map")


def _cnn(args):
    """(model, dataset, the launches line) of the CNN arm."""
    cfg = (CNN_SMOKES if args.smoke else CNN_REGISTRY)[args.arch]
    ds = SyntheticImageDataset(hw=cfg.input_hw, channels=cfg.layers[0].M,
                               n_classes=cfg.n_classes,
                               global_batch=args.batch, seed=args.seed)
    kernel.LAUNCHES = vjp.WGRAD_LAUNCHES = 0
    return (cfg, plan_model(cfg, policy_from_args(args)), ds,
            lambda: f"conv {kernel.LAUNCHES}, wgrad {vjp.WGRAD_LAUNCHES}")


def _lm(args, ap):
    """(model, dataset, the launches line) of the LM arm."""
    try:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        model = build_model(cfg, tp=args.tp, policy=policy_from_args(args))
    except (KeyError, NotImplementedError) as e:
        ap.error(f"--arch {args.arch!r}: {e.args[0]}")
    if cfg.family == "encdec":
        ap.error(f"--arch {args.arch!r}: training the encdec family from "
                 "the launcher is not ported: its loss takes source frames, "
                 "and the LM arm feeds token batches only")
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq + 1,
                            global_batch=args.batch, seed=args.seed)
    conv1d.LAUNCHES = flash.LAUNCHES = 0
    return (cfg, model, ds,
            lambda: f"conv1d {conv1d.LAUNCHES}, flash {flash.LAUNCHES}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 parents=[execution_parent(
                                     arch_required=True)])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="LM: tokens a row (the dataset draws one more)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save checkpoints here and resume from the latest")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 data-parallel gradient reduction with error "
                         "feedback (the mesh arm)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size of the host mesh (the mesh arm)")
    args = ap.parse_args()

    is_cnn = args.arch in CNN_REGISTRY
    dev = resolve_device(args.device)
    fp32_ieee()
    meshed = ("WORLD_SIZE" in os.environ or args.tp != 1
              or args.compress_grads)
    mesh, log = None, print
    if meshed:
        import torch.distributed as dist
        join_process_group(dev)
        try:
            mesh = make_host_mesh(model=args.tp, device=dev.type)
        except ValueError as e:
            torch.distributed.destroy_process_group()
            ap.error(f"--tp {args.tp}: {e}")
        if dist.get_rank() != 0:
            log = lambda *a, **k: None    # noqa: E731  (rank 0 prints)
    cfg, model, ds, launches = _cnn(args) if is_cnn else _lm(args, ap)
    scfg = StepConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps, accum=args.accum,
                      compress_grads=args.compress_grads)
    state = make_train_state(model, args.seed, dev)
    shardings = None
    if mesh is not None:
        with activate_mesh(mesh) as ctx:
            specs = state_pspec(state, ctx)
        state = place_state(state, specs, mesh)
        if args.compress_grads:
            state = add_ef(state, mesh)
        shardings = (specs, mesh)
    out = train_loop(make_train_step(model, scfg, mesh), state, ds,
                     TrainLoopConfig(total_steps=args.steps,
                                     ckpt_every=args.ckpt_every,
                                     ckpt_dir=args.ckpt_dir),
                     state_shardings=shardings, log_fn=log)
    if mesh is not None:
        from repro_torch.distributed import compression
        log(f"[train] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
            f"{', int8 gradients' if args.compress_grads else ''}: wire "
            f"{compression.WIRE_BYTES} B on this rank (plain fp32 "
            f"{compression.PLAIN_BYTES} B)")
    _report(args, cfg, model, ds, out, dev, launches, is_cnn, log)
    if mesh is not None:
        torch.distributed.destroy_process_group()


def _report(args, cfg, model, ds, out, dev, launches, is_cnn, log) -> None:
    """The summary line; exit 1 on a non-finite step; the integer lanes."""
    print = log   # noqa: A001  (rank 0 prints)
    hist = out["history"]
    if out["resumed_from"] is not None:
        print(f"[train] resumed from step {out['resumed_from']}")
    if not hist:
        print(f"[train] {cfg.name}: nothing to run past step "
              f"{out['resumed_from']}")
        return
    losses = [h["loss"] for h in hist]
    grad_norm = hist[-1].get("grad_norm", float("nan"))
    print(f"[train] {cfg.name} on {dev}: steps {hist[0]['step']}-"
          f"{hist[-1]['step']}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"grad_norm {grad_norm:.4f}; {len(out['stragglers'])} straggler "
          f"steps; kernel launches: {launches()}")
    # Every step is checked: skip_nonfinite keeps the state sane on a bad
    # step, which would hide a batch-dependent NaN from a last-step check.
    bad = [h["step"] for h in hist
           if not (np.isfinite(h["loss"])
                   and np.isfinite(h.get("grad_norm", float("nan"))))]
    if bad:
        print(f"[train] FAIL: non-finite loss or grad_norm at steps {bad}",
              file=sys.stderr)
        sys.exit(1)
    for lane in ("int8", "int5"):
        if not getattr(args, lane):
            continue
        if not is_cnn:
            print(f"[train] --{lane} ignored: LM arch has no {lane} conv "
                  "path")
            continue
        from repro_torch.distributed import gather_state
        _int_check(model, gather_state(out["state"]["params"]),
                   ds.batch_at(0)["images"], dev, lane)


if __name__ == "__main__":
    main()
