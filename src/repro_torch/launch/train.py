"""Train the paper's CNNs through the port's TrIM conv, in both
directions.

  PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16 \\
      --steps 4 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16 --smoke \\
      --steps 3 --batch 4 --device cpu

Port of the CNN arm of ``repro/launch/train.py``.  Seeded params
(``init_cnn``), the deterministic ``SyntheticImageDataset`` stream, the
one-device ``make_train_step`` (AdamW, warmup-cosine, non-finite step
skip, ``--accum`` microbatches) and ``train_loop``.  On the card every
conv runs forward in the TrIM kernel and backward through
``TrimConv2dFn``: dx in the same kernel, dw in the weight-gradient
kernel.  ``--device`` defaults to ``cuda``; without a card pass
``--device cpu`` to run the kernels' plain versions.  The launcher exits
non-zero when any step's loss or grad_norm is not finite.  ``--int8``
then quantizes the trained convs and runs the calibrated int8 lane once,
``--int5`` the int5 MSR lane (exponent-folded pairs); either fails on a
non-finite feature map.  ``--substrate`` and ``--emulate-hw`` select the
execution policy (``launch.cli.execution_parent``; the decimated replay
has no backward on the kernel substrate).  LM archs, ``--ckpt-dir`` and
meshes are not ported yet and are refused.
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import CNN_REGISTRY, CNN_SMOKES
from repro_torch.data.pipeline import SyntheticImageDataset
from repro_torch.distributed import (StepConfig, TrainLoopConfig,
                                     make_train_state, make_train_step,
                                     train_loop)
from repro_torch.engine import plan_model
from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.kernels import trim_conv2d as kernel
from repro_torch.kernels import trim_conv2d_vjp as vjp
from repro_torch.launch.cli import execution_parent, policy_from_args


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 parents=[execution_parent(
                                     arch_required=True)])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="not ported yet: refused")
    args = ap.parse_args()

    if args.arch not in CNN_REGISTRY:
        ap.error(f"--arch {args.arch!r}: the port trains only "
                 f"{sorted(CNN_REGISTRY)}; the LM family is not ported yet")
    if args.ckpt_dir:
        ap.error("--ckpt-dir: checkpointing is not ported yet")
    dev = resolve_device(args.device)
    fp32_ieee()
    cfg = (CNN_SMOKES if args.smoke else CNN_REGISTRY)[args.arch]
    ds = SyntheticImageDataset(hw=cfg.input_hw, channels=cfg.layers[0].M,
                               n_classes=cfg.n_classes,
                               global_batch=args.batch, seed=args.seed)
    plan = plan_model(cfg, policy_from_args(args))
    scfg = StepConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps, accum=args.accum)
    state = make_train_state(plan, args.seed, dev)
    kernel.LAUNCHES = vjp.WGRAD_LAUNCHES = 0
    out = train_loop(make_train_step(plan, scfg), state, ds,
                     TrainLoopConfig(total_steps=args.steps))
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    grad_norm = hist[-1].get("grad_norm", float("nan"))
    print(f"[train] {cfg.name} on {dev}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; grad_norm {grad_norm:.4f}; "
          f"{len(out['stragglers'])} straggler steps; kernel launches: "
          f"conv {kernel.LAUNCHES}, wgrad {vjp.WGRAD_LAUNCHES}")
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
        if getattr(args, lane):
            _int_check(plan, out["state"]["params"],
                       ds.batch_at(0)["images"], dev, lane)


if __name__ == "__main__":
    main()
