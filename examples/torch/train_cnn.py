"""End-to-end CNN training through the TrIM conv path (the paper's own
workload, float mode), on deterministic synthetic images -- written against
the port's execution-plan API (``repro_torch.engine``).

  PYTHONPATH=src python examples/torch/train_cnn.py --steps 60
  PYTHONPATH=src python examples/torch/train_cnn.py --steps 8 --device cpu

The port of ``examples/train_cnn.py``.  ``plan_model(cfg, policy)`` plans
the per-layer TrIM kernel schedule once; training, quantization, requant
calibration and the fused int8 inference datapath all run off the same
``ModelPlan``.  On the card every conv runs forward in kernel 1 and
backward through ``TrimConv2dFn`` (dx in kernel 1, dw in kernel 2); on the
CPU (``--device cpu``) the same calls run the plain versions.  Accuracy on
the class-structured synthetic set rises well above chance within ~50
steps; afterwards the float/int8 agreement is reported.  :func:`train`
takes the params.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import CNN_SMOKES
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.data.pipeline import SyntheticImageDataset
from repro_torch.engine import ExecutionPolicy, SUBSTRATES, plan_model
from repro_torch.engine.execute import max_pool2x2, run_conv_layer
from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.kernels import trim_conv2d as kernel
from repro_torch.kernels import trim_conv2d_vjp as vjp
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def train(plan, params, ds, steps: int, lr: float, device: torch.device,
          log=print):
    """``steps`` AdamW steps of ``plan.loss`` on ``ds`` from ``params``:
    (params, [loss of each step])."""
    opt = adamw_init(params)
    ocfg = AdamWConfig(weight_decay=0.01)
    losses = []
    for s in range(steps):
        b = ds.batch_at(s)
        batch = {"images": torch.as_tensor(b["images"], device=device),
                 "labels": torch.as_tensor(b["labels"], device=device)}
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, mets = plan.loss(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
        params, opt, _ = adamw_update(tree_unflatten(params, list(grads)),
                                      opt, params, lr, ocfg)
        losses.append(float(loss.detach()))
        if s % 10 == 0 or s == steps - 1:
            log(f"step {s:3d}  loss {losses[-1]:.3f}  "
                f"acc {float(mets['acc']):.2f}")
    return params, losses


def int8_agreement(plan, params, images: np.ndarray, device: torch.device):
    """Quantize, calibrate the per-channel fused requant on ``images`` as
    uint8 and run the int8 datapath; returns (its last feature map, the
    cosine similarity of that map, pooled as the float stack pools it,
    with the float conv stack's on the same uint8 images)."""
    lo, hi = float(images.min()), float(images.max())
    u8 = np.clip((images - lo) / max(hi - lo, 1e-6) * 255, 0,
                 255).astype(np.uint8)
    u8 = torch.from_numpy(u8).to(device)
    with torch.no_grad():
        qp, _ = plan.quantize(params)
        pairs = plan.calibrate_requant(qp, u8)
        feat = plan.forward_int8(qp, u8, requant=pairs)
        x = u8.float()
        for i, lp in enumerate(plan.layers):
            x = run_conv_layer(lp, params["conv"][i], x)
        q = feat.double()
        if plan.layers[-1].pool:
            q = max_pool2x2(q)
        a, b = x.double().flatten(), q.flatten()
        cos = float(a @ b / max(float(a.norm() * b.norm()), 1e-30))
    return feat, cos


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--arch", default="vgg16", choices=["vgg16", "alexnet"])
    ap.add_argument("--substrate", default="auto", choices=SUBSTRATES,
                    help="kernel substrate (ExecutionPolicy)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"train_cnn: {e}")
    fp32_ieee()

    cfg = CNN_SMOKES[args.arch]
    # The plan is the whole execution story: substrate + per-layer
    # schedule, resolved once -- no kernel kwargs thread through the step.
    plan = plan_model(cfg, ExecutionPolicy(substrate=args.substrate))
    ds = SyntheticImageDataset(hw=cfg.input_hw, channels=cfg.layers[0].M,
                               n_classes=cfg.n_classes,
                               global_batch=args.batch)
    kernel.LAUNCHES = vjp.WGRAD_LAUNCHES = 0
    params, losses = train(plan, plan.init(0, dev), ds, args.steps, args.lr,
                           dev)
    print(f"kernel launches in training: conv {kernel.LAUNCHES} (forward "
          f"and dx), wgrad {vjp.WGRAD_LAUNCHES}")

    # integer datapath (paper §III-A precision), same plan: quantize,
    # calibrate the per-channel fused requant, run fully fused.
    feat, cos = int8_agreement(plan, params, ds.batch_at(0)["images"], dev)
    print(f"int8 TrIM datapath: output {tuple(feat.shape)} dtype "
          f"{feat.dtype} (int32 psums, fused per-channel requant)")
    print(f"float/int8 agreement: cosine {cos:.4f} between the float conv "
          f"stack's features and the int8 datapath's on {args.batch} images")


if __name__ == "__main__":
    main()
