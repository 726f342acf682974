"""Time the bf16 conv kernels of one checkout at VGG-16's shapes.

    python3 tools/bf16_conv_times.py --src <checkout>/src [--batch 8] [--reps 50]
    python3 tools/bf16_conv_times.py --src src --caps 8,4,2,1

Imports ``repro_torch`` from ``--src`` (so the same script times the
parent commit's kernels and this one's), builds its kernel libraries into
that checkout's ``build/``, and times on the card, with CUDA events over
``--reps`` back-to-back calls after a warm one, each VGG-16 conv at batch
``--batch`` through the port's entry points: kernel 1's bf16 forward
(``trim_conv2d``, bias + ReLU), its dx (``trim_conv2d_input_grad``, CL2-CL13)
and kernel 2's bf16 weight gradient (``trim_conv2d_wgrad``).  Inputs are
random, from a seeded generator on the card.  Prints one JSON object,
``{"card": ..., "rows": {"<kind> <layer>": ms}}``; exits non-zero without a
card.  ``chip_smoke.py --parent DIR`` runs it on DIR's checkout beside its
own phase 3j.  With ``--caps``, the rows are timed once for each cap on the
planners' split clusters (kernel 1's ``BF16_SPLIT_CAP``, kernel 2's
``WIN_CLUSTER_CAP``; 1: no cluster), in the order given, each under
``"rows"`` of ``{"caps": {cap: {...}}}``.
"""
import argparse
import json
import sys

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--caps", help="comma-separated caps on the planners' "
                    "split clusters, each timed in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bf16_conv_times: no card (torch.cuda.is_available() is "
                 "false)")
    sys.path.insert(0, args.src)
    from repro_torch.core.model import VGG16_LAYERS
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).bfloat16()

    N, data = args.batch, []
    for l in VGG16_LAYERS:
        K = l.K
        data.append((l, randn((N, l.H_I, l.W_I, l.M)),
                     randn((K, K, l.M, l.N), (2.0 / (K * K * l.M)) ** 0.5),
                     randn((l.N,), 0.1), randn((N, l.H_O, l.W_O, l.N))))

    def time_rows():
        rows = {}
        for l, x, w, b, g in data:
            K, p = l.K, l.padding
            rows[f"fwd {l.name}"] = ms(lambda: kern.trim_conv2d(
                x, w, stride=l.stride, padding=p, bias=b, relu=True))
            rows[f"dw {l.name}"] = ms(lambda: vjp.trim_conv2d_wgrad(
                x, g, K=K, stride=l.stride, padding=p))
            if l.name != "CL1":
                rows[f"dx {l.name}"] = ms(
                    lambda: vjp.trim_conv2d_input_grad(
                        g, w, x_hw=(l.H_I, l.W_I), stride=l.stride,
                        padding=p))
        return rows

    out = {"card": torch.cuda.get_device_name(0), "batch": N}
    if args.caps is None:
        out["rows"] = time_rows()
    else:
        kern.load_library()
        vjp.load_library()
        out["caps"] = {}
        for cap in (int(v) for v in args.caps.split(",")):
            kern.BF16_SPLIT_CAP = vjp.WIN_CLUSTER_CAP = cap
            for fn in (kern.bf16_tile, kern.bf16_launch_args,
                       vjp.wgrad_bf16_tile):
                fn.cache_clear()
            out["caps"][cap] = time_rows()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
