"""Time kernel 4 (the TrIM-SSD scan) of one checkout at mamba2-130m's shape.

    python3 tools/ssd_times.py --src <checkout>/src [--reps 200]

Imports ``repro_torch`` from ``--src`` (so the same script times the
parent commit's kernel and this one's), builds its SSD library into that
checkout's ``build/``, and times ``trim_ssd`` on the card with CUDA events
over ``--reps`` back-to-back calls after a warm one, at mamba2-130m's
full-width prefill: x (4, 4096, 24, 64), B/C (4, 4096, 1, 128) expanded
over the 24 heads (stride 0), chunk 256, in fp32 and in bf16 (x/B/C
rounded).  Inputs are random, from seed 7 on the card.  Prints one JSON
object, ``{"card": ..., "rows": {"<dtype>": ms}}``; exits non-zero without
a card.  ``chip_smoke.py --parent DIR`` runs it on DIR's checkout and on
its own in turns (parent, this, this, parent) beside phase 3f.
"""
import argparse
import json
import sys

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ssd_times: no card (torch.cuda.is_available() is false)")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import trim_ssd as ks

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    B, L, H, P, S, CS = 4, 4096, 24, 64, 128, 256
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    nrm = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    Bm, Cm = nrm(B, L, 1, S), nrm(B, L, 1, S)
    x, dt = nrm(B, L, H, P), 1e-3 + u(B, L, H) * (0.1 - 1e-3)
    A, D = -(0.3 + u(H) * 1.7), nrm(H)

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

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        # one group rounded, then expanded: a stride-0 view over the heads
        xd, Bd, Cd = (t.to(dtype) for t in (x, Bm, Cm))
        Bd, Cd = Bd.expand(B, L, H, S), Cd.expand(B, L, H, S)
        rows[str(dtype).replace("torch.", "")] = ms(
            lambda: ks.trim_ssd(xd, dt, A, Bd, Cd, D, chunk=CS))
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rows": rows}))


if __name__ == "__main__":
    main()
