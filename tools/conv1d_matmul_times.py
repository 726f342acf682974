"""Time kernel 3 (the TrIM conv1d) and kernel 6's fp32 projections of one
checkout at the shapes their main paths give them.

    python3 tools/conv1d_matmul_times.py --src <checkout>/src [--library]

Imports ``repro_torch`` from ``--src`` (so the same script times the
parent commit's kernels and this one's), builds their libraries into that
checkout's ``build/``, and times, on the card:

- ``trim_conv1d`` in bf16 at mamba2-130m's xBC, the column slice
  ``[..., 1536:3328]`` of a (B, L, 3352) in_proj output (w (4, 1792)):
  ``conv1d full`` at (4, 4096), ``conv1d train`` at (4, 1024); ``conv1d
  rank`` on a contiguous (4, 4096, 896) (one of two ranks' channels);
  ``conv1d full fp32`` the full-width slice in fp32.  500 calls a row.
- ``trim_matmul`` in fp32 (the ``fma`` path, TF32 off) at granite-3-2b's
  projections at a 4 x 4096 prefill: ``matmul gate/up`` (16384, 2048) @
  (2048, 8192), ``matmul down`` (16384, 8192) @ (8192, 2048), ``matmul
  q/o`` (16384, 2048) @ (2048, 2048).  5 calls a row.

Each row is timed with CUDA events over its calls back to back after a
warm one (``rows``, ms a call; ``issue``, the host's time to issue them,
ms a call), and under ``torch.profiler`` as the
device time of every kernel the calls ran, in the second of two
profiled rounds (``device``, ms a call; absent where the profiler saw
none, or fewer kernels than calls).  With ``--library`` it then times, per row,
the PyTorch call that computes the same function (``F.conv1d`` with
groups = D on an input already (B, D, L); ``torch.matmul``, TF32 off),
after every kernel row, so each turn times the kernel rows alike.  Inputs
are random, from seed 11 on the card.  Prints one JSON object, ``{"card":
..., "rows": {...}, "issue": {...}, "device": {...}, "library": {...}}``;
exits non-zero without a card.  ``chip_smoke.py --parent DIR`` runs it
on DIR's checkout and on its own in turns (parent, this, this, parent).
"""
import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

CONV_CALLS = 500
MATMUL_CALLS = 5
#: row -> (B, L, D, dtype, in_proj width or None for a contiguous x)
CONV_ROWS = {
    "conv1d full": (4, 4096, 1792, torch.bfloat16, 3352),
    "conv1d train": (4, 1024, 1792, torch.bfloat16, 3352),
    "conv1d rank": (4, 4096, 896, torch.bfloat16, None),
    "conv1d full fp32": (4, 4096, 1792, torch.float32, 3352),
}
#: row -> (M, K, N)
MATMUL_ROWS = {
    "matmul gate/up": (16384, 2048, 8192),
    "matmul down": (16384, 8192, 2048),
    "matmul q/o": (16384, 2048, 2048),
}


def events_ms(fn, calls: int):
    """(Events time a call, host issue time a call): ``calls`` calls back
    to back after a warm one, timed by CUDA events on the card and by the
    host's clock from the first call's issue to the last's.  Where the
    issue time is not below the events time, the events time measures
    the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issue = (time.perf_counter() - t0) * 1e3 / calls
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, issue


def device_ms(fn, calls: int):
    """Device time a call under ``torch.profiler``: every kernel the calls
    ran, summed, in the second of two profiled rounds of ``calls`` calls
    (CUPTI can drop the first kernels of a window); None where the
    profiler saw no device time or fewer kernels than ``calls``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    seen = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]
    total = sum(e.self_device_time_total for e in seen)
    if total <= 0 or max(e.count for e in seen) < calls:
        return None
    return total / 1e3 / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    ap.add_argument("--library", action="store_true",
                    help="also time F.conv1d / torch.matmul per row")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("conv1d_matmul_times: no card (torch.cuda.is_available() "
                 "is false)")
    sys.path.insert(0, args.src)
    from repro_torch.kernels.trim_conv1d import trim_conv1d
    from repro_torch.kernels.trim_matmul import trim_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    rows, issue, device, library, calls = {}, {}, {}, {}, {}
    for name, (B, L, D, dt, width) in CONV_ROWS.items():
        if width is None:
            x = torch.randn((B, L, D), generator=gen, device=dev).to(dt)
        else:
            x = torch.randn((B, L, width), generator=gen, device=dev).to(
                dt)[..., 1536:1536 + D]
        w = (torch.randn((4, D), generator=gen, device=dev) * 0.5).to(dt)
        calls[name] = (lambda x=x, w=w: trim_conv1d(x, w),
                       lambda x=x.permute(0, 2, 1).contiguous(),
                       w=w.t().contiguous()[:, None, :], D=D, L=L:
                       F.conv1d(x, w, groups=D, padding=3)[..., :L],
                       CONV_CALLS)
    for name, (M, K, N) in MATMUL_ROWS.items():
        a = torch.randn((M, K), generator=gen, device=dev)
        b = torch.randn((K, N), generator=gen, device=dev)
        calls[name] = (lambda a=a, b=b: trim_matmul(a, b),
                       lambda a=a, b=b: torch.matmul(a, b), MATMUL_CALLS)
    for name, (fn, _, n) in calls.items():
        rows[name], issue[name] = events_ms(fn, n)
        dms = device_ms(fn, min(n, 50))
        if dms is not None:
            device[name] = dms
    if args.library:
        for name, (_, lib, n) in calls.items():
            library[name] = events_ms(lib, n)[0]
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rows": rows,
                      "issue": issue, "device": device,
                      "library": library}))


if __name__ == "__main__":
    main()
