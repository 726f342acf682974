"""Time kernel 5's bf16 prefill (and gemma-7b's decode) of one checkout at
the served models' full-width shapes.

    python3 tools/flash_times.py --src <checkout>/src

Imports ``repro_torch`` from ``--src`` (so the same script times the
parent commit's kernel and this one's), builds its flash library into
that checkout's ``build/``, and times ``flash_attention`` on the card with
CUDA events over REPS back-to-back calls after a warm one, in bf16,
at batch 4 and a 4096-token prompt (``chip_smoke.py``'s serve shapes):

- ``gemma-7b prefill``: q (4, 4096, 16, 1, 256) causal (D = 256, G = 1);
- ``gemma-7b decode``: q (4, 1, 16, 1, 256) over a (4, 4128, 16, 256)
  cache with kv_length 4097 (the split path);
- ``llava-next-34b prefill``: q (4, 4096, 8, 7, 128) causal;
- ``starcoder2-3b prefill``: q (4, 4096, 2, 12, 128) causal;
- ``llama4-maverick prefill``: q (4, 4096, 8, 5, 128) causal;
- ``granite-3-2b prefill``: q (4, 4096, 8, 4, 64) causal;
- ``seamless encoder``: q (4, 4096, 16, 1, 64) over 4096 keys, not causal.

Inputs are random, from seed 5 on the card (NaN past kv_length).  Prints
one JSON object, ``{"card": ..., "rows": {"<row>": ms}}``; exits non-zero
without a card.  ``chip_smoke.py --parent DIR`` runs it on DIR's checkout
and on its own in turns (parent, this, this, parent) beside its flash
phases.
"""
import argparse
import json
import sys

import torch

#: timed calls a row (the rows spread by a few percent between processes
#: at 50)
REPS = 200
#: row -> (B, Sq, Sk, H, G, D, causal, kv_length or None)
ROWS = {
    "gemma-7b prefill": (4, 4096, 4096, 16, 1, 256, True, None),
    "gemma-7b decode": (4, 1, 4128, 16, 1, 256, False, 4097),
    "llava-next-34b prefill": (4, 4096, 4096, 8, 7, 128, True, None),
    "starcoder2-3b prefill": (4, 4096, 4096, 2, 12, 128, True, None),
    "llama4-maverick prefill": (4, 4096, 4096, 8, 5, 128, True, None),
    "granite-3-2b prefill": (4, 4096, 4096, 8, 4, 64, True, None),
    "seamless encoder": (4, 4096, 4096, 16, 1, 64, False, None),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_times: no card (torch.cuda.is_available() is false)")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    rows = {}
    for name, (B, Sq, Sk, H, G, D, causal, kvl) in ROWS.items():
        rnd = lambda *shape: torch.randn(shape, generator=gen,
                                         device=dev).bfloat16()
        q, k, v = rnd(B, Sq, H, G, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        length = None
        if kvl is not None:
            length = torch.full((B,), kvl, dtype=torch.int32, device=dev)
            k[:, kvl:] = float("nan")
            v[:, kvl:] = float("nan")
        rows[name] = ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, kv_length=length))
        del q, k, v
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rows": rows}))


if __name__ == "__main__":
    main()
