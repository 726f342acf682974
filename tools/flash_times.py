"""Time kernel 5 (flash attention) of one checkout at the served models'
full-width shapes: the bf16 prefill rows (and gemma-7b's decode), and the
fp32 lane's prefill, decode and partial-entry rows.

    python3 tools/flash_times.py --src <checkout>/src [--sdpa]

Imports ``repro_torch`` from ``--src`` (so the same script times the
parent commit's kernel and this one's), builds its flash library into
that checkout's ``build/``, and times ``flash_attention`` (the partial
row: ``flash_attention_partial``) on the card with CUDA events over a
row's calls, back to back after a warm one, at batch 4 and a 4096-token
prompt (``chip_smoke.py``'s serve shapes):

- bf16, 200 calls a row: ``gemma-7b prefill`` q (4, 4096, 16, 1, 256)
  causal; ``gemma-7b decode`` q (4, 1, 16, 1, 256) over a (4, 4128, 16,
  256) cache with kv_length 4097; ``llava-next-34b prefill`` q (4, 4096,
  8, 7, 128), ``starcoder2-3b prefill`` q (4, 4096, 2, 12, 128),
  ``llama4-maverick prefill`` q (4, 4096, 8, 5, 128) and ``granite-3-2b
  prefill`` q (4, 4096, 8, 4, 64), causal; ``seamless encoder`` q (4,
  4096, 16, 1, 64) over 4096 keys, not causal;
- fp32 (rows named ``... fp32``): the prefills of granite-3-2b, gemma-7b
  and llava-next-34b and seamless's encoder at those shapes (10 calls a
  row); ``granite-3-2b decode fp32`` q (4, 1, 8, 4, 64) over a (4, 4128,
  8, 64) cache with kv_length 4097 and ``partial entry fp32`` q (4, 1, 8,
  7, 128) over llava's 2064-key half cache (200 calls a row).

Inputs are random, from seed 5 on the card (NaN past kv_length).  With
``--sdpa`` it then times, per row, the PyTorch call that computes the same
function (``F.scaled_dot_product_attention`` with the KV heads repeated,
over the keys kv_length leaves; the partial row
``aten._scaled_dot_product_efficient_attention`` with its log-sum-exp),
TF32 off, in a second pass after every kernel row, so that each turn
times the kernel rows under the same conditions (with SDPA between the
rows, that turn's starcoder2-3b row read 0.9152 and 0.9191 ms in two
runs against 0.8641-0.8813 in the other turns).  Prints one JSON object,
``{"card": ..., "rows": {"<row>": ms}, "sdpa": {"<row>": ms}}`` (``sdpa``
empty without ``--sdpa``); exits non-zero without a card.  ``chip_smoke.py --parent DIR`` runs it on DIR's checkout
and on its own in turns (parent, this, this, parent) beside its flash
phases.
"""
import argparse
import json
import sys

import torch
import torch.nn.functional as F

#: row -> (B, Sq, Sk, H, G, D, causal, kv_length or None, dtype, calls);
#: the calls keep each row near a second on the slowest (parent) kernel
ROWS = {
    "gemma-7b prefill": (4, 4096, 4096, 16, 1, 256, True, None, "bf16", 200),
    "gemma-7b decode": (4, 1, 4128, 16, 1, 256, False, 4097, "bf16", 200),
    "llava-next-34b prefill": (4, 4096, 4096, 8, 7, 128, True, None, "bf16",
                               200),
    "starcoder2-3b prefill": (4, 4096, 4096, 2, 12, 128, True, None, "bf16",
                              200),
    "llama4-maverick prefill": (4, 4096, 4096, 8, 5, 128, True, None, "bf16",
                                200),
    "granite-3-2b prefill": (4, 4096, 4096, 8, 4, 64, True, None, "bf16",
                             200),
    "seamless encoder": (4, 4096, 4096, 16, 1, 64, False, None, "bf16", 200),
    "granite-3-2b prefill fp32": (4, 4096, 4096, 8, 4, 64, True, None,
                                  "fp32", 10),
    "gemma-7b prefill fp32": (4, 4096, 4096, 16, 1, 256, True, None, "fp32",
                              10),
    "llava-next-34b prefill fp32": (4, 4096, 4096, 8, 7, 128, True, None,
                                    "fp32", 10),
    "seamless encoder fp32": (4, 4096, 4096, 16, 1, 64, False, None, "fp32",
                              10),
    "granite-3-2b decode fp32": (4, 1, 4128, 8, 4, 64, False, 4097, "fp32",
                                 200),
    "partial entry fp32": (4, 1, 2064, 8, 7, 128, False, None, "fp32", 200),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    ap.add_argument("--sdpa", action="store_true",
                    help="also time the PyTorch call of each row (TF32 off)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_times: no card (torch.cuda.is_available() is false)")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)

    def ms(fn, calls) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    def inputs(B, Sq, Sk, H, G, D, kvl, dt):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        rnd = lambda *shape: torch.randn(shape, generator=gen,
                                         device=dev).to(dtype)
        q, k, v = rnd(B, Sq, H, G, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        length = None
        if kvl is not None:
            length = torch.full((B,), kvl, dtype=torch.int32, device=dev)
            k[:, kvl:] = float("nan")
            v[:, kvl:] = float("nan")
        return q, k, v, length

    rows, sdpa = {}, {}
    for name, (B, Sq, Sk, H, G, D, causal, kvl, dt, calls) in ROWS.items():
        q, k, v, length = inputs(B, Sq, Sk, H, G, D, kvl, dt)
        if name.startswith("partial"):
            rows[name] = ms(lambda: fa.flash_attention_partial(q, k, v),
                            calls)
        else:
            rows[name] = ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, kv_length=length), calls)
        del q, k, v
    for name, (B, Sq, Sk, H, G, D, causal, kvl, dt, calls) in (
            ROWS.items() if args.sdpa else ()):
        q, k, v, _ = inputs(B, Sq, Sk, H, G, D, kvl, dt)
        keys = Sk if kvl is None else kvl
        qt = q.reshape(B, Sq, H * G, D).transpose(1, 2)
        kt = k[:, :keys].repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v[:, :keys].repeat_interleave(G, dim=2).transpose(1, 2)
        if name.startswith("partial"):
            sdpa[name] = ms(lambda: torch.ops.aten.
                            _scaled_dot_product_efficient_attention(
                                qt, kt, vt, None, True), calls)
        else:
            sdpa[name] = ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), calls)
        del q, k, v, qt, kt, vt
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rows": rows,
                      "sdpa": sdpa}))


if __name__ == "__main__":
    main()
