"""Batched serving example: prefill a batch of prompts, then greedy-decode
continuations through the KV/SSM-cache path.

  PYTHONPATH=src python examples/torch/serve_lm.py --arch mamba2-130m --gen 24
  PYTHONPATH=src python examples/torch/serve_lm.py --arch granite-3-2b --smoke
  PYTHONPATH=src python examples/torch/serve_lm.py --smoke --device cpu

The port of ``examples/serve_lm.py``, in fp32 as that one is.  The prefill
and decode steps are the serve launcher's executables
(``launch/serve.py``): built once, the decode step captured once as a CUDA
graph on the card (``DecodeGraph``) and replayed every step, both eager on
the CPU; the prefill's kernel launches are printed (kernel 3, the conv1d,
once a Mamba layer; kernel 5, flash attention, once an attention layer;
0 on the CPU, where the plain versions run).  Asked for the card where
there is none, it exits non-zero.  :func:`generate` takes the params.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import trim_conv1d as conv1d
from repro_torch.launch.serve import (decode_executable, prefill_executable,
                                      run_decode, run_prefill)
from repro_torch.nn.models import build_model
from repro_torch.serve import ServeEngine


def generate(model, params, prompts: np.ndarray, gen: int,
             device: torch.device):
    """Greedy continuation of ``prompts`` (B, S): (tokens (B, gen), prefill
    seconds, decode seconds, whether every logit was finite, the kernel
    launches of the timed prefill by kernel)."""
    B, S = prompts.shape
    eng = ServeEngine(name=f"serve-lm-{model.cfg.name}", buckets=(B,),
                      device=device)
    cache = model.init_cache(B, S + gen, dtype=torch.float32, device=device)
    batch = {"tokens": torch.as_tensor(prompts, device=device)}
    prefill = prefill_executable(eng, model, params, batch, cache)
    conv1d.LAUNCHES = flash.LAUNCHES = 0
    logits, cache, t_prefill = run_prefill(prefill, params, batch, cache,
                                           device)
    launches = {"conv1d": conv1d.LAUNCHES, "flash": flash.LAUNCHES}
    finite = bool(torch.isfinite(logits).all())
    tok = logits.argmax(-1)
    toks, t_decode = [tok], 0.0
    if gen > 1:
        decode = decode_executable(eng, model, params, tok, cache, S)
        more, cache, t_decode, ok = run_decode(decode, params, tok, cache, S,
                                               gen - 1, device)
        toks += more
        finite = finite and ok
    return (torch.stack(toks, 1).cpu().numpy(), t_prefill, t_decode, finite,
            launches)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"serve_lm: {e}")
    fp32_ieee()

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.with_overrides(dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    gen, t_prefill, t_decode, finite, launches = generate(
        model, params, prompts, args.gen, dev)
    n = args.batch * (args.gen - 1)
    print(f"[serve] {cfg.name} on {dev}: prefill {args.batch}x"
          f"{args.prompt_len} in {t_prefill * 1e3:.0f} ms; decode {n} "
          f"tokens in {t_decode * 1e3:.0f} ms "
          f"({n / max(t_decode, 1e-9):.1f} tok/s)")
    print("[serve] kernel launches in the prefill: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    print(f"[serve] continuation[0]: {gen[0].tolist()}")
    if not finite:
        sys.exit("[serve] FAILED: non-finite logits")


if __name__ == "__main__":
    main()
