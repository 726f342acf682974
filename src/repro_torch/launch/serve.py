"""Serving launcher for the port's LMs: batched prefill + greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --batch 4 --prompt-len 4096 --gen 32

Port of ``repro/launch/serve.py``.  The prefill and decode steps
(``distributed.steps.make_prefill_step`` / ``make_decode_step``) are built
once each through the port's ``ServeEngine.executable`` cache, keyed by
the device stamp and the workload (arch, step, shape), as eager callables
under ``torch.inference_mode`` warmed by one call, so no kernel build
lands inside a timer (CUDA graphs are later work).  On the ssm family
(mamba2-130m) the prefill runs the TrIM conv1d kernel once per layer;
decode never does.  On the dense family (granite-3-2b) every layer's
attention core runs the flash-attention kernel, once per prefill and once
per decode step; the KV cache is written in place.

Prefill latency and decode tokens/s are reported separately.  The flags
are the JAX launcher's plus ``--device`` (default ``cuda``: without a
card it raises, it never falls back to the CPU; pass ``--device cpu`` for
the plain PyTorch path) and ``--dtype`` (default: the config's; the smoke
configs are fp32).  ``--arch`` takes the architectures the port registers
(``repro_torch.configs.ARCH_IDS``).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.distributed.steps import make_decode_step, make_prefill_step
from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.launch.cli import serve_config_from_args, serving_parent
from repro_torch.nn.models import build_model
from repro_torch.serve import ServeEngine

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warmed(step: Callable, *args) -> Callable:
    """``step`` under inference mode, called once on ``args`` (which loads,
    and on the card builds, its kernels); the warm result is dropped."""
    fn = torch.inference_mode()(step)
    fn(*args)
    return fn


def prefill_executable(eng: ServeEngine, model, params, batch: Dict,
                       cache) -> Callable:
    """The prefill step for ``batch``'s shape, built and warmed once per
    engine."""
    B, S = batch["tokens"].shape
    key = eng.executable_key(model.cfg.name, "prefill", f"b{B} p{S}")
    return eng.executable(key, lambda: _warmed(
        make_prefill_step(model), params, batch, cache))


def decode_executable(eng: ServeEngine, model, params, token: torch.Tensor,
                      cache, pos: int) -> Callable:
    """The one-token decode step for ``token``'s batch, built and warmed
    once per engine."""
    key = eng.executable_key(model.cfg.name, "decode", f"b{token.shape[0]}")
    return eng.executable(key, lambda: _warmed(
        make_decode_step(model), params, token, cache, pos))


def run_prefill(prefill: Callable, params, batch: Dict, cache,
                device: torch.device) -> Tuple[torch.Tensor, object, float]:
    """(last-position logits, cache, seconds) for one timed prefill."""
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    _sync(device)
    return logits, cache, time.perf_counter() - t0


def run_decode(decode: Callable, params, token: torch.Tensor, cache,
               pos0: int, steps: int, device: torch.device
               ) -> Tuple[List[torch.Tensor], object, float, bool]:
    """Greedy decode of ``steps`` tokens after ``token`` (written at
    ``pos0``): (the tokens, the cache, seconds, whether every logit was
    finite)."""
    tokens = []
    finite = torch.ones((), dtype=torch.bool, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = decode(params, token, cache, pos0 + i)
        finite &= torch.isfinite(logits).all()
        token = logits.argmax(-1)
        tokens.append(token)
    _sync(device)
    return tokens, cache, time.perf_counter() - t0, bool(finite)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 parents=[serving_parent()])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="params and activations (default: the config's)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = cfg.with_overrides(dtype=DTYPES[args.dtype])
    # the LM loop's only "bucket" is its static decode batch
    serve_config = serve_config_from_args(args, buckets=(args.batch,),
                                          datapath="float")
    model = build_model(cfg, tp=args.tp)
    fp32_ieee()
    max_len = args.prompt_len + args.gen

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    eng = ServeEngine(name=f"lm-{cfg.name}", buckets=serve_config.buckets,
                      device=dev)
    params = model.init(0, dev)
    cache = model.init_cache(args.batch, max_len, dtype=cfg.dtype, device=dev)
    batch0 = {"tokens": torch.as_tensor(prompts, device=dev)}
    prefill = prefill_executable(eng, model, params, batch0, cache)
    logits, cache, prefill_s = run_prefill(prefill, params, batch0, cache, dev)
    finite = bool(torch.isfinite(logits).all())
    tok = logits.argmax(-1)
    out_tokens = [tok]
    decode_s = 0.0
    if args.gen > 1:
        decode = decode_executable(eng, model, params, tok, cache,
                                   args.prompt_len)
        toks, cache, decode_s, dec_finite = run_decode(
            decode, params, tok, cache, args.prompt_len, args.gen - 1, dev)
        out_tokens += toks
        finite = finite and dec_finite
    gen = torch.stack(out_tokens, 1).cpu().numpy()
    decode_tps = args.batch * (args.gen - 1) / max(decode_s, 1e-9)
    print(f"[serve] {cfg.name} ({str(cfg.dtype).replace('torch.', '')}) on "
          f"{dev}: generated {gen.shape} tokens; prefill "
          f"{prefill_s * 1e3:.1f} ms (batch {args.batch}, prompt "
          f"{args.prompt_len}); decode {decode_tps:.1f} tok/s over "
          f"{args.gen - 1} steps (batch {args.batch})")
    print("[serve] sample:", gen[0][:16].tolist())
    if not finite:
        print("[serve] FAILED: non-finite logits", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
