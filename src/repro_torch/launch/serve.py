"""Serving launcher for the port's LMs: batched prefill + greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --batch 4 --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
      --batch 4 --prompt-len 4096 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-large-v2 --batch 4 --prompt-len 4096 --gen 32

Port of ``repro/launch/serve.py``.  The prefill and decode steps
(``distributed.steps.make_prefill_step`` / ``make_decode_step``) are built
once each through the port's ``ServeEngine.executable`` cache, keyed by
the device stamp and the workload (arch, step, shape), so no kernel build
lands inside a timer.  On the card the decode step is the JAX package's
compiled decode executable's counterpart: captured once per (arch,
decode batch) as a CUDA graph (:class:`DecodeGraph`, ``engine/graphs.py``)
on static token, position and cache buffers, and replayed every step;
the position is a device tensor, as the JAX loop's traced
``jnp.int32(pos0 + i)``, so nothing is recaptured as it moves.  The
prefill stays an eager callable under ``torch.inference_mode`` warmed by
one call: it is device-bound (idle share 0.020-0.031, ``PERF.md`` §5),
and capturing it would hold the plain SSD's fp32 intermediates in the
graph pool.  On the CPU both steps are those eager callables.  On the ssm
family (mamba2-130m) the prefill runs the TrIM conv1d kernel once per
layer; decode never does.  On the dense and moe families (granite-3-2b,
starcoder2-3b, gemma-7b at head dim 256, mistral-large-123b, arctic-480b,
llama4-maverick-400b-a17b) every layer's attention core runs the
flash-attention kernel, once per prefill and once per decode step; the
hybrid jamba-1.5-large-398b runs both kernels on its slots of each kind.
The MoE layers' decode replays in the graph like the rest (their
dispatch reads nothing back to the host).  The caches are written in
place.  The vlm family (llava-next-34b) is served text-only, as the JAX
launcher serves it.  The encdec family (seamless-m4t-large-v2) takes the
JAX launcher's encdec arm: a seeded source of ``--prompt-len`` frames
(B, prompt_len, d_model) in the config's dtype, a bos of zeros as the
target prompt, a cross-KV of ``prompt_len`` source positions, and decode
from position 1; its prefill runs the flash kernel in the encoder's,
the decoder's and the cross-attention layers, and each decode step in
the decoder's self- and cross-attention, over the cross-KV the prefill
wrote into the cache (the graph replays on it).

``--tp`` sets the attention head layout of a ``--tp``-way model axis
(KV heads repeated, q groups padded; the params do not change).  Under
``torchrun --nproc-per-node N`` the launcher joins the process group
(NCCL on the card, gloo with ``--device cpu``), builds a ("data",
"model") host mesh with ``--tp`` ranks on "model", places the params by
``param_pspec``, the cache by ``cache_pspec`` and the prompts by
``batch_pspec`` (``distributed.steps.serve_shardings``), and runs the
prefill and each decode step eagerly on the DTensors (no graph); rank 0
prints.  On a mesh the ssm and hybrid families serve only where "model"
has one rank (ROADMAP queue 1, item 10).

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch granite-3-2b --smoke --tp 2 --device cpu

Prefill latency and decode tokens/s are reported separately.  The flags
are the JAX launcher's plus ``--device`` (default ``cuda``: without a
card it raises, it never falls back to the CPU; pass ``--device cpu`` for
the plain PyTorch path) and ``--dtype`` (default: the config's; the smoke
configs are fp32).  ``--arch`` takes the architectures the port registers
(``repro_torch.configs.ARCH_IDS``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed.steps import make_decode_step, make_prefill_step
from repro_torch.engine import graphs
from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.launch.cli import serve_config_from_args, serving_parent
from repro_torch.launch.mesh import join_process_group, make_host_mesh
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


class DecodeGraph:
    """The decode step captured once on the card: ``decode(params, token,
    cache, pos) -> (logits, cache)`` writes ``token`` and ``pos`` (an int
    or a 0-d device tensor) into its static buffers on the device and
    replays.  ``params`` are the ones it was captured on.  The step writes
    the cache it was captured on in place and returns it; a cache of the
    same shapes from a new prefill is copied into it first, once, since
    the steps after pass the returned cache back.  The logits are a static
    tensor the next replay overwrites.  The warm call runs on a copy of
    the cache, since the step advances the state it is given."""

    def __init__(self, step: Callable, params, token: torch.Tensor, cache,
                 pos, pool, label: str):
        self.params, self.cache = params, cache
        self.token = token.clone()
        self.pos = torch.zeros((), dtype=torch.long, device=token.device)
        self.pos.copy_(torch.as_tensor(pos))
        fn = torch.inference_mode()(
            lambda: step(params, self.token, cache, self.pos)[0])
        warm = torch.inference_mode()(lambda: step(
            params, self.token, tree_map(torch.clone, cache), self.pos))
        self.graph = graphs.capture(fn, pool, label=label, warm=warm)

    @property
    def launches(self) -> Dict[str, int]:
        """The kernel launches of one replay, by kernel name."""
        return self.graph.launches

    @property
    def warm_launches(self) -> Dict[str, int]:
        return self.graph.warm_launches

    @torch.inference_mode()
    def _adopt(self, cache) -> None:
        """Copy a new generation's cache into the static one."""
        mine, theirs = tree_leaves(self.cache), tree_leaves(cache)
        if [(t.shape, t.dtype) for t in mine] != \
                [(t.shape, t.dtype) for t in theirs]:
            raise ValueError("a decode graph replays on caches of the shapes "
                             "and dtypes it was captured on")
        for a, b in zip(mine, theirs):
            a.copy_(b)

    def __call__(self, params, token: torch.Tensor, cache, pos):
        if params is not self.params:
            raise ValueError("a decode graph replays on the params it was "
                             "captured on")
        if cache is not self.cache:
            self._adopt(cache)
        if token is not self.token:
            self.token.copy_(token)
        if pos is not self.pos:
            if isinstance(pos, torch.Tensor):
                self.pos.copy_(pos)
            else:
                self.pos.fill_(int(pos))
        return self.graph.replay(), self.cache


def _prefill_tag(batch: Dict) -> str:
    """The shape key of a prefill batch: the tokens' (B, S), and the
    source's or the prepended embeddings' length where the batch has
    them."""
    B, S = batch["tokens"].shape
    tag = f"b{B} p{S}"
    if "src_embeds" in batch:
        tag += f" src{batch['src_embeds'].shape[1]}"
    if "extra_embeds" in batch:
        tag += f" img{batch['extra_embeds'].shape[1]}"
    return tag


def prefill_executable(eng: ServeEngine, model, params, batch: Dict,
                       cache) -> Callable:
    """The prefill step for ``batch``'s shapes, built and warmed once per
    engine (eager on both devices)."""
    key = eng.executable_key(model.cfg.name, "prefill", _prefill_tag(batch))
    return eng.executable(key, lambda: _warmed(
        make_prefill_step(model), params, batch, cache))


def decode_executable(eng: ServeEngine, model, params, token: torch.Tensor,
                      cache, pos) -> Callable:
    """The one-token decode step for ``token``'s batch, built once per
    engine: on the card a :class:`DecodeGraph` captured on ``cache`` (a
    later generation's cache of the same shapes is copied into it), on the
    CPU the eager step warmed on a copy of ``cache``."""
    key = eng.executable_key(model.cfg.name, "decode", f"b{token.shape[0]}")
    step = make_decode_step(model)

    def build():
        if eng.device.type != "cuda":
            return _warmed(step, params, token,
                           tree_map(torch.clone, cache), pos)
        # the prefill's freed transients stay cached in the main pool,
        # which the capture's private pool cannot draw on: hand them back
        # first (a large model's readout cast can need GiBs there)
        torch.cuda.empty_cache()
        g = DecodeGraph(step, params, token, cache, pos, eng.graph_pool(),
                        key)
        eng.record_capture(key, g)
        return g

    return eng.executable(key, build)


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
    finite).  The position lives on the device and the argmax token stays
    there: each step writes both into the step's buffers and runs it (on
    the card, a replay), with no sync until the end."""
    tokens = []
    finite = torch.ones((), dtype=torch.bool, device=device)
    pos = torch.full((), pos0, dtype=torch.long, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = decode(params, token, cache, pos)
        finite &= torch.isfinite(logits).all()
        token = logits.argmax(-1)
        tokens.append(token)
        pos += 1
    _sync(device)
    return tokens, cache, time.perf_counter() - t0, bool(finite)


class MeshStep:
    """A prefill or decode step on a mesh: its batch inputs placed by
    ``batch_pspec``, run eagerly under ``activate_mesh`` and
    ``torch.no_grad``; the logits come back whole on every rank, gathered
    by c10d calls (``sharding.gather_local``), which also run between
    ranks sharing a card over gloo."""

    def __init__(self, step: Callable, mesh):
        self.step, self.mesh = step, mesh

    def _place(self, t):
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.distributed import activate_mesh, batch_pspec
        from repro_torch.distributed.sharding import to_placements
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        with activate_mesh(self.mesh) as ctx:
            spec = batch_pspec({"t": t}, ctx)["t"]
        return distribute_tensor(t, self.mesh, to_placements(spec, self.mesh),
                                 src_data_rank=None)

    def __call__(self, params, inputs, cache, *rest):
        from repro_torch.distributed import activate_mesh
        if isinstance(inputs, dict):
            inputs = {k: self._place(v) for k, v in inputs.items()}
        else:
            inputs = self._place(inputs)
        from repro_torch.distributed.sharding import (gather_local,
                                                      mesh_axis_names)
        with activate_mesh(self.mesh), torch.no_grad():
            logits, cache = self.step(params, inputs, cache, *rest)
        return gather_local(logits, mesh_axis_names(self.mesh)), cache


def _place_on_mesh(model, params, cache, mesh):
    """(params, cache) as DTensors on ``mesh`` by ``serve_shardings``."""
    from repro_torch.distributed import place_state, serve_shardings
    pspec, cspec = serve_shardings(model, cache, mesh)
    return place_state(params, pspec, mesh), place_state(cache, cspec, mesh)


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
    mesh, log = None, print
    if "WORLD_SIZE" in os.environ:
        join_process_group(dev)
        try:
            mesh = make_host_mesh(model=args.tp, device=dev.type)
        except ValueError as e:
            torch.distributed.destroy_process_group()
            ap.error(f"--tp {args.tp}: {e}")
        if torch.distributed.get_rank() != 0:
            log = lambda *a, **k: None    # noqa: E731  (rank 0 prints)
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
    if cfg.family == "encdec":
        src = rng.normal(size=(args.batch, args.prompt_len, cfg.d_model))
        cache = model.init_cache(args.batch, max_len,
                                 cross_len=args.prompt_len, dtype=cfg.dtype,
                                 device=dev)
        batch0 = {"src_embeds": torch.as_tensor(src, dtype=cfg.dtype,
                                                device=dev),
                  "tokens": torch.zeros((args.batch, 1), dtype=torch.long,
                                        device=dev)}
        pos0 = 1
    else:
        cache = model.init_cache(args.batch, max_len, dtype=cfg.dtype,
                                 device=dev)
        batch0 = {"tokens": torch.as_tensor(prompts, device=dev)}
        pos0 = args.prompt_len
    if mesh is None:
        prefill = prefill_executable(eng, model, params, batch0, cache)
    else:
        params, cache = _place_on_mesh(model, params, cache, mesh)
        prefill = MeshStep(make_prefill_step(model), mesh)
    logits, cache, prefill_s = run_prefill(prefill, params, batch0, cache, dev)
    finite = bool(torch.isfinite(logits).all())
    tok = logits.argmax(-1)
    out_tokens = [tok]
    decode_s = 0.0
    if args.gen > 1:
        decode = (decode_executable(eng, model, params, tok, cache, pos0)
                  if mesh is None else MeshStep(make_decode_step(model),
                                                mesh))
        toks, cache, decode_s, dec_finite = run_decode(
            decode, params, tok, cache, pos0, args.gen - 1, dev)
        out_tokens += toks
        finite = finite and dec_finite
    gen = torch.stack(out_tokens, 1).cpu().numpy()
    decode_tps = args.batch * (args.gen - 1) / max(decode_s, 1e-9)
    where = "" if mesh is None else (
        f" (mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))})")
    log(f"[serve] {cfg.name} ({str(cfg.dtype).replace('torch.', '')}) on "
        f"{dev}{where}: generated {gen.shape} tokens; prefill "
        f"{prefill_s * 1e3:.1f} ms (batch {args.batch}, prompt "
        f"{args.prompt_len}); decode {decode_tps:.1f} tok/s over "
        f"{args.gen - 1} steps (batch {args.batch})")
    log("[serve] sample:", gen[0][:16].tolist())
    if not finite:
        print("[serve] FAILED: non-finite logits", file=sys.stderr)
        sys.exit(1)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
