"""Layer stacks: periodic layer schedules run period by period (port of
the LM part of ``repro/nn/blocks.py``).

An architecture is a *periodic* schedule of slots (mixer, ffn) repeated
``n_periods`` times: a dense transformer is period 1, (attn, mlp); mamba2
period 1, (mamba, none); llama4 period 2, (attn, mlp), (attn, moe);
arctic period 1, (attn, moe) with a dense residual; jamba period 8, attn
at slot 4 and mamba elsewhere, moe on the odd slots; the seamless encoder
period 1, (attn, mlp) non-causal (``StackSpec.causal``), and its decoder
period 1, (attn + cross-attn, mlp).  As in the JAX
package, each slot's params and caches are stacked over periods on a
leading axis, so the JAX trees carry across as they are; where JAX runs
the stack with ``lax.scan``, the port loops over periods in Python.  Each
slot's cache is its mixer's kind, under JAX's key: ``kv`` (``kv_seq``,
``kv_seq2`` where the decode KV cache is sequence-sharded) or ``mamba``,
and a cross-attention slot's ``cross_kv`` beside its ``kv``.  KV caches
are written in place (see ``nn/attention.py``), and so is the cross-KV,
by the prefill; the decode reads it and never recomputes it.  Mamba
caches are written in place in decode; the prefill's Mamba caches are
stacked anew on one device and written in place on a mesh.  Every MoE
slot's aux loss is summed over the stack.

``StackSpec.remat`` is JAX's ``jax.checkpoint`` of each period
(:func:`remat_period`): "full" saves nothing of a period and recomputes it
in the backward; "dots" saves the outputs of the products that have no
batch dims (the projections: ``aten.mm`` / ``aten.addmm``, as JAX's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest, the
batched products and the kernels' Functions included.  Values and
gradients are those of "none", bit for bit; only what the backward keeps
changes.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.engine.policy import ExecutionPolicy
from repro_torch.nn.attention import (AttnLayout, KVCache, attention,
                                      init_attention, init_kv_cache,
                                      make_cross_kv)
from repro_torch.nn.layers import (Params, init_layernorm, init_mlp,
                                   init_rmsnorm, layernorm, mlp, rmsnorm,
                                   rope_angles)
from repro_torch.nn.mamba import (MambaCache, MambaDims, init_mamba,
                                  init_mamba_cache, mamba_mixer)
from repro_torch.nn.moe import init_moe, moe


@dataclass(frozen=True)
class SlotSpec:
    mixer: str                 # "attn" | "mamba" | "none"
    ffn: str                   # "mlp" | "moe" | "none"
    cross_attn: bool = False   # decoder slot with encoder cross-attention


#: What the backward keeps of a period: all of it, the outputs of the
#: products without batch dims, or nothing (JAX's ``StackSpec.remat``).
REMAT_MODES = ("none", "dots", "full")
#: The products "dots" saves: the 2-D products the projections lower to
#: (``x @ w`` of ``nn/layers.py:dense`` is view -> mm -> view; F.linear
#: with a bias is addmm).  Batched products (bmm, the attention and MoE
#: einsums) have batch dims and are recomputed, as JAX's policy does.
SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_period(fn, remat: str):
    """``fn`` wrapped in the checkpoint ``remat`` asks for ("dots",
    "full"), or ``fn`` itself ("none").  No period draws random numbers,
    so the RNG state is not saved (``preserve_rng_state=False``: reading
    it would also break a CUDA-graph capture)."""
    if remat == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, **kw)


@dataclass(frozen=True)
class StackSpec:
    slots: Tuple[SlotSpec, ...]
    n_periods: int
    d_model: int
    d_ff: int = 0
    mlp_kind: str = "swiglu"
    norm: str = "rmsnorm"
    layout: Optional[AttnLayout] = None
    rope_theta: float = 1e4
    causal: bool = True                       # False: the encdec encoder
    dims: Optional[MambaDims] = None          # mamba dims (ssm, hybrid)
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    dense_residual: bool = False
    dense_ff: Optional[int] = None
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"                  # einsum | gather
    remat: str = "none"                       # none | dots | full
    chunk_k: int = 1024
    block_causal: bool = False
    kv_seqshard: str = ""                     # "" | "model" | "2d"
    ssd_bf16: bool = False                    # bf16 SSD quadratic term
    #: how the kernels run (the conv1d's and the attention core's substrate)
    policy: ExecutionPolicy = field(default_factory=ExecutionPolicy)

    def __post_init__(self):
        for slot in self.slots:
            if slot.mixer not in ("attn", "mamba", "none"):
                raise ValueError(f"mixer {slot.mixer!r}")
            if slot.ffn not in ("mlp", "moe", "none"):
                raise ValueError(f"ffn {slot.ffn!r}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat {self.remat!r} not in {REMAT_MODES}")
        _norm_fns(self.norm)

    @property
    def kv_key(self) -> str:
        """The attention slots' cache key, as the JAX package names it."""
        return {"": "kv", "model": "kv_seq", "2d": "kv_seq2"}[
            self.kv_seqshard]

    @property
    def n_layers(self) -> int:
        return len(self.slots) * self.n_periods


def _norm_fns(kind: str):
    if kind == "rmsnorm":
        return init_rmsnorm, rmsnorm
    if kind == "layernorm":
        return init_layernorm, layernorm
    raise ValueError(kind)


def _init_slot(gen, spec: StackSpec, slot: SlotSpec, dtype, device) -> Params:
    init_norm, _ = _norm_fns(spec.norm)
    p: Params = {}
    if slot.mixer == "attn":
        lay = spec.layout
        p["norm_mixer"] = init_norm(spec.d_model, dtype, device)
        p["attn"] = init_attention(gen, spec.d_model, lay.n_q, lay.n_kv,
                                   lay.head_dim, dtype, device)
        if slot.cross_attn:
            p["norm_cross"] = init_norm(spec.d_model, dtype, device)
            p["cross"] = init_attention(gen, spec.d_model, lay.n_q,
                                        lay.n_kv, lay.head_dim, dtype,
                                        device)
    elif slot.mixer == "mamba":
        p["norm_mixer"] = init_norm(spec.d_model, dtype, device)
        p["mamba"] = init_mamba(gen, spec.dims, dtype, device)
    if slot.ffn == "mlp":
        p["norm_ffn"] = init_norm(spec.d_model, dtype, device)
        p["mlp"] = init_mlp(gen, spec.d_model, spec.d_ff, spec.mlp_kind,
                            dtype, device)
    elif slot.ffn == "moe":
        p["norm_ffn"] = init_norm(spec.d_model, dtype, device)
        p["moe"] = init_moe(gen, spec.d_model, spec.d_ff, spec.n_experts,
                            mlp_kind=spec.mlp_kind,
                            shared_expert=spec.shared_expert,
                            dense_residual=spec.dense_residual,
                            dense_ff=spec.dense_ff, dtype=dtype,
                            device=device)
    return p


def init_stack(gen: torch.Generator, spec: StackSpec, dtype=torch.float32,
               device="cpu") -> Params:
    """Stacked params: {"slot<i>": tree with a leading n_periods axis}.

    Each stacked leaf is allocated once and filled period by period, the
    generator drawn period-major and in leaf order within a period, so the
    params are held once (plus one period's) and not twice, as a stack of
    per-period trees would hold them."""
    out: Params = {}
    for i, slot in enumerate(spec.slots):
        stacked = None
        for n in range(spec.n_periods):
            per = _init_slot(gen, spec, slot, dtype, device)
            if stacked is None:
                stacked = tree_map(lambda t: torch.empty(
                    (spec.n_periods,) + t.shape, dtype=t.dtype,
                    device=t.device), per)
            for dst, src in zip(tree_leaves(stacked), tree_leaves(per)):
                dst[n].copy_(src)
            del per
        out[f"slot{i}"] = stacked
    return out


def init_stack_cache(spec: StackSpec, batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cpu",
                     cross_len: int = 0) -> Params:
    """Decode caches, stacked over periods per slot: a KV cache of
    ``max_len`` positions per attention slot (under ``spec.kv_key``; the
    sequence-sharded cache holds the n_kv heads unrepeated, which at
    ``tp == 1`` is the plain cache), beside it on a cross-attention slot
    ``cross_kv``, a (k, v) tuple of (n_periods, batch, cross_len, kv_eff,
    D) that the prefill fills; a Mamba cache per mamba slot; slots
    without state get empty dicts."""
    cache: Params = {}
    for i, slot in enumerate(spec.slots):
        if slot.mixer == "attn":
            kv = init_kv_cache(batch, max_len, spec.layout, dtype, device,
                               seqshard=bool(spec.kv_seqshard))
            cache[f"slot{i}"] = {spec.kv_key: KVCache(*(
                t[None].expand((spec.n_periods,) + t.shape).clone()
                for t in kv))}
            if slot.cross_attn:
                lay = spec.layout
                shape = (spec.n_periods, batch, cross_len, lay.kv_eff,
                         lay.head_dim)
                cache[f"slot{i}"]["cross_kv"] = tuple(
                    torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(2))
        elif slot.mixer == "mamba":
            mc = init_mamba_cache(batch, spec.dims, dtype, device)
            cache[f"slot{i}"] = {"mamba": MambaCache(*(
                t[None].expand((spec.n_periods,) + t.shape).clone()
                for t in mc))}
        else:
            cache[f"slot{i}"] = {}
    return cache


def _run_slot(p: Params, x: torch.Tensor, spec: StackSpec, slot: SlotSpec, *,
              mode: str, positions, rope, cache_pos, kv_length,
              cache: Optional[Dict[str, Any]],
              enc_out: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
    """One slot: (x, its new cache, its aux loss: a 0-d tensor on a MoE
    slot, else the float 0.0, so that a stack without MoE adds no op).

    A cross-attention slot takes the cached cross-KV where the cache has
    one and no ``enc_out`` is given (decode), else lays it out from
    ``enc_out``, and then, with a cache, writes it into the cache's
    ``cross_kv`` in place (prefill).  The cross call gets neither the
    self-attention's RoPE nor its ``kv_length``."""
    _, norm = _norm_fns(spec.norm)
    new_cache: Dict[str, Any] = {}
    aux = 0.0
    if slot.mixer == "attn":
        key = spec.kv_key
        kv = cache.get(key) if cache else None
        h, nkv = attention(p["attn"], norm(p["norm_mixer"], x), spec.layout,
                           positions=positions, rope_theta=spec.rope_theta,
                           causal=spec.causal, mode=mode, cache=kv,
                           cache_pos=cache_pos, kv_length=kv_length,
                           chunk_k=spec.chunk_k,
                           block_causal=spec.block_causal,
                           kv_seqshard=spec.kv_seqshard, rope=rope,
                           policy=spec.policy)
        x = x + h
        if nkv is not None:
            new_cache[key] = nkv
        elif cache and key in cache:
            new_cache[key] = cache[key]
        if slot.cross_attn:
            cached = cache.get("cross_kv") if cache else None
            if cached is not None and enc_out is None:
                ckv = cached
            else:
                ckv = make_cross_kv(p["cross"], enc_out, spec.layout)
                if cached is not None:
                    for dst, src in zip(cached, ckv):
                        dst.copy_(src)
            h, _ = attention(p["cross"], norm(p["norm_cross"], x),
                             spec.layout, positions=positions, mode="train",
                             causal=False, cross_kv=ckv,
                             chunk_k=spec.chunk_k, policy=spec.policy)
            x = x + h
            if cached is not None:
                new_cache["cross_kv"] = cached
    elif slot.mixer == "mamba":
        mc = cache.get("mamba") if cache else None
        h, nmc = mamba_mixer(
            p["mamba"], norm(p["norm_mixer"], x), spec.dims, mode=mode,
            cache=mc, policy=spec.policy,
            score_dtype=torch.bfloat16 if spec.ssd_bf16 else torch.float32)
        x = x + h
        if nmc is not None:
            new_cache["mamba"] = nmc
        elif cache and "mamba" in cache:
            new_cache["mamba"] = cache["mamba"]
    if slot.ffn == "mlp":
        x = x + mlp(p["mlp"], norm(p["norm_ffn"], x), spec.mlp_kind)
    elif slot.ffn == "moe":
        h, a = moe(p["moe"], norm(p["norm_ffn"], x), top_k=spec.top_k,
                   mlp_kind=spec.mlp_kind,
                   capacity_factor=spec.capacity_factor, impl=spec.moe_impl)
        x = x + h
        aux = aux + a
    return x, new_cache, aux


def run_stack(params: Params, x: torch.Tensor, spec: StackSpec, *,
              mode: str = "train", positions: Optional[torch.Tensor] = None,
              cache: Optional[Params] = None, cache_pos=None,
              kv_length: Optional[torch.Tensor] = None,
              enc_out: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Run the full stack. Returns (x, new cache or None, the sum of every
    MoE slot's aux loss: a 0-d fp32 tensor, 0 without MoE slots).

    mode: "train" or "encoder" (no cache), "prefill", "decode".
    ``enc_out`` (B, S_src, d_model), the encoder's output, feeds the
    cross-attention slots where given (train, prefill).  ``positions`` (B, S)
    default to ``arange(S)`` in every row; their RoPE angles are computed
    once for all layers.  The KV caches of the cache
    given are written in place and returned as they are; in decode so are
    the Mamba caches, and the cache given is returned itself (a captured
    decode step replays on the same buffers); the prefill's Mamba caches
    are stacked anew on one device, leaving the given ones untouched (on
    a mesh written into them), and its cross-KV is written into the
    given ``cross_kv`` and returned as it is.
    """
    on_mesh = is_dtensor(x)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None]
        if not on_mesh:   # on a mesh the one row broadcasts
            positions = positions.expand(x.shape[:2])
    rope = (rope_angles(positions, spec.layout.head_dim, spec.rope_theta)
            if spec.layout is not None else None)
    # each stacked leaf unbound once: in training its gradient is then one
    # stack of the periods' gradients, where a slice per period would
    # add a zero-filled leaf-sized gradient per period
    per_period = list(zip(*(leaf.unbind(0) for leaf in tree_leaves(params))))

    def period(x, p_i, c_i):
        nc = {}
        aux_i = 0.0
        for j, slot in enumerate(spec.slots):
            x, nc[f"slot{j}"], a = _run_slot(
                p_i[f"slot{j}"], x, spec, slot, mode=mode,
                positions=positions, rope=rope, cache_pos=cache_pos,
                kv_length=kv_length,
                cache=c_i[f"slot{j}"] if c_i is not None else None,
                enc_out=enc_out)
            aux_i = aux_i + a
        return x, nc, aux_i

    # remat only where the backward would keep the period's activations:
    # a graph is built, and no cache is written in place (a recompute
    # would write it again); decode and no-grad runs are untouched
    if (cache is None and torch.is_grad_enabled()
            and not torch.is_inference_mode_enabled()):
        period = remat_period(period, spec.remat)
    new_caches = []
    aux = 0.0
    for i in range(spec.n_periods):
        p_i = tree_unflatten(params, per_period[i])
        c_i = tree_map(lambda c: c[i], cache) if cache is not None else None
        x, nc, aux_i = period(x, p_i, c_i)
        aux = aux + aux_i  # per period, then over periods, as JAX's scan
        new_caches.append(nc)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if on_mesh:
            from torch.distributed.tensor import DTensor, Replicate
            aux = DTensor.from_local(
                aux, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                run_check=False)
    if cache is None:
        return x, None, aux
    if mode == "decode":  # every cache was written in place
        return x, cache, aux
    # on a mesh the Mamba prefill writes the given caches' shards too
    in_place = (spec.kv_key, "cross_kv") + (("mamba",) if on_mesh else ())
    return x, {slot: {key: (val if key in in_place else tree_map(
        lambda *cs: torch.stack(cs), *[nc[slot][key] for nc in new_caches]))
        for key, val in c.items()} for slot, c in cache.items()}, aux
