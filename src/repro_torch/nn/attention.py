"""Attention: GQA/MQA/MHA self-attention with RoPE, cross-attention into
an encoder's output, a streaming-softmax core for train and prefill, and
KV-cached decode (port of ``repro/nn/attention.py``).

TP head layout (:func:`attn_layout`), the JAX package's: on a ``tp``-way
model axis KV heads are repeated r = tp / n_kv times and the q groups
zero-padded from G = n_q / n_kv to G_pad = ceil(G / r) r, so that both
head axes divide the model axis; the padded q heads are sliced off before
``o_proj``.  The params do not depend on ``tp``.  At ``tp == 1`` the
layout is a view.

The core is ``kernels.ops.flash_attention``: the hand-written flash
kernel on a CUDA tensor, its plain version (``nn/attention.py:
flash_attention`` line for line) on the CPU or under the oracle policy.
It reads q as the (B, S, kv_eff, G', D) view of the q projection and k/v
as (B, S, kv_eff, D), so the G' q heads of a KV head share its K/V.

The KV cache is written in place, where the JAX package's
``dynamic_update_slice`` returns a new cache: prefill writes rows
[0, S), decode writes row ``cache_pos``, into the tensors of the
:class:`KVCache` it is given, and returns that same cache.  The serving
loop never reads an old cache again, and copying a full-width cache (1.35
GB for granite-3-2b at batch 4 x 4128) on every decode step would cost
more HBM traffic than the step's attention reads.  A caller that needs
the old cache clones it first.

The sequence-sharded decode (``kv_seqshard``, ``nn/decode_attn.py``)
keeps the cache unrepeated, (B, S, n_kv, D), with q grouped by the
unpadded G.  On one device it is the same math over the whole cache:
write the new K and V at ``pos``, then attend under ``kv_length``
(default ``pos + 1``), kernel 5's split decode on the card.  Under a mesh
whose sequence axis has more than one rank it is
:func:`repro_torch.nn.decode_attn.seqshard_flash_decode`'s multi-rank arm.

Under a mesh (``x`` a DTensor) the same body runs: the projections are
DTensor products on their sharded weights, ``shard()`` constrains the
activations at the JAX package's points (a no-op on one device), and the
core (:func:`_core`) runs through ``local_map`` on each rank's local
heads, where on one device it runs on every head.

Cross-attention (the encdec decoder): ``cross_kv`` is the (k, v) pair
:func:`make_cross_kv` lays out from the encoder's output, (B, S_src,
kv_eff, D) each.  The layer then projects only q, applies no RoPE, writes
no cache and attends over every source key, never causally and under no
``kv_length``, in every mode, as ``repro/nn/attention.py:223-233, 279``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (axis_rank, is_dtensor,
                                              row_placements, shard)
from repro_torch.engine.policy import ExecutionPolicy
from repro_torch.kernels.ops import flash_attention
from repro_torch.nn.layers import (Params, apply_rope, dense, init_dense,
                                   rope_angles)


class AttnLayout(NamedTuple):
    n_q: int          # logical q heads
    n_kv: int         # logical kv heads
    head_dim: int
    kv_repeat: int    # r
    g_pad: int        # padded group size (q heads per logical kv head)

    @property
    def kv_eff(self) -> int:
        return self.n_kv * self.kv_repeat

    @property
    def g_eff(self) -> int:
        return self.g_pad // self.kv_repeat

    @property
    def n_q_pad(self) -> int:
        return self.n_kv * self.g_pad


def attn_layout(n_q: int, n_kv: int, head_dim: int, tp: int = 1
                ) -> AttnLayout:
    """The head layout on a ``tp``-way model axis: KV heads repeated
    r = tp / n_kv times where tp > n_kv divides by n_kv, q groups padded
    to a multiple of r."""
    if n_q % n_kv:
        raise ValueError(f"n_q {n_q} is not a multiple of n_kv {n_kv}")
    g = n_q // n_kv
    r = tp // n_kv if (tp > n_kv and tp % n_kv == 0) else 1
    g_pad = -(-g // r) * r    # r divides g_pad by construction
    return AttnLayout(n_q, n_kv, head_dim, r, g_pad)


# -- params -------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_q: int, n_kv: int,
                   head_dim: int, dtype=torch.float32, device="cpu") -> Params:
    return {
        "q_proj": init_dense(gen, d_model, n_q * head_dim, dtype=dtype,
                             device=device),
        "k_proj": init_dense(gen, d_model, n_kv * head_dim, dtype=dtype,
                             device=device),
        "v_proj": init_dense(gen, d_model, n_kv * head_dim, dtype=dtype,
                             device=device),
        "o_proj": init_dense(gen, n_q * head_dim, d_model,
                             std=(n_q * head_dim) ** -0.5, dtype=dtype,
                             device=device),
    }


# -- head layout --------------------------------------------------------------

def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n d) -> (..., n, d).  On a mesh, a last dim cut over more
    ranks than divide the n heads is gathered on those mesh dims first
    (``REPLICATED_OPS["attention_split_heads"]``): DTensor cuts a head
    dim only evenly."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        from repro_torch.distributed.sharding import REPLICATED_OPS
        mesh, last = x.device_mesh, x.dim() - 1
        pl = [Replicate() if p.is_shard(last) and n % mesh.size(i) else p
              for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            REPLICATED_OPS["attention_split_heads"] += 1
            x = x.redistribute(mesh, pl)
    return x.reshape(x.shape[:-1] + (n, d))


def _layout_q(q: torch.Tensor, lay: AttnLayout) -> torch.Tensor:
    """(B,S,n_q,D) -> (B,S,kv_eff,G',D) with group-preserving zero
    padding: a view where nothing is padded (``tp == 1``)."""
    B, S, _, D = q.shape
    g = lay.n_q // lay.n_kv
    if lay.g_pad != g:
        q = torch.nn.functional.pad(q.reshape(B, S, lay.n_kv, g, D),
                                    (0, 0, 0, lay.g_pad - g))
    return q.reshape(B, S, lay.kv_eff, lay.g_eff, D)


def _unlayout_o(o: torch.Tensor, lay: AttnLayout) -> torch.Tensor:
    """(B,S,kv_eff,G',D) -> (B,S,n_q*D), dropping the padded heads."""
    B, S = o.shape[:2]
    g = lay.n_q // lay.n_kv
    if lay.g_pad != g:
        o = o.reshape(B, S, lay.n_kv, lay.g_pad, o.shape[-1])[:, :, :, :g]
    return o.reshape(B, S, lay.n_q * o.shape[-1])


def _seqshard_mode(kv_seqshard) -> str:
    return ("model" if kv_seqshard is True else kv_seqshard) or ""


def _repeat_kv(kv: torch.Tensor, r: int) -> torch.Tensor:
    if r == 1:
        return kv
    return torch.repeat_interleave(kv, r, dim=2)


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S_max, kv_eff, D), or (B, S_max, n_kv, D)
    v: torch.Tensor      # when sequence-sharded (unrepeated heads)


def init_kv_cache(batch: int, max_len: int, lay: AttnLayout,
                  dtype=torch.bfloat16, device="cpu",
                  seqshard: bool = False) -> KVCache:
    """Zeros of (batch, max_len, kv_eff, D), or n_kv heads (unrepeated)
    for the sequence-sharded decode."""
    heads = lay.n_kv if seqshard else lay.kv_eff
    shape = (batch, max_len, heads, lay.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# -- full layer ---------------------------------------------------------------

def attention(params: Params, x: torch.Tensor, lay: AttnLayout, *,
              positions: torch.Tensor, rope_theta: float = 10000.0,
              causal: bool = True, mode: str = "train",
              cache: Optional[KVCache] = None, cache_pos=None,
              kv_length: Optional[torch.Tensor] = None,
              cross_kv=None, chunk_k: int = 1024, block_causal: bool = False,
              kv_seqshard=False,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              policy: Optional[ExecutionPolicy] = None,
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self- or cross-attention over x (B, S, d_model).

    mode: "train" or "encoder" (no cache), "prefill" (writes the cache's
    rows [0, S) in place), "decode" (S == 1: writes row ``cache_pos`` in
    place, then attends over the whole cache under ``kv_length``, by
    default ``cache_pos + 1`` for every row; ``cache_pos`` a 0-d integer
    tensor on the device, or an int made one, places the write with
    ``index_copy_`` and the default ``kv_length`` on the device).
    ``kv_seqshard`` ("model", "2d" or True) is the sequence-sharded
    decode: on one device the same path over the same unrepeated cache.
    ``rope``, where given, is ``rope_angles(positions, head_dim,
    rope_theta)`` computed by the caller once for every layer.
    ``cross_kv`` (k, v), each (B, S_src, kv_eff, D), makes it
    cross-attention: no k/v projection, no RoPE, no cache and no mask,
    whatever the mode.  ``policy`` picks the flash kernel or its plain
    version.  Returns (out (B, S, d_model), the cache or None).

    One body for one device and a mesh: ``shard()`` is a no-op on a plain
    tensor, and the core (:func:`_core`) runs on every head here and on
    each rank's heads through ``local_map`` under a mesh
    (:func:`_core_on_mesh`).
    """
    cross = cross_kv is not None
    if not cross and mode == "decode" and (cache is None
                                           or cache_pos is None):
        raise ValueError("decode needs a cache and cache_pos")
    if not cross and mode == "prefill" and cache is None:
        raise ValueError("prefill needs a cache")
    B, S, _ = x.shape
    D = lay.head_dim
    seq = _seqshard_mode(kv_seqshard)
    q = _split_heads(dense(params["q_proj"], x), lay.n_q, D)
    q = shard(q, "batch", "seq", "heads", None)
    if cross:
        k_raw, v_raw = cross_kv
    else:
        # cut as q is (under FSDP the projection's rows may come out whole)
        k_raw = shard(_split_heads(dense(params["k_proj"], x), lay.n_kv, D),
                      "batch", "seq", "kv_heads", None)
        v_raw = shard(_split_heads(dense(params["v_proj"], x), lay.n_kv, D),
                      "batch", "seq", "kv_heads", None)
        cos, sin = rope if rope is not None else rope_angles(
            positions.to_local() if is_dtensor(positions) else positions, D,
            rope_theta)
        q, k_raw = _rope(q, k_raw, cos, sin, x)
    kv_length = _batch_local(kv_length, x)
    if not cross and mode == "decode" and seq:
        from repro_torch.nn.decode_attn import seqshard_flash_decode
        o, kc, vc = seqshard_flash_decode(
            q, cache.k, cache.v, k_raw, v_raw, cache_pos,
            kv_length=kv_length, axes=_seq_axes(seq), chunk_k=chunk_k,
            policy=policy)
        out = dense(params["o_proj"], o.reshape(B, S, lay.n_q * D))
        return shard(out, "batch", "seq", "embed"), KVCache(kc, vc)
    ck = cv = None
    if not cross and mode == "prefill" and seq:
        from repro_torch.nn.decode_attn import seqshard_prefill_write
        seqshard_prefill_write(cache, k_raw, v_raw, _seq_axes(seq))
    elif not cross and cache is not None:
        ck, cv = cache.k, cache.v
    kw = dict(lay=lay, mode=mode, cross=cross, causal=causal,
              chunk_k=chunk_k, block_causal=block_causal, policy=policy)
    if is_dtensor(q):
        o = _core_on_mesh(q, k_raw, v_raw, ck, cv, cache_pos, kv_length,
                          **kw)
    else:
        o = _unlayout_o(_core(q, k_raw, v_raw, ck, cv, cache_pos, kv_length,
                              lo=0, n=lay.kv_eff, q_local=False,
                              kv_local=False, **kw), lay)
    o = shard(o, "batch", "seq", "qkv_dim")
    out = shard(dense(params["o_proj"], o), "batch", "seq", "embed")
    new_cache = cache if mode in ("prefill", "decode") and not cross \
        else None
    return out, new_cache


def _seq_axes(seq: str) -> Tuple[str, ...]:
    return ("data", "model") if seq == "2d" else ("model",)


def _core(q, k, v, ck, cv, pos, length, *, lay: AttnLayout, mode: str,
          lo: int, n: int, q_local: bool, kv_local: bool, cross: bool,
          causal: bool, chunk_k: int, block_causal: bool, policy):
    """The attention core on KV heads [lo, lo + n) of the layout (every
    head on one device: lo 0, n kv_eff), each with its G' q heads.

    q (B, S, n_q, D), or with ``q_local`` the block's own n G' q heads;
    k/v (B, S, n_kv, D) unrepeated, repeated here, or with ``kv_local``
    the block's n heads (cross-attention: already laid out, (B, S_src,
    kv_eff, D) or the block's).  The cache ``ck``/``cv`` (the block's
    heads), where given, is written in place: prefill rows [0, S), decode
    the rows at ``pos`` (attending over the whole cache under ``length``,
    default pos + 1).  Cross-attention attends over every source key,
    unmasked.  Returns o (B, S, n, G', D)."""
    B, S = q.shape[:2]
    if q_local:
        q = q.reshape(B, S, n, lay.g_eff, lay.head_dim)
    else:
        q = _layout_q(q, lay)[:, :, lo:lo + n]
    if not kv_local:
        if not cross:
            k = _repeat_kv(k, lay.kv_repeat)
            v = _repeat_kv(v, lay.kv_repeat)
        k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    if cross:
        return flash_attention(q, k, v, causal=False, chunk_k=chunk_k,
                               policy=policy)
    if mode == "decode":
        # the write lands where the position tensor says, on the device:
        # a captured step replays it at each new position
        p = torch.as_tensor(pos, device=q.device).to(torch.long)
        rows = p + torch.arange(S, device=q.device)
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        if length is None:
            length = (p + 1).to(torch.int32).expand(B)
        return flash_attention(q, ck, cv, causal=False, kv_length=length,
                               chunk_k=chunk_k, policy=policy)
    if mode == "prefill" and ck is not None:
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
    return flash_attention(q, k, v, causal=causal, kv_length=length,
                           chunk_k=chunk_k, block_causal=block_causal,
                           policy=policy)


# -- under a mesh -------------------------------------------------------------

def _batch_local(t, like):
    """Under a mesh (``like`` a DTensor), a plain per-row tensor (B, ...)
    as a DTensor sharded over the batch as ``like``; a 1-row tensor
    (broadcast over the batch), None, and anything on one device pass
    through."""
    if (t is None or not is_dtensor(like) or is_dtensor(t) or t.dim() == 0
            or t.shape[0] == 1):
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, like.device_mesh, row_placements(like),
                             src_data_rank=None)


def _rope(q, k, cos, sin, like):
    """RoPE on q and k; under a mesh through ``local_map``, on each rank's
    rows and heads: both cut over the batch as q is (k's projection may
    come out with its rows whole, as from a weight cut over the data
    axes under FSDP), their head shards kept, anything else gathered."""
    if not is_dtensor(q):
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def rows_heads(t):
        return [Shard(0) if pq.is_shard(0) else
                (p if p.is_shard(2) else Replicate())
                for p, pq in zip(t.placements, q.placements)]

    def fn(ql, kl, c, s):
        return apply_rope(ql, c, s), apply_rope(kl, c, s)
    cos, sin = _batch_local(cos, like), _batch_local(sin, like)
    pq, pk = rows_heads(q), rows_heads(k)
    return local_map(fn, out_placements=(pq, pk),
                     in_placements=(pq, pk, _pl(cos, q), _pl(sin, q)),
                     redistribute_inputs=True)(q, k, cos, sin)


def _core_on_mesh(q, k_raw, v_raw, ck, cv, cache_pos, kv_length, *,
                  lay: AttnLayout, mode, cross, causal, chunk_k,
                  block_causal, policy):
    """:func:`_core` on each rank's local heads, through ``local_map``.

    The KV heads of the layout (kv_eff, q grouped G' to each) are cut into
    equal blocks over the "model" axis, one block a rank.  q arrives
    sharded on its heads where the layout is a plain reshape that keeps
    each rank's q heads beside its KV heads (no padding, kv_eff divisible
    by the axis); k/v arrive sharded where they are unrepeated and n_kv
    divides by the axis (cross-attention's, laid out, wherever kv_eff
    does).  Otherwise the operand is gathered over "model" and each rank
    takes its block after the layout (counted in
    ``REPLICATED_OPS["attention_q_gather"]``, ``["attention_kv_gather"]``);
    where kv_eff does not divide by the axis every rank runs every head
    (``["attention_heads"]``).  The output comes back sharded on its
    heads, unlaid to (B, S, n_q D) on the mesh
    (``REPLICATED_OPS["attention_unpad"]`` where padded heads are
    dropped).  The cache, written in place on each rank's shard, must be
    held as the heads are cut (``cache_pspec``'s kv_heads on "model")."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed.sharding import (REPLICATED_OPS,
                                                  replicated_call)
    mi, m = axis_rank(q.device_mesh, "model")
    g = lay.n_q // lay.n_kv
    split = lay.kv_eff % m == 0
    if not split:
        REPLICATED_OPS["attention_heads"] += 1
    q_local = split and lay.g_pad == g
    kv_local = split and (cross or lay.kv_repeat == 1)
    if m > 1 and split and not q_local:   # padded groups: q gathered
        REPLICATED_OPS["attention_q_gather"] += 1
    if m > 1 and split and not kv_local:  # repeated KV heads
        REPLICATED_OPS["attention_kv_gather"] += 1
    n = lay.kv_eff // m if split else lay.kv_eff
    lo = mi * n if split else 0
    pq = row_placements(q, 2 if q_local else None)
    pkv = row_placements(q, 2 if kv_local else None)
    pc = row_placements(q, 2 if split else None)
    if ck is not None and tuple(ck.placements) != tuple(pc):
        raise ValueError(f"the KV cache's placements {ck.placements} "
                         f"are not the heads' {pc}")
    core = functools.partial(_core, lay=lay, mode=mode, lo=lo, n=n,
                             q_local=q_local, kv_local=kv_local, cross=cross,
                             causal=causal, chunk_k=chunk_k,
                             block_causal=block_causal, policy=policy)
    o = local_map(core, out_placements=pc,
                  in_placements=(pq, pkv, pkv, _pl(ck, q, pc),
                                 _pl(cv, q, pc), _pl(cache_pos, q),
                                 _pl(kv_length, q)),
                  redistribute_inputs=True)(q, k_raw, v_raw, ck, cv,
                                            cache_pos, kv_length)
    if not split:
        return replicated_call("attention_unlayout",
                               lambda t: _unlayout_o(t, lay), o)
    if lay.g_pad != g:
        return replicated_call("attention_unpad",
                               lambda t: _unlayout_o(t, lay), o)
    Bo, So = o.shape[:2]
    return o.reshape(Bo, So, lay.n_q * lay.head_dim)


def _pl(t, like, placements=None):
    """``local_map`` in-placements for an operand: None for a plain
    tensor (passed as it is), else ``placements`` or ``like``'s batch
    sharding with "model" replicated."""
    if not is_dtensor(t):
        return None
    return placements if placements is not None else row_placements(like)


def make_cross_kv(params: Params, enc_out: torch.Tensor, lay: AttnLayout,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V for the decoder's cross-attention,
    laid out as :func:`attention` takes them: (B, S_src, kv_eff, D)."""
    D = lay.head_dim
    k = _split_heads(dense(params["k_proj"], enc_out), lay.n_kv, D)
    v = _split_heads(dense(params["v_proj"], enc_out), lay.n_kv, D)
    return _repeat_kv(k, lay.kv_repeat), _repeat_kv(v, lay.kv_repeat)
