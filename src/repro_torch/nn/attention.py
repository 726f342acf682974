"""Attention: GQA/MQA/MHA self-attention with RoPE, cross-attention into
an encoder's output, a streaming-softmax core for train and prefill, and
KV-cached decode (port of ``repro/nn/attention.py`` for one device,
``tp == 1``).

The core is ``kernels.ops.flash_attention``: the hand-written flash
kernel on a CUDA tensor, its plain version (``nn/attention.py:
flash_attention`` line for line) on the CPU or under the oracle policy.
It reads q as the (B, S, n_kv, G, D) view of the q projection and k/v as
(B, S, n_kv, D), so the G q heads of a KV head share its K/V and nothing
is repeated in memory.

The KV cache is written in place, where the JAX package's
``dynamic_update_slice`` returns a new cache: prefill writes rows
[0, S), decode writes row ``cache_pos``, into the tensors of the
:class:`KVCache` it is given, and returns that same cache.  The serving
loop never reads an old cache again, and copying a full-width cache (1.35
GB for granite-3-2b at batch 4 x 4128) on every decode step would cost
more HBM traffic than the step's attention reads.  A caller that needs
the old cache clones it first.

The sequence-sharded decode (``kv_seqshard``, ``repro/nn/decode_attn.py:
seqshard_flash_decode``) keeps the cache unrepeated, (B, S, n_kv, D), and
on one device runs "the same math single-device": write the new K and V
at ``pos``, then attend over the cache under ``kv_length`` (default
``pos + 1``).  At ``tp == 1`` the port's cache is already (B, S, n_kv, D),
so that is its decode path, kernel 5's split decode on the card; the
caller keys the cache ``kv_seq`` (``kv_seq2``), as JAX does.  Across
ranks (a process group of more than one) it raises: the multi-rank arm,
a partial flash per sequence shard merged by log-sum-exp, is ROADMAP
queue 1, item 10.

Cross-attention (the encdec decoder): ``cross_kv`` is the (k, v) pair
:func:`make_cross_kv` lays out from the encoder's output, (B, S_src,
kv_eff, D) each.  The layer then projects only q, applies no RoPE, writes
no cache and attends over every source key, never causally and under no
``kv_length``, in every mode, as ``repro/nn/attention.py:223-233, 279``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

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


def _world_size() -> int:
    """The ranks of the default process group (1 where there is none)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def attn_layout(n_q: int, n_kv: int, head_dim: int, tp: int = 1
                ) -> AttnLayout:
    """The head layout on one device: no KV repeat, no q-head padding.
    (The JAX package repeats KV heads and pads q groups for ``tp > n_kv``;
    tensor parallelism is ROADMAP queue 1, item 10.)"""
    if n_q % n_kv:
        raise ValueError(f"n_q {n_q} is not a multiple of n_kv {n_kv}")
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: the port runs on one device "
                                  "(ROADMAP queue 1, item 10)")
    return AttnLayout(n_q, n_kv, head_dim, 1, n_q // n_kv)


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
    return x.reshape(x.shape[:-1] + (n, d))


def _layout_q(q: torch.Tensor, lay: AttnLayout) -> torch.Tensor:
    """(B,S,n_q,D) -> (B,S,kv_eff,G',D): a view at ``tp == 1``."""
    B, S, _, D = q.shape
    return q.reshape(B, S, lay.kv_eff, lay.g_eff, D)


def _unlayout_o(o: torch.Tensor, lay: AttnLayout) -> torch.Tensor:
    """(B,S,kv_eff,G',D) -> (B,S,n_q*D)."""
    B, S = o.shape[:2]
    return o.reshape(B, S, lay.n_q * o.shape[-1])


def _repeat_kv(kv: torch.Tensor, r: int) -> torch.Tensor:
    if r == 1:
        return kv
    return torch.repeat_interleave(kv, r, dim=2)


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S_max, kv_eff, D)
    v: torch.Tensor


def init_kv_cache(batch: int, max_len: int, lay: AttnLayout,
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (batch, max_len, lay.kv_eff, lay.head_dim)
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
    """
    if cross_kv is not None:
        q = _split_heads(dense(params["q_proj"], x), lay.n_q, lay.head_dim)
        k, v = cross_kv
        o = flash_attention(_layout_q(q, lay), k, v, causal=False,
                            chunk_k=chunk_k, policy=policy)
        return dense(params["o_proj"], _unlayout_o(o, lay)), None
    if kv_seqshard and mode == "decode" and _world_size() > 1:
        raise NotImplementedError(
            f"the sequence-sharded decode across {_world_size()} ranks "
            "(kv_seqshard under a mesh, nn/decode_attn.py's shard_map arm) "
            "is not ported yet: ROADMAP queue 1, item 10")
    B, S, _ = x.shape
    D = lay.head_dim
    q = _split_heads(dense(params["q_proj"], x), lay.n_q, D)
    k = _split_heads(dense(params["k_proj"], x), lay.n_kv, D)
    v = _split_heads(dense(params["v_proj"], x), lay.n_kv, D)
    cos, sin = rope if rope is not None else rope_angles(positions, D,
                                                         rope_theta)
    q = apply_rope(q, cos, sin)
    k = _repeat_kv(apply_rope(k, cos, sin), lay.kv_repeat)
    v = _repeat_kv(v, lay.kv_repeat)

    new_cache = None
    if mode == "decode":
        if cache is None or cache_pos is None:
            raise ValueError("decode needs a cache and cache_pos")
        # the write lands where the position tensor says, on the device:
        # a captured step replays it at each new position
        pos = torch.as_tensor(cache_pos, device=x.device).to(torch.long)
        rows = pos + torch.arange(S, device=x.device)
        cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
        cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
        new_cache = cache
        length = kv_length
        if length is None:
            length = (pos + 1).to(torch.int32).expand(B)
        o = flash_attention(_layout_q(q, lay), cache.k, cache.v,
                            causal=False, kv_length=length, chunk_k=chunk_k,
                            policy=policy)
    else:
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill needs a cache")
            cache.k[:, :S] = k.to(cache.k.dtype)
            cache.v[:, :S] = v.to(cache.v.dtype)
            new_cache = cache
        o = flash_attention(_layout_q(q, lay), k, v, causal=causal,
                            kv_length=kv_length, chunk_k=chunk_k,
                            block_causal=block_causal, policy=policy)
    out = dense(params["o_proj"], _unlayout_o(o, lay))
    return out, new_cache


def make_cross_kv(params: Params, enc_out: torch.Tensor, lay: AttnLayout,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V for the decoder's cross-attention,
    laid out as :func:`attention` takes them: (B, S_src, kv_eff, D)."""
    D = lay.head_dim
    k = _split_heads(dense(params["k_proj"], enc_out), lay.n_kv, D)
    v = _split_heads(dense(params["v_proj"], enc_out), lay.n_kv, D)
    return _repeat_kv(k, lay.kv_repeat), _repeat_kv(v, lay.kv_repeat)
