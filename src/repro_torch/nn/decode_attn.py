"""Sequence-sharded flash decode (port of ``repro/nn/decode_attn.py``).

The decode cache is stored unrepeated, (B, S, n_kv, D), and its sequence
axis is cut over the ranks of one or more mesh axes (``("model",)``; the
"2d" serve layout ``("data", "model")``, flattened in mesh order): each
rank holds S / n positions, the keys [lo, lo + S_loc) with lo = its
flattened index times S_loc.  A decode step on each rank

- writes the new token's K and V into its slice only where
  ``lo <= pos < lo + S_loc`` (a predicated write on the device, no host
  read of ``pos``);
- computes its partial (o, m, l) over its slice for every q head, masked
  by the global ``kv_length`` (its local length is ``kv_length - lo``
  clipped to [0, S_loc]): kernel 5's partial entry on the card
  (``kernels.flash_attention.flash_attention_partial``, which writes each
  row's merged max and sum beside its output), its plain version on the
  CPU;
- merges the partials as the flash streaming softmax merges its tiles:
  an all-reduce MAX of m, then one all-reduce SUM of (l w, o l w) with
  w = exp(m - m_max), packed in one buffer.

The collectives run on the process group of the axes (``torch.
distributed``; NCCL or gloo, whichever the group was made with).  Without
an active mesh, or where the axes have one rank, this is the same math on
one device: the write at ``pos`` and kernel 5's decode over the whole
cache (the path ``nn/attention.py`` has taken since the port began).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import (axes_group,
                                              current_mesh_context,
                                              gather_local, is_dtensor,
                                              mesh_shape, row_placements)
from repro_torch.engine.policy import ExecutionPolicy, resolve_substrate
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels.ops import flash_attention

def _active_axes(axes: Tuple[str, ...]):
    ctx = current_mesh_context()
    if ctx is None:
        return None, ()
    sizes = mesh_shape(ctx.mesh)
    live = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if not live or not hasattr(ctx.mesh, "get_group"):
        return None, ()
    return ctx.mesh, tuple(a for a in axes if a in sizes)


def _kv_len(B: int, pos: torch.Tensor, kv_length) -> torch.Tensor:
    if kv_length is None:
        return (pos + 1).to(torch.int32).expand(B)
    return kv_length.to(torch.int32)


def seqshard_flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, new_k: torch.Tensor,
                          new_v: torch.Tensor, pos,
                          kv_length: Optional[torch.Tensor] = None,
                          axes: Tuple[str, ...] = ("model",), *,
                          chunk_k: int = 1024,
                          policy: Optional[ExecutionPolicy] = None):
    """One decode step against a sequence-sharded unrepeated cache.

    q (B, 1, n_q, D); k/v_cache (B, S, n_kv, D), each rank's slice of the
    sequence (a DTensor sharded on dim 1 over ``axes``, or the rank's
    local slice as a plain tensor); new_k/v (B, 1, n_kv, D); ``pos`` the
    position written (an int or a 0-d tensor); ``kv_length`` (B,) the keys
    each row sees (default pos + 1).  The caches are written in place and
    returned: (o (B, 1, n_q, D) in q's dtype, k_cache, v_cache).

    The ranks are those of the active mesh's ``axes``; without an active
    mesh, or where those axes have one rank, the one-device math runs.
    """
    mesh, live = _active_axes(axes)
    if mesh is None:
        return _one_device(q, k_cache, v_cache, new_k, new_v, pos,
                           kv_length, chunk_k, policy)
    return _multi_rank(q, k_cache, v_cache, new_k, new_v, pos, kv_length,
                       axes_group(mesh, live), mesh, live, policy)


def _one_device(q, k_cache, v_cache, new_k, new_v, pos, kv_length, chunk_k,
                policy):
    """Write at ``pos``, then kernel 5 over the whole cache under
    ``kv_length`` (default pos + 1); DTensors (a mesh whose sequence axes
    have one rank) on their local batch rows."""
    if is_dtensor(q):
        from torch.distributed.tensor import DTensor
        o, _, _ = _one_device(
            gather_local(q, ()), k_cache.to_local(), v_cache.to_local(),
            gather_local(new_k, ()), gather_local(new_v, ()), pos,
            gather_local(kv_length, ()), chunk_k, policy)
        return (DTensor.from_local(o, q.device_mesh, row_placements(q),
                                   run_check=False),
                k_cache, v_cache)
    B, S, n_q, D = q.shape
    n_kv = k_cache.shape[2]
    p = torch.as_tensor(pos, device=q.device).to(torch.long)
    rows = p + torch.arange(S, device=q.device)
    k_cache.index_copy_(1, rows, new_k.to(k_cache.dtype))
    v_cache.index_copy_(1, rows, new_v.to(v_cache.dtype))
    length = kv_length
    if length is None:
        length = (p + 1).to(torch.int32).expand(B)
    o = flash_attention(q.reshape(B, S, n_kv, n_q // n_kv, D), k_cache,
                        v_cache, causal=False, kv_length=length,
                        chunk_k=chunk_k, policy=policy)
    return o.reshape(B, S, n_q, D), k_cache, v_cache


def _multi_rank(q, k_cache, v_cache, new_k, new_v, pos, kv_length, group,
                mesh, live, policy):
    import torch.distributed as dist
    grp, idx, _ = group
    dq = q if is_dtensor(q) else None
    ql = gather_local(q, live)
    nk, nv = gather_local(new_k, live), gather_local(new_v, live)
    kv_length = gather_local(kv_length, live)
    k_loc = k_cache.to_local() if is_dtensor(k_cache) else k_cache
    v_loc = v_cache.to_local() if is_dtensor(v_cache) else v_cache
    B, _, n_q, D = ql.shape
    S_loc, n_kv = k_loc.shape[1], k_loc.shape[2]
    dev = ql.device
    lo = idx * S_loc
    p = torch.as_tensor(pos, device=dev).to(torch.long)
    # the predicated write: the owning rank writes the token, the others
    # write back what they hold
    own = (p >= lo) & (p < lo + S_loc)
    loc = torch.clamp(p - lo, 0, S_loc - 1).reshape(1)
    for cache, new in ((k_loc, nk), (v_loc, nv)):
        old = cache.index_select(1, loc)
        cache.index_copy_(1, loc, torch.where(own, new.to(cache.dtype), old))
    length = torch.clamp(_kv_len(B, p, kv_length) - lo, 0, S_loc)
    qg = ql.reshape(B, 1, n_kv, n_q // n_kv, D)
    pol = policy or ExecutionPolicy()
    if resolve_substrate(pol.substrate, dev) == "oracle":
        o, m, l = flash_kernel.flash_partial_plain(qg, k_loc, v_loc, length)
    else:
        o, m, l = flash_kernel.flash_attention_partial(qg, k_loc, v_loc,
                                                       length)
    # the distributed log-sum-exp merge
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=grp)
    w = torch.exp(m - m_g)
    lw = l * w
    packed = torch.cat([(o.float() * lw[..., None]).reshape(-1),
                        lw.reshape(-1)])
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=grp)
    o_g = packed[:o.numel()].reshape(o.shape)
    l_g = packed[o.numel():].reshape(lw.shape)
    out = (o_g / torch.clamp(l_g, min=1e-20)[..., None]).to(ql.dtype)
    out = out.reshape(B, 1, n_q, D)
    if dq is not None:
        from torch.distributed.tensor import DTensor
        out = DTensor.from_local(out, dq.device_mesh,
                                 row_placements(dq, gather=live),
                                 run_check=False)
    return out, k_cache, v_cache


def seqshard_prefill_write(cache, k_raw: torch.Tensor, v_raw: torch.Tensor,
                           axes: Tuple[str, ...]) -> None:
    """A prefill's rows [0, S) of unrepeated K and V (B, S, n_kv, D) into
    a sequence-sharded cache, in place: on one device (or one rank) rows
    [0, S); across the ranks of ``axes`` each rank writes the rows of its
    slice (the cache a DTensor sharded on dim 1, or the rank's slice)."""
    mesh, live = _active_axes(axes)
    k_loc = cache.k.to_local() if is_dtensor(cache.k) else cache.k
    v_loc = cache.v.to_local() if is_dtensor(cache.v) else cache.v
    kl, vl = gather_local(k_raw, live), gather_local(v_raw, live)
    idx, n = 0, 1
    if mesh is not None:
        _, idx, n = axes_group(mesh, live)
    if n == 1:
        S = kl.shape[1]
        k_loc[:, :S] = kl.to(k_loc.dtype)
        v_loc[:, :S] = vl.to(v_loc.dtype)
        return
    S_loc = k_loc.shape[1]
    lo = idx * S_loc
    hi = min(lo + S_loc, kl.shape[1])
    if hi > lo:
        k_loc[:, :hi - lo] = kl[:, lo:hi].to(k_loc.dtype)
        v_loc[:, :hi - lo] = vl[:, lo:hi].to(v_loc.dtype)
