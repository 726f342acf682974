"""Mamba2 (SSD, state-space duality) mixer: the chunked train/prefill scan
and the O(1) recurrent decode, with the TrIM conv1d kernel as the short
conv (port of ``repro/nn/mamba.py``).

The SSD recurrence  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
                    y_t = C_t h_t + D x_t
is evaluated in chunks (arXiv:2405.21060 §6): a within-chunk quadratic
term plus an inter-chunk state carried from chunk to chunk (a Python loop
where the JAX package has ``lax.scan``).  The SSD is plain PyTorch
einsums, as it is plain XLA in the JAX package.  The B/C groups are not
repeated per head in memory: heads are viewed as (G, H/G).

Shapes: u (B, L, d_model); internal x (B, L, H, P) with H heads of
headdim P, state S per head, G B/C groups (G divides H).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (REPLICATED_OPS, axis_rank,
                                              gather_local, is_dtensor,
                                              mesh_axis_names,
                                              row_placements, shard)
from repro_torch.engine.policy import ExecutionPolicy
from repro_torch.kernels.ops import trim_conv1d
from repro_torch.nn.layers import Params, _normal, dense, init_dense

#: the masked (above-diagonal) segment sum: exp() of it is 0; -inf would
#: give NaN through differences of cumulative sums.
NEG_INF = -1e30


class MambaDims(NamedTuple):
    d_model: int
    d_inner: int     # expand * d_model
    n_heads: int     # d_inner // headdim
    headdim: int
    d_state: int
    n_groups: int
    d_conv: int
    chunk: int

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_out(self) -> int:
        # z, x, B, C, dt
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.n_heads


def mamba_dims(d_model: int, *, expand: int = 2, headdim: int = 64,
               d_state: int = 128, n_groups: int = 1, d_conv: int = 4,
               chunk: int = 256) -> MambaDims:
    d_inner = expand * d_model
    if d_inner % headdim:
        raise ValueError(f"d_inner {d_inner} is not a multiple of headdim "
                         f"{headdim}")
    return MambaDims(d_model, d_inner, d_inner // headdim, headdim, d_state,
                     n_groups, d_conv, chunk)


def init_mamba(gen: torch.Generator, dims: MambaDims, dtype=torch.float32,
               device="cpu") -> Params:
    H = dims.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    # dt bias initialized so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((H,), generator=gen, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return {
        "in_proj": init_dense(gen, dims.d_model, dims.in_proj_out,
                              dtype=dtype, device=device),
        "conv1d": {"w": _normal(gen, (dims.d_conv, dims.conv_channels),
                                dims.d_conv ** -0.5, dtype, device)},
        "A_log": torch.log(torch.arange(1, H + 1, **f32)),
        "dt_bias": dt_bias,
        "D": torch.ones((H,), **f32),
        "ssm_norm": {"scale": torch.ones((dims.d_inner,), dtype=dtype,
                                         device=device)},
        "out_proj": init_dense(gen, dims.d_inner, dims.d_model,
                               std=dims.d_inner ** -0.5, dtype=dtype,
                               device=device),
    }


# ---------------------------------------------------------------------------
# Chunked SSD (train / prefill)
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T) lower-triangular segment sums:
    out[..., t, s] = sum_{s < u <= t} x[..., u] (NEG_INF above diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, NEG_INF)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int, h0: Optional[torch.Tensor] = None,
                score_dtype=torch.float32,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x (B, L, H, P) f32; dt (B, L, H) f32 (post-softplus); A (H,) negative;
    B/C (B, L, G, S); D (H,); h0 optional initial state (B, H, P, S).
    ``score_dtype``: dtype of the within-chunk quadratic term (the decay
    statistics and the carried state stay fp32).
    Returns (y (B, L, H, P), h_final (B, H, P, S)).
    """
    Bb, L, H, P = x.shape
    G, S = B.shape[-2], B.shape[-1]
    R = H // G
    CS = min(chunk, L)
    NC = -(-L // CS)
    pad = NC * CS - L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))

    # heads as (G, R): the B/C group of head g*R + r is g
    xc = x.reshape(Bb, NC, CS, G, R, P)
    dtc = dt.reshape(Bb, NC, CS, G, R)
    Bc = B.reshape(Bb, NC, CS, G, S)
    Cc = C.reshape(Bb, NC, CS, G, S)

    dA = dtc * A.reshape(G, R)                  # negative decay increments
    dAcs = torch.cumsum(dA, dim=2)

    # within-chunk quadratic term
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 4, 2))).to(score_dtype)
    CB = torch.einsum("bntgs,bnugs->bngtu", Cc.to(score_dtype),
                      Bc.to(score_dtype))                 # (B,NC,G,CS,CS)
    scores = (CB[:, :, :, None] * Lmat
              * dtc.permute(0, 1, 3, 4, 2)[..., None, :].to(score_dtype))
    y_diag = torch.einsum("bngrtu,bnugrp->bntgrp", scores,
                          xc.to(score_dtype)).float()

    # per-chunk terminal states
    decay_to_end = torch.exp(dAcs[:, :, -1:] - dAcs)       # (B,NC,CS,G,R)
    dBx = torch.einsum("bntgrp,bntgs->bngrps",
                       xc * (dtc * decay_to_end)[..., None], Bc)
    chunk_decay = torch.exp(dAcs[:, :, -1])                # (B,NC,G,R)

    h = (torch.zeros((Bb, G, R, P, S), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().reshape(Bb, G, R, P, S))
    h_prevs = []
    for n in range(NC):
        h_prevs.append(h)
        h = h * chunk_decay[:, n, ..., None, None] + dBx[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,NC,G,R,P,S)

    # inter-chunk contribution
    y_off = (torch.einsum("bntgs,bngrps->bntgrp", Cc, h_prevs)
             * torch.exp(dAcs)[..., None])
    y = (y_diag + y_off).reshape(Bb, NC * CS, H, P)[:, :L]
    y = y + x.reshape(Bb, NC * CS, H, P)[:, :L] * D[None, None, :, None]
    return y, h.reshape(Bb, H, P, S)


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. h (B,H,P,S); x (B,H,P); dt (B,H); B/C (B,G,S).
    Returns (y (B,H,P), h_new)."""
    Bb, H, P = x.shape
    G, S = B.shape[1], B.shape[2]
    R = H // G
    decay = torch.exp(dt * A)                                  # (B,H)
    upd = torch.einsum("bgrp,bgs->bgrps", (dt[..., None] * x).reshape(
        Bb, G, R, P), B).reshape(Bb, H, P, S)
    h_new = h * decay[..., None, None] + upd
    y = torch.einsum("bgs,bgrps->bgrp", C, h_new.reshape(Bb, G, R, P, S))
    return y.reshape(Bb, H, P) + x * D[None, :, None], h_new


# ---------------------------------------------------------------------------
# Full mixer (block-level API)
# ---------------------------------------------------------------------------


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_channels) trailing conv window
    ssm: torch.Tensor    # (B, H, P, S) recurrent state, fp32


def init_mamba_cache(batch: int, dims: MambaDims, dtype=torch.float32,
                     device="cpu") -> MambaCache:
    return MambaCache(
        torch.zeros((batch, dims.d_conv - 1, dims.conv_channels),
                    dtype=dtype, device=device),
        torch.zeros((batch, dims.n_heads, dims.headdim, dims.d_state),
                    dtype=torch.float32, device=device))


def _gated_rmsnorm(params: Params, y: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)
            * params["scale"].float()).to(y.dtype)


def _split_proj(proj: torch.Tensor, dims: MambaDims):
    """z, xBC, dt: column views of in_proj's output (no copies)."""
    d_in, gs = dims.d_inner, dims.n_groups * dims.d_state
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + d_in + 2 * gs]
    dt = proj[..., d_in + d_in + 2 * gs:]
    return z, xBC, dt


def mamba_mixer(params: Params, u: torch.Tensor, dims: MambaDims, *,
                mode: str = "train", cache: Optional[MambaCache] = None,
                score_dtype=torch.float32,
                policy: Optional[ExecutionPolicy] = None,
                ) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """u (B, L, d_model) -> (out, new_cache).

    mode "train"/"prefill": the short conv through ``ops.trim_conv1d``
    under ``policy`` (on ``xBC``, a strided column view of in_proj's
    output), then the chunked SSD; prefill also returns the terminal
    cache.  mode "decode": L == 1, the conv as an fp32 sum over the cached
    window (no kernel, as in the JAX package) and one recurrent step; the
    new window and state are written into ``cache``'s tensors in place
    (the JAX step returns new ones) and ``cache`` itself is returned.

    Training on a mesh (``u`` a DTensor) runs this same body: in_proj and
    out_proj are DTensor products, ``shard()`` constrains the activations
    at the JAX package's points (``nn/mamba.py:260, 280, 282``; no-ops on
    one device), and the conv (:func:`_conv_block`) and the SSD
    (:func:`_ssd_block`) run on every channel and head here and on each
    rank's block through ``local_map`` there.  Prefill and decode on a
    mesh: :func:`_mamba_serve_on_mesh` (each rank's channels and heads
    where the "model" axis has more than one rank).
    """
    on_mesh = is_dtensor(u)
    if on_mesh and mode != "train":
        return _mamba_serve_on_mesh(params, u, dims, mode=mode, cache=cache,
                                    score_dtype=score_dtype, policy=policy)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r} not in train/prefill/decode")
    Bb, L, _ = u.shape
    d_in, gs = dims.d_inner, dims.n_groups * dims.d_state
    proj = dense(params["in_proj"], u)
    if on_mesh:
        proj = _gather_proj(proj)
    z, xBC, dt_raw = _split_proj(proj, dims)
    A = -torch.exp(params["A_log"].float())

    new_cache = None
    if mode == "decode":
        if cache is None or L != 1:
            raise ValueError("decode takes one token and a cache")
        dt = torch.logaddexp(dt_raw.float() + params["dt_bias"].float(),
                             torch.zeros((), device=u.device))   # softplus
        window = torch.cat([cache.conv.to(xBC.dtype), xBC], dim=1)  # (B,K,CC)
        conv_out = torch.einsum("bkc,kc->bc", window.float(),
                                params["conv1d"]["w"].float())
        # round to the compute dtype BEFORE the activation, as the
        # train path does (trim_conv1d returns x.dtype, then silu)
        xBC_c = F.silu(conv_out.to(xBC.dtype))[:, None]
        x = xBC_c[..., :d_in].reshape(Bb, dims.n_heads, dims.headdim)
        Bm = xBC_c[..., d_in:d_in + gs].reshape(Bb, dims.n_groups,
                                                dims.d_state)
        Cm = xBC_c[..., d_in + gs:].reshape(Bb, dims.n_groups, dims.d_state)
        y, h_new = ssd_decode_step(
            cache.ssm, x.float(), dt[:, 0], A, Bm.float(), Cm.float(),
            params["D"])
        y = y.reshape(Bb, 1, d_in).to(u.dtype)
        # into the cache's own tensors: a captured step replays on the
        # same buffers every step
        cache.conv.copy_(window[:, 1:])
        cache.ssm.copy_(h_new)
        new_cache = cache
    else:
        if mode == "prefill" and cache is None:
            raise ValueError("prefill needs a cache to fill")
        w = params["conv1d"]["w"]
        args = (params["dt_bias"], A, params["D"])
        if on_mesh:
            xBC_c = _conv_on_mesh(xBC, w, policy)
            xBC_c = shard(xBC_c, "batch", "seq", "d_inner")
            y = _ssd_on_mesh(xBC_c, dt_raw, *args, dims=dims,
                             score_dtype=score_dtype, dtype=u.dtype)
        else:
            xBC_c = _conv_block(xBC, w, lo=0, n=xBC.shape[-1], policy=policy)
            y, h_last = _ssd_block(xBC_c, dt_raw, *args, dims=dims, h_lo=0,
                                   h_n=dims.n_heads, g_lo=0,
                                   g_n=dims.n_groups,
                                   score_dtype=score_dtype, dtype=u.dtype)
        if mode == "prefill":
            # trailing conv window of the raw (pre-activation) stream,
            # left-padded with zeros when L < d_conv - 1
            keep = dims.d_conv - 1
            tail = xBC[:, max(L - keep, 0):]
            tail = F.pad(tail, (0, 0, keep - tail.shape[1], 0))
            new_cache = MambaCache(tail.to(cache.conv.dtype), h_last)

    y = _gated_rmsnorm(params["ssm_norm"], y, z)
    y = shard(y, "batch", "seq", "d_inner")
    out = dense(params["out_proj"], y)
    return shard(out, "batch", "seq", "embed"), new_cache


def _conv_block(xBC: torch.Tensor, w: torch.Tensor, *, lo: int, n: int,
                policy) -> torch.Tensor:
    """silu(the short conv) on conv channels [lo, lo + n) (every channel
    on one device); ``w`` all the channels' taps or the block's."""
    x = xBC[..., lo:lo + n]
    if w.shape[-1] != n:
        w = w[:, lo:lo + n].contiguous()    # the kernel takes a dense w
    return F.silu(trim_conv1d(x, w.to(x.dtype), policy=policy))


def _ssd_block(xBC_c: torch.Tensor, dt_raw: torch.Tensor,
               dt_bias: torch.Tensor, A: torch.Tensor, D: torch.Tensor, *,
               dims: MambaDims, h_lo: int, h_n: int, g_lo: int, g_n: int,
               score_dtype, dtype):
    """The chunked SSD on heads [h_lo, h_lo + h_n) with the B/C groups
    [g_lo, g_lo + g_n) they read (every head on one device), from the
    activated conv output of every channel: (y (B, L, h_n P) in
    ``dtype``, the terminal state)."""
    Bb, L = xBC_c.shape[:2]
    d_in, gs = dims.d_inner, dims.n_groups * dims.d_state
    H, G, P = dims.n_heads, dims.n_groups, dims.headdim
    heads = slice(h_lo, h_lo + h_n)
    x = xBC_c[..., :d_in].reshape(Bb, L, H, P)[:, :, heads]
    Bm = xBC_c[..., d_in:d_in + gs].reshape(Bb, L, G, dims.d_state)
    Cm = xBC_c[..., d_in + gs:].reshape(Bb, L, G, dims.d_state)
    Bm, Cm = Bm[:, :, g_lo:g_lo + g_n], Cm[:, :, g_lo:g_lo + g_n]
    dt = torch.logaddexp(dt_raw[..., heads].float() + dt_bias[heads].float(),
                         torch.zeros((), device=xBC_c.device))   # softplus
    y, h_last = ssd_chunked(x.float(), dt, A[heads], Bm.float(), Cm.float(),
                            D[heads], chunk=dims.chunk,
                            score_dtype=score_dtype)
    return y.reshape(Bb, L, h_n * P).to(dtype), h_last


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------


def _gather_proj(proj):
    """in_proj's fused [z | xBC | dt] output gathered over "model" before
    the split: its column shards do not follow the three parts
    (``REPLICATED_OPS["mamba_in_proj_split"]``)."""
    names = tuple(proj.device_mesh.mesh_dim_names)
    if any(p.is_shard() for n, p in zip(names, proj.placements)
           if n == "model"):
        REPLICATED_OPS["mamba_in_proj_split"] += 1
    return proj.redistribute(proj.device_mesh, row_placements(proj))


def _replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def _conv_on_mesh(xBC, w, policy):
    """:func:`_conv_block` through ``local_map`` on each rank's channels
    (conv1d/w sharded on its channels, ``d_inner``, or sliced to them);
    every channel on every rank where they do not divide the model axis
    (``REPLICATED_OPS["mamba_conv1d"]``)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xBC.device_mesh
    mi, m = axis_rank(mesh, "model")
    cc = xBC.shape[-1]
    split = cc % m == 0
    if not split:
        REPLICATED_OPS["mamba_conv1d"] += 1
    rep = _replicated(mesh)
    w_pl = rep
    if split and tuple(w.placements) != tuple(rep):
        w_pl = [Shard(1) if n == "model" else p for n, p in zip(
            mesh.mesh_dim_names, rep)]
    lo, n = (mi * cc // m, cc // m) if split else (0, cc)
    fn = functools.partial(_conv_block, lo=lo, n=n, policy=policy)
    return local_map(fn, out_placements=row_placements(
        xBC, 2 if split else None),
        in_placements=(row_placements(xBC), w_pl),
        redistribute_inputs=True)(xBC, w)


def _ssd_on_mesh(xBC_c, dt_raw, dt_bias, A, D, *, dims: MambaDims,
                 score_dtype, dtype):
    """:func:`_ssd_block` through ``local_map`` on each rank's heads, with
    the B/C group those heads read; the output sharded on its heads.
    Every head on every rank where heads or groups do not divide the
    model axis (``REPLICATED_OPS["mamba_ssd_heads"]``)."""
    from torch.distributed.tensor.experimental import local_map
    mi, m = axis_rank(xBC_c.device_mesh, "model")
    H, G = dims.n_heads, dims.n_groups
    split = H % m == 0 and (G % m == 0 or m % G == 0)
    if not split:
        REPLICATED_OPS["mamba_ssd_heads"] += 1
    h_n = H // m if split else H
    h_lo = mi * h_n if split else 0
    g_lo, g_n = (h_lo * G // H, max(G // m, 1)) if split else (0, G)

    def fn(*args):
        return _ssd_block(*args, dims=dims, h_lo=h_lo, h_n=h_n, g_lo=g_lo,
                          g_n=g_n, score_dtype=score_dtype, dtype=dtype)[0]
    rows, rep = row_placements(xBC_c), _replicated(xBC_c.device_mesh)
    return local_map(fn, out_placements=row_placements(
        xBC_c, 2 if split else None),
        in_placements=(rows, rows, rep, rep, rep),
        redistribute_inputs=True)(xBC_c, dt_raw, dt_bias, A, D)


def _mamba_serve_on_mesh(params: Params, u, dims: MambaDims, *, mode: str,
                         cache, score_dtype, policy):
    """Prefill and decode on a mesh, each rank on its batch rows, the cache
    given written in place (its DTensors' local shards) and returned.

    Where the "model" axis has one rank, each rank runs the one-device
    mixer on its rows (the params gathered whole): bit for bit the one
    device's.  Otherwise :func:`_serve_cut` runs each rank's channels and
    heads."""
    if torch.is_grad_enabled():
        raise RuntimeError(f"the Mamba mixer's {mode} on a mesh serves "
                           "under torch.no_grad()")
    if mode not in ("prefill", "decode") or cache is None:
        raise ValueError(f"serving on a mesh takes prefill or decode and a "
                         f"cache, not {mode!r}")
    from torch.distributed.tensor import DTensor
    _, model_ranks = axis_rank(u.device_mesh, "model")
    lc = MambaCache(*(t.to_local() if is_dtensor(t) else t for t in cache))
    if model_ranks > 1:
        out = _serve_cut(params, u, dims, mode=mode, cache=lc,
                         score_dtype=score_dtype, policy=policy)
    else:
        from repro_torch.core.tree import tree_map
        local = tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t,
                         params)
        out, new = mamba_mixer(local, u.to_local(), dims, mode=mode,
                               cache=lc, score_dtype=score_dtype,
                               policy=policy)
        if mode == "prefill":
            lc.conv.copy_(new.conv)
            lc.ssm.copy_(new.ssm)
    return DTensor.from_local(out, u.device_mesh, row_placements(u),
                              run_check=False), cache


def _model_gather(t: torch.Tensor, dim: int, like) -> torch.Tensor:
    """This rank's block ``t`` of a dim cut over "model", joined with the
    other ranks' blocks (``gather_local``: c10d), the rows kept as
    ``like``'s."""
    from torch.distributed.tensor import DTensor
    return gather_local(DTensor.from_local(
        t, like.device_mesh, row_placements(like, dim), run_check=False))


def _serve_cut(params: Params, u, dims: MambaDims, *, mode: str,
               cache: MambaCache, score_dtype, policy) -> torch.Tensor:
    """A Mamba prefill or decode step with the "model" axis' m ranks each
    on its block of conv channels and of heads, as ``cache_pspec`` cuts the
    cache (``cache``: this rank's local shards, written in place).  Every
    collective is a c10d call on the "model" group (two ranks sharing a
    card over gloo cannot take DTensor's functional ones).

    - in_proj is the DTensor product; its fused [z | xBC | dt] output is
      gathered whole before the split (``mamba_in_proj_split``).
    - The conv (kernel 3 in prefill; the fp32 window sum in decode) runs
      on the rank's channels, which its conv cache holds, and writes that
      window; the activated channels are gathered over "model".
    - The SSD runs on the rank's heads with the B/C groups they read,
      from (decode) and into its state cache's heads.
    - The gated norm and the row-parallel out_proj: each rank's y and z
      heads, the squares' sum and the fp32 partial products summed over
      "model", so the output differs from one device's by the order of
      those sums.

    Where channels or heads do not divide the axis every rank runs them
    all (``mamba_conv1d``, ``mamba_ssd_heads``), the cache's slice written
    from them, the states gathered first in decode."""
    import torch.distributed as dist
    mesh = u.device_mesh
    names = mesh_axis_names(mesh)
    md = names.index("model")
    grp, mi, m = mesh.get_group(md), mesh.get_local_rank(md), mesh.size(md)
    whole = functools.partial(gather_local, gather=names)
    # rows cut as u's (an in_proj cut over the data axes, FSDP, may give
    # them whole)
    proj = shard(dense(params["in_proj"], u), "batch", "seq", "d_inner")
    if proj.placements[md].is_shard():
        REPLICATED_OPS["mamba_in_proj_split"] += 1
    # this rank's rows, every column, channels dense (kernel 3 reads them
    # so; the gather leaves them strided)
    proj = gather_local(proj).contiguous()
    Bb, L, _ = proj.shape
    z, xBC, dt_raw = _split_proj(proj, dims)
    d_in, gs = dims.d_inner, dims.n_groups * dims.d_state
    H, G, P = dims.n_heads, dims.n_groups, dims.headdim
    CC = dims.conv_channels
    w = whole(params["conv1d"]["w"])
    A = -torch.exp(whole(params["A_log"]).float())
    dt_bias, Dp = whole(params["dt_bias"]), whole(params["D"])
    # the cache's blocks: a cut dim holds 1/m of its channels or heads
    c_n, h_n = cache.conv.shape[-1], cache.ssm.shape[1]
    c_lo = mi * c_n if c_n < CC else 0
    h_lo = mi * h_n if h_n < H else 0
    conv_cut = c_n < CC
    if not conv_cut:
        REPLICATED_OPS["mamba_conv1d"] += 1
    ssd_cut = h_n < H and (G % m == 0 or m % G == 0)
    if not ssd_cut:
        REPLICATED_OPS["mamba_ssd_heads"] += 1
    blk = slice(c_lo, c_lo + c_n)
    if mode == "decode":
        window = torch.cat([cache.conv.to(xBC.dtype), xBC[..., blk]], dim=1)
        conv_out = torch.einsum("bkc,kc->bc", window.float(),
                                w[:, blk].float())
        xc = F.silu(conv_out.to(xBC.dtype))[:, None]
        cache.conv.copy_(window[:, 1:])
    else:
        xc = _conv_block(xBC, w, lo=c_lo, n=c_n, policy=policy)
        keep = dims.d_conv - 1
        tail = xBC[:, max(L - keep, 0):, blk]
        cache.conv.copy_(F.pad(tail, (0, 0, keep - tail.shape[1], 0)))
    if conv_cut:
        xc = _model_gather(xc, 2, u)                  # every channel
    # the SSD on the rank's heads (or every head), its state written
    s_lo, s_n = (h_lo, h_n) if ssd_cut else (0, H)
    g_lo, g_n = (s_lo * G // H, max(G * s_n // H, 1)) if ssd_cut else (0, G)
    heads = slice(s_lo, s_lo + s_n)
    if mode == "decode":
        dt = torch.logaddexp(dt_raw[:, 0, heads].float()
                             + dt_bias[heads].float(),
                             torch.zeros((), device=xc.device))
        x = xc[:, 0, :d_in].reshape(Bb, H, P)[:, heads]
        Bm = xc[:, 0, d_in:d_in + gs].reshape(Bb, G, dims.d_state)
        Cm = xc[:, 0, d_in + gs:].reshape(Bb, G, dims.d_state)
        h0 = cache.ssm if ssd_cut or h_n == H else _model_gather(
            cache.ssm, 1, u)
        y, h_new = ssd_decode_step(
            h0, x.float(), dt, A[heads], Bm[:, g_lo:g_lo + g_n].float(),
            Cm[:, g_lo:g_lo + g_n].float(), Dp[heads])
        y = y.reshape(Bb, 1, s_n * P).to(u.dtype)
    else:
        y, h_new = _ssd_block(xc, dt_raw, dt_bias, A, Dp, dims=dims,
                              h_lo=s_lo, h_n=s_n, g_lo=g_lo, g_n=g_n,
                              score_dtype=score_dtype, dtype=u.dtype)
    cache.ssm.copy_(h_new if ssd_cut or h_n == H
                    else h_new[:, h_lo:h_lo + h_n])
    # the gated norm over d_inner and the row-parallel out_proj
    cols = slice(s_lo * P, (s_lo + s_n) * P)
    yf = y.float() * F.silu(z[..., cols].float())
    ss = (yf * yf).sum(dim=-1, keepdim=True)
    if ssd_cut:
        dist.all_reduce(ss, group=grp)
    scale = whole(params["ssm_norm"]["scale"])[cols]
    yn = (yf * torch.rsqrt(ss / d_in + 1e-5) * scale.float()).to(u.dtype)
    w_out = whole(params["out_proj"]["kernel"])[cols]
    if not ssd_cut:
        return dense({"kernel": w_out}, yn)
    part = yn.float() @ w_out.float()
    dist.all_reduce(part, group=grp)
    return part.to(u.dtype)
