"""Base LM layers: embedding, RMSNorm and LayerNorm, dense projections,
the MLPs (swiglu, geglu, gelu), rotary embeddings, the tied readout and
the untied ``lm_head`` (port of ``repro/nn/layers.py``).

Conventions as in the JAX package: params are nested dicts with its leaf
names; the compute dtype is the input's (bf16 in production), while
normalization statistics and the logits are fp32.  ``init_*`` functions
draw from an explicit ``torch.Generator`` (on the params' device; a CPU
generator for the ``meta`` device).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (is_dtensor, replicated_call,
                                              shard)

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape, std: float, dtype,
            device) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * std).to(dtype)


# -- embedding ---------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, *,
                   pad_to: int = 1, dtype=torch.float32,
                   device="cpu") -> Params:
    """Token embedding; the vocab is padded up to a multiple of ``pad_to``
    and the padded rows are zero."""
    vpad = -(-vocab // pad_to) * pad_to
    table = _normal(gen, (vpad, d), d ** -0.5, dtype, device)
    if vpad != vocab:
        table[vocab:] = 0.0
    return {"table": table}


def embed_lookup(params: Params, ids: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    if is_dtensor(table):
        return shard(_embed_on_mesh(table, ids), "batch", "seq", "embed")
    return table[ids]


def _embed_on_mesh(table, ids):
    """The lookup on DTensors, through ``local_map``: each rank looks up
    the ids its rows of the table hold (zeros for the others), and the
    partial rows sum over the axes that cut the vocab (every id on each
    of their ranks).  A table cut on its embed dim (FSDP) is gathered on
    it first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tab_pl = [p if p.is_shard(0) else Replicate() for p in table.placements]
    cut = [p.is_shard(0) for p in tab_pl]
    ids_pl = [Shard(0) if p.is_shard(0) and not c else Replicate()
              for p, c in zip(ids.placements, cut)] \
        if is_dtensor(ids) else None
    vpad = table.shape[0]
    starts = []
    for i, c in enumerate(cut):
        starts.append((mesh.get_local_rank(i), mesh.size(i)) if c else None)

    def look(tab, idl):
        lo, rows = 0, vpad
        for s in starts:         # the vocab rows this rank holds
            if s is not None:
                rows //= s[1]
                lo = lo * s[1] + s[0]
        lo *= rows
        local = idl - lo
        hit = (local >= 0) & (local < rows)
        out = tab[torch.where(hit, local, torch.zeros_like(local))]
        return out * hit[..., None].to(out.dtype)
    out_pl = [Partial() if c else (i_pl if ids_pl is not None else
                                   Replicate())
              for c, i_pl in zip(cut, ids_pl or [Replicate()] * len(cut))]
    return local_map(look, out_placements=out_pl,
                     in_placements=(tab_pl, ids_pl),
                     redistribute_inputs=True)(table, ids)


def embed_logits(params: Params, x: torch.Tensor, vocab: int,
                 keep_pad: bool = False) -> torch.Tensor:
    """Tied-readout logits in fp32 (``keep_pad``: the padded width, pad
    entries masked to -1e30).  The product is taken in fp32: a bf16 x
    bf16 product is exact there, as JAX's ``preferred_element_type``."""
    logits = x.float() @ params["table"].float().T
    if keep_pad:
        return mask_pad_logits(logits, vocab)
    return _drop_pad(logits, vocab)


def init_lm_head(gen: torch.Generator, d: int, vocab: int, *,
                 pad_to: int = 1, dtype=torch.float32, device="cpu") -> Params:
    """The untied readout (d, vocab padded up to a multiple of ``pad_to``);
    as in the JAX package its padded columns are not zeroed: the logits
    mask them."""
    vpad = -(-vocab // pad_to) * pad_to
    return {"kernel": _normal(gen, (d, vpad), d ** -0.5, dtype, device)}


def lm_head_logits(params: Params, x: torch.Tensor, vocab: int,
                   keep_pad: bool = False) -> torch.Tensor:
    """Untied-readout logits in fp32, as :func:`embed_logits`."""
    logits = x.float() @ params["kernel"].float()
    if keep_pad:
        return mask_pad_logits(logits, vocab)
    return _drop_pad(logits, vocab)


def _drop_pad(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    if logits.shape[-1] == vocab:
        return logits
    return replicated_call("drop_pad_logits", lambda t: t[..., :vocab],
                           logits)


def mask_pad_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    vpad = logits.shape[-1]
    if vpad == vocab:
        return logits
    if is_dtensor(logits):
        return replicated_call("mask_pad_logits",
                               lambda t: mask_pad_logits(t, vocab), logits)
    mask = torch.arange(vpad, device=logits.device) < vocab
    return torch.where(mask, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                device=logits.device))


# -- norms -------------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


# -- dense -------------------------------------------------------------------

def init_dense(gen: torch.Generator, d_in: int, d_out: int, *,
               std: Optional[float] = None, dtype=torch.float32,
               device="cpu") -> Params:
    std = d_in ** -0.5 if std is None else std
    return {"kernel": _normal(gen, (d_in, d_out), std, dtype, device)}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["kernel"].to(x.dtype)


# -- MLPs --------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, kind: str,
             dtype=torch.float32, device="cpu") -> Params:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": init_dense(gen, d, ff, dtype=dtype, device=device),
                "w_up": init_dense(gen, d, ff, dtype=dtype, device=device),
                "w_down": init_dense(gen, ff, d, std=ff ** -0.5, dtype=dtype,
                                     device=device)}
    if kind == "gelu":
        return {"w_in": init_dense(gen, d, ff, dtype=dtype, device=device),
                "w_out": init_dense(gen, ff, d, std=ff ** -0.5, dtype=dtype,
                                    device=device)}
    raise ValueError(kind)


def mlp(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``jax.nn.gelu`` defaults to the tanh approximation, and so does this
    port of it."""
    if kind in ("swiglu", "geglu"):
        g = dense(params["w_gate"], x)
        u = dense(params["w_up"], x)
        g = shard(g, "batch", "seq", "ff")
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        out = dense(params["w_down"], act * u)
    elif kind == "gelu":
        h = shard(dense(params["w_in"], x), "batch", "seq", "ff")
        out = dense(params["w_out"], F.gelu(h, approximate="tanh"))
    else:
        raise ValueError(kind)
    return shard(out, "batch", "seq", "embed")


# -- rotary ------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> (cos, sin) of shape (..., head_dim//2), fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads; the
    rotation is taken in fp32 and cast back to x's dtype."""
    half = x.shape[-1] // 2
    c, s = cos[..., None, :], sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)
