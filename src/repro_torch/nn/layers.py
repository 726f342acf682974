"""Base LM layers: embedding, RMSNorm, dense projections and the tied
readout (the part of ``repro/nn/layers.py`` the ssm serving path uses).

Conventions as in the JAX package: params are nested dicts with its leaf
names; the compute dtype is the input's (bf16 in production), while
normalization statistics and the logits are fp32.  ``init_*`` functions
draw from an explicit ``torch.Generator`` (on the params' device; a CPU
generator for the ``meta`` device).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

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
    return params["table"][ids]


def embed_logits(params: Params, x: torch.Tensor, vocab: int,
                 keep_pad: bool = False) -> torch.Tensor:
    """Tied-readout logits in fp32 (``keep_pad``: the padded width, pad
    entries masked to -1e30).  The product is taken in fp32: a bf16 x
    bf16 product is exact there, as JAX's ``preferred_element_type``."""
    logits = x.float() @ params["table"].float().T
    if keep_pad:
        return mask_pad_logits(logits, vocab)
    return logits[..., :vocab]


def mask_pad_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    vpad = logits.shape[-1]
    if vpad == vocab:
        return logits
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


# -- dense -------------------------------------------------------------------

def init_dense(gen: torch.Generator, d_in: int, d_out: int, *,
               std: Optional[float] = None, dtype=torch.float32,
               device="cpu") -> Params:
    std = d_in ** -0.5 if std is None else std
    return {"kernel": _normal(gen, (d_in, d_out), std, dtype, device)}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["kernel"].to(x.dtype)
