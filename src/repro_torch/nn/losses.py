"""Cross-entropy losses (port of ``repro/nn/losses.py``).

:func:`softmax_xent`: the mean fp32 log-softmax CE on logits, padded
vocab entries masked to -1e30 by the caller.

:func:`chunked_softmax_xent`: the same CE without the full (B, S, V)
logits.  The log-sum-exp runs over vocab chunks as a running (m, l), as
flash attention runs over keys, and each chunk step is recomputed in the
backward (``torch.utils.checkpoint``, where the JAX package puts
``jax.checkpoint`` on the chunk's product), so only one chunk's logits
exist at a time.  The chunk product is a plain product (``torch.matmul``),
as it is a plain ``einsum`` outside Pallas in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import replicated_call

NEG = -1e30


def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, targets.long()[..., None],
                                 dim=-1)[..., 0]


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) any float; targets (B, S) int.  Mean CE, fp32.
    On DTensors the per-token CE runs on each rank's batch rows, the
    vocab gathered (``REPLICATED_OPS["softmax_xent"]``)."""
    return replicated_call("softmax_xent", _token_nll, logits,
                           targets).mean()


def _chunk_step(x: torch.Tensor, tab: torch.Tensor, targets: torch.Tensor,
                m: torch.Tensor, l: torch.Tensor, tgt: torch.Tensor,
                base: int, vocab: int):
    """One vocab chunk: its logits (fp32 products of x's dtype, as
    ``preferred_element_type=jnp.float32``), the running (m, l) and the
    target logit where the target lies in the chunk."""
    chunk = tab.shape[0]
    lg = x.float() @ tab.to(x.dtype).float().T
    valid = (base + torch.arange(chunk, device=x.device)) < vocab
    lg = torch.where(valid, lg, torch.full((), NEG, device=x.device))
    m_new = torch.maximum(m, lg.amax(dim=-1))
    l = l * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
    local = targets - base
    in_chunk = (local >= 0) & (local < chunk)
    picked = torch.take_along_dim(
        lg, local.clamp(0, chunk - 1)[..., None], dim=-1)[..., 0]
    return m_new, l, torch.where(in_chunk, picked, tgt)


def chunked_softmax_xent(x: torch.Tensor, readout: torch.Tensor,
                         targets: torch.Tensor, vocab: int,
                         chunk: int = 8192,
                         transpose_readout: bool = False) -> torch.Tensor:
    """CE without materializing the full logits.

    x (B, S, d) hidden states; readout (Vpad, d) (the tied embedding
    table), or (d, Vpad) with ``transpose_readout``; targets (B, S) <
    vocab.  Mean CE, fp32.
    """
    if transpose_readout:
        readout = readout.T
    vpad, _ = readout.shape
    nc = -(-vpad // chunk)
    table = F.pad(readout, (0, 0, 0, nc * chunk - vpad))
    targets = targets.long()
    B, S = targets.shape
    m = torch.full((B, S), NEG, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    tgt = torch.full((B, S), NEG, dtype=torch.float32, device=x.device)
    for ci in range(nc):
        tab = table[ci * chunk:(ci + 1) * chunk]
        args = (x, tab, targets, m, l, tgt, ci * chunk, vocab)
        if torch.is_grad_enabled():    # recompute the chunk in backward
            m, l, tgt = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, tgt = _chunk_step(*args)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return (lse - tgt).mean()
