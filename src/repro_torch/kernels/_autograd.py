"""Autograd around the hand kernels that have no backward kernel.

None of the Pallas kernels behind the conv1d, flash-attention, SSD and
matmul wrappers has a backward kernel: the JAX package differentiates the
attention through its pure-JAX ``nn/attention.py:flash_attention`` and the
conv1d through its oracle, and never differentiates the SSD or matmul
kernels.  So the conv1d's and the attention's ``autograd.Function`` run
the kernel forward and take the backward as the VJP of the plain version,
recomputed under autograd (:func:`plain_vjp`); the SSD and matmul
wrappers refuse a caller that needs a gradient (:func:`refuse_grad`)
rather than hand back a detached result.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where a call of kernel ``name`` on ``tensors`` needs a
    gradient: its result would come back detached."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward (the Pallas kernel it ports has none): "
            "call it on tensors that need no gradient, or under "
            "torch.no_grad()")


def plain_vjp(plain: Callable, inputs: Sequence[torch.Tensor],
              needs: Sequence[bool], grad: torch.Tensor,
              ) -> Tuple[Optional[torch.Tensor], ...]:
    """The VJP of ``plain(*inputs)`` against ``grad``, recomputed under
    autograd: a gradient for each input whose ``needs`` is set, None for
    the others."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = plain(*live)
        want = [t for t, n in zip(live, needs) if n]
        got = iter(torch.autograd.grad(out, want, grad) if want else ())
    return tuple(next(got) if n else None for n in needs)
