"""Fixed-point multiplier + shift requantization.

Semantics (shared bit for bit with the JAX package's Pallas epilogue and
with the CUDA kernel's epilogue):

    requant(acc, m, s) = clip((acc * m + 2**(s-1)) >> s, 0, 255)

i.e. round-half-up of ``acc * m / 2**s``, with a 15-bit multiplier
``1 <= m <= 32767`` and a shift ``1 <= s <= 31``.  The product is taken
in int64, which PyTorch (and the CUDA kernel) have natively.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def requant_mult_shift(acc: torch.Tensor, mult, shift) -> torch.Tensor:
    """``clip((acc * m + 2**(s-1)) >> s, 0, 255)`` in exact int64 math.

    ``acc`` is an int32 tensor; ``mult``/``shift`` are scalars or tensors
    that broadcast against it (per-channel: shape (F,) against NHWF).
    Returns int32 in [0, 255]; the caller casts to uint8.  Both shifts are
    arithmetic.
    """
    a = acc.to(torch.int64)
    m = torch.as_tensor(mult, dtype=torch.int64, device=acc.device)
    s = torch.as_tensor(shift, dtype=torch.int64, device=acc.device)
    r = (a * m + (torch.ones_like(s) << (s - 1))) >> s
    return r.clamp(0, 255).to(torch.int32)


def scale_to_mult_shift(scale) -> Tuple[np.ndarray, np.ndarray]:
    """Float scale(s) -> (mult int32, shift int32) with 15-bit mantissa.

    Picks ``s`` so ``m = round(scale * 2**s)`` lands in [2**14, 2**15)
    (full precision) and clamps to the valid domain ``m in [1, 32767]``,
    ``s in [1, 31]``.  Accepts scalars or arrays (per-channel scales).
    """
    sc = np.maximum(np.asarray(scale, np.float64), 2.0 ** -40)
    e = np.floor(np.log2(sc)).astype(np.int64)
    s = np.clip(14 - e, 1, 31)
    m = np.round(sc * np.exp2(s.astype(np.float64))).astype(np.int64)
    over = m >= 32768
    m = np.where(over, m >> 1, m)
    s = np.where(over, np.maximum(s - 1, 1), s)
    m = np.clip(m, 1, 32767).astype(np.int32)
    return m, s.astype(np.int32)
