"""The oracles the kernels and the model paths are held against: the NHWC
conv (``conv2d``) and its integer form on an fp32 conv path
(``conv2d_exact_f32``, the f32exact substrate's arithmetic), the causal
depthwise conv1d (``conv1d_causal_ref``), the matmul (``matmul_ref``) and
the Mamba2 SSD scan with per-head B/C (``ssd_ref``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: Optional[int] = None, groups: int = 1) -> torch.Tensor:
    """NHWC conv oracle. x (N,H,W,C), w (K,K,C/groups,F) -> (N,H_O,W_O,F).

    Float inputs accumulate in fp32.  Integer inputs are computed exactly
    as a float64 convolution and cast to int32: every partial sum is an
    integer with |psum| <= 255*127*C*K*K < 2**53, so float64 represents
    each one exactly, whatever the order of the sum.  (No integer
    convolution on the GPU is relied on.)
    """
    K = w.shape[0]
    p = K // 2 if padding is None else padding
    integer = not x.is_floating_point()
    dt = torch.float64 if integer else torch.float32
    xc = x.to(dt).permute(0, 3, 1, 2)
    wc = w.to(dt).permute(3, 2, 0, 1)
    if x.is_cuda and not integer and torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "the fp32 oracle needs torch.backends.cudnn.allow_tf32 = False "
            "(repro_torch.engine.policy.fp32_ieee() sets it)")
    out = F.conv2d(xc, wc, stride=stride, padding=p, groups=groups)
    out = out.permute(0, 2, 3, 1).contiguous()
    return out.to(torch.int32) if integer else out


def exact_f32_chunk(x_dtype: torch.dtype, w_dtype: torch.dtype, k: int,
                    w_abs_max: Optional[int] = None) -> int:
    """Channels per chunk of :func:`conv2d_exact_f32`: the most whose
    worst-case partial sum, ``max|x| * max|w| * K * K * chunk``, stays
    below 2**24 (57 for uint8 x int8 at K = 3; 235 with ``w_abs_max`` 31).
    0 where no chunk is exact (or either dtype is not an integer)."""
    if x_dtype.is_floating_point or w_dtype.is_floating_point:
        return 0
    xi, wi = torch.iinfo(x_dtype), torch.iinfo(w_dtype)
    w_bound = max(abs(wi.min), wi.max)
    if w_abs_max is not None:
        w_bound = min(w_bound, int(w_abs_max))
    bound = max(abs(xi.min), xi.max) * w_bound
    return ((1 << 24) // bound) // (k * k) if bound else 0


def conv2d_exact_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     padding: Optional[int] = None, groups: int = 1,
                     w_abs_max: Optional[int] = None,
                     conv=None) -> torch.Tensor:
    """Integer conv evaluated on an fp32 conv path, exactly (port of
    ``repro/kernels/ref.py:45``): the channel sum is cut into chunks of
    :func:`exact_f32_chunk` channels, so every partial sum of a chunk is
    an integer below 2**24 that fp32 holds exactly, each chunk rounds
    back to int32 losslessly, and the int32 chunk sums give the full
    contraction.  Bit-identical to :func:`conv2d` for 8-bit integers.

    ``conv(xc, wc, stride=, padding=)`` is the fp32 conv of one chunk
    (NHWC fp32 x, HWIO fp32 w, contiguous).  Its sum must be direct or a GEMM:
    "exact in any order" holds for sums of the products, not for Winograd
    or FFT, which multiply by constants fp32 cannot hold.  The default is
    the fp32 :func:`conv2d`, whose CPU algorithms are direct or GEMM; on a
    CUDA tensor cuDNN may pick either transform, so there the caller must
    pass ``conv`` (the engine passes the TrIM kernel's fp32 wrapper).

    Float or mixed inputs, and shapes where no chunk is exact, delegate
    to :func:`conv2d`.  ``w_abs_max`` tightens the weight term of the
    bound below the dtype's (the int5 lane's ``|w5| <= 31``); the caller
    owns it: weights past it would break exactness silently.
    """
    K = w.shape[0]
    chunk = exact_f32_chunk(x.dtype, w.dtype, K, w_abs_max)
    if chunk < 1:
        return conv2d(x, w, stride=stride, padding=padding, groups=groups)
    if groups > 1:
        cg, fg = x.shape[-1] // groups, w.shape[-1] // groups
        return torch.cat([
            conv2d_exact_f32(x[..., g * cg:(g + 1) * cg],
                             w[..., g * fg:(g + 1) * fg], stride=stride,
                             padding=padding, w_abs_max=w_abs_max, conv=conv)
            for g in range(groups)], dim=-1)
    if conv is None:
        if x.is_cuda:
            raise ValueError(
                "conv2d_exact_f32 on a CUDA tensor needs conv=: cuDNN's "
                "fp32 algorithms include Winograd and FFT, which are not "
                "exact on integers")
        conv = conv2d
    out = None
    for c0 in range(0, x.shape[-1], chunk):
        o = conv(x[..., c0:c0 + chunk].to(torch.float32).contiguous(),
                 w[:, :, c0:c0 + chunk].to(torch.float32).contiguous(),
                 stride=stride, padding=padding).to(torch.int32)
        out = o if out is None else out + o
    return out


def conv1d_causal_ref(x: torch.Tensor, w: torch.Tensor,
                      acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Causal depthwise conv oracle (the Mamba short conv).

    x (B, L, D), w (K, D) -> (B, L, D):
      out[b, l, d] = sum_k x[b, l - K + 1 + k, d] * w[k, d]
    with implicit left zero padding.  The taps are summed in order
    k = 0..K-1 from zero, each product and each sum rounded to
    ``acc_dtype`` (no fused multiply-add); float results are cast back to
    ``x.dtype`` once.
    """
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x.to(acc_dtype), (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + L, :] * w[k].to(acc_dtype)
    return out.to(x.dtype) if x.is_floating_point() else out


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul oracle: (M, K) @ (K, N).

    Float inputs are multiplied in fp32 (bf16 products are exact there)
    and cast back to ``a.dtype`` once.  Integer inputs give int32,
    computed exactly: in int64 on the CPU, in float64 on the card (every
    partial sum is an integer with |psum| <= 128*128*K < 2**53), then
    wrapped to int32 as an int32 accumulator wraps.  (No integer matmul
    on the GPU is relied on.)
    """
    if not a.is_floating_point():
        wide = torch.int64 if a.device.type == "cpu" else torch.float64
        out = a.to(wide) @ b.to(wide)
        return out.to(torch.int64).to(torch.int32)
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the fp32 oracle needs torch.backends.cuda.matmul.allow_tf32 = "
            "False (repro_torch.engine.policy.fp32_ieee() sets it)")
    return (a.float() @ b.float()).to(a.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
            chunk: int = 256) -> torch.Tensor:
    """SSD oracle: ``nn.mamba.ssd_chunked`` in fp32 with per-head B/C
    (G == H).  x (B,L,H,P); dt (B,L,H); A, D (H,); Bm/Cm (B,L,H,S) ->
    y (B,L,H,P) fp32 (no final state)."""
    from repro_torch.nn.mamba import ssd_chunked

    y, _ = ssd_chunked(x.float(), dt.float(), A.float(), Bm.float(),
                       Cm.float(), D.float(), chunk=chunk)
    return y
