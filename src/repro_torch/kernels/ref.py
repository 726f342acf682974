"""The oracles the kernels and the model paths are held against: the NHWC
conv (``conv2d``), the causal depthwise conv1d (``conv1d_causal_ref``),
the matmul (``matmul_ref``) and the Mamba2 SSD scan with per-head B/C
(``ssd_ref``)."""
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
