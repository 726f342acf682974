"""The public TrIM ops.

Port of ``repro/kernels/ops.py``.  :func:`trim_conv2d` builds a
single-layer :class:`~repro_torch.engine.plan.ConvLayerPlan` from the
call's shapes and an :class:`~repro_torch.engine.policy.ExecutionPolicy`,
then runs it through :func:`repro_torch.engine.execute.run_conv2d`, the
one dispatch site.  :func:`trim_conv1d` (the Mamba short conv),
:func:`flash_attention` (the LM attention core) and :func:`trim_matmul`
(the K = 1 TrIM) need no plan: the policy's substrate alone picks the
kernel's wrapper or the oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.engine.execute import run_conv2d
from repro_torch.engine.plan import plan_conv_layer
from repro_torch.engine.policy import ExecutionPolicy, resolve_substrate
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import trim_conv1d as conv1d_kernel
from repro_torch.kernels import trim_matmul as matmul_kernel


def trim_conv2d(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                requant: Optional[Tuple] = None, *,
                stride: int = 1, padding: Optional[int] = None,
                groups: int = 1, relu: bool = False,
                requant_shift: Optional[int] = None,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """TrIM conv2d. x (N,H,W,C), w (K,K,C/groups,F) -> (N,H_O,W_O,F).

    ``bias`` (F,) / ``relu`` / ``requant_shift`` / ``requant=(mult,
    shift)``: the layer epilogue, fused into the kernel's final write.
    Both requantizations need the integer path and return uint8.
    """
    if requant_shift is not None and requant is not None:
        raise ValueError("requant_shift and requant are exclusive")
    if (requant_shift is not None or requant is not None) \
            and x.is_floating_point():
        raise ValueError("requantization needs the integer path")
    rq_kind = ("shift" if requant_shift is not None
               else "mult_shift" if requant is not None else None)
    plan = plan_conv_layer(
        (int(x.shape[1]), int(x.shape[2])), int(x.shape[3]),
        int(w.shape[0]), int(w.shape[3]), stride=stride, padding=padding,
        groups=groups, relu=relu, has_bias=bias is not None,
        requant_kind=rq_kind, in_sz=x.element_size(),
        w_sz=w.element_size(), out_sz=1 if rq_kind else 4,
        policy=policy or ExecutionPolicy())
    return run_conv2d(plan, x, w, bias, requant, requant_shift=requant_shift)


def trim_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Causal depthwise conv. x (B,L,D), w (K,D) -> (B,L,D).

    The kernel's wrapper (``kernels.trim_conv1d.trim_conv1d``) unless the
    policy resolves to the oracle (``ref.conv1d_causal_ref``)."""
    pol = policy or ExecutionPolicy()
    if resolve_substrate(pol.substrate, x.device) == "oracle":
        return ref.conv1d_causal_ref(x, w)
    return conv1d_kernel.trim_conv1d(x, w)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_length: Optional[torch.Tensor] = None,
                    chunk_k: int = 1024, block_causal: bool = False,
                    policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Streaming-softmax attention. q (B,Sq,H,G,D), k/v (B,Sk,H,D) ->
    (B,Sq,H,G,D); ``kv_length`` (B,) masks the keys of each batch row.

    The kernel's wrapper (``kernels.flash_attention.flash_attention``)
    unless the policy resolves to the oracle
    (``flash_attention_plain``)."""
    pol = policy or ExecutionPolicy()
    kw = dict(causal=causal, q_offset=q_offset, kv_length=kv_length,
              chunk_k=chunk_k, block_causal=block_causal)
    if resolve_substrate(pol.substrate, q.device) == "oracle":
        return flash_kernel.flash_attention_plain(q, k, v, **kw)
    return flash_kernel.flash_attention(q, k, v, **kw)


def trim_matmul(a: torch.Tensor, b: torch.Tensor, *,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Weight-stationary blocked matmul (the K = 1 TrIM case).
    a (M,K) @ b (K,N) -> (M,N): int32 for int8 inputs, else ``a.dtype``
    (fp32 accumulation).

    The kernel's wrapper (``kernels.trim_matmul.trim_matmul``) unless the
    policy resolves to the oracle (its plain version, with the same
    refusals)."""
    pol = policy or ExecutionPolicy()
    if resolve_substrate(pol.substrate, a.device) == "oracle":
        return matmul_kernel.trim_matmul_plain(a, b)
    return matmul_kernel.trim_matmul(a, b)
