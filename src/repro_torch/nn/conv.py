"""The paper's CNNs (VGG-16 / AlexNet) on the TrIM conv kernel.

Port of ``repro/nn/conv.py:44-156`` (``cnn_forward`` and ``cnn_loss``
take only ``policy``, not the deprecated ``emulate_hw``/``force_pallas``
keywords): ``CNNConfig`` is pure architecture; how it runs is an
``ExecutionPolicy`` compiled by ``plan_model`` into per-layer plans.
Params keep the JAX package's tree and layouts:
``{"conv": [{"kernel": (K,K,C/groups,F), "bias": (F,)}], "fc":
[{"kernel": (in,out), "bias": (out,)}]}``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.core.model import ALEXNET_LAYERS, VGG16_LAYERS, ConvLayerSpec
from repro_torch.core.quant import msr_compress, msr_operand
from repro_torch.engine.plan import plan_model
from repro_torch.engine.policy import ExecutionPolicy, resolve_device

Params = dict


@dataclass(frozen=True)
class CNNConfig:
    """Pure architecture: what to run (execution policy rides separately)."""

    name: str
    layers: Tuple[ConvLayerSpec, ...]
    pool_after: Tuple[int, ...]          # indices (into layers) with 2x2 pool
    classifier: Tuple[int, ...]          # hidden dims of the FC head
    n_classes: int = 1000
    input_hw: Tuple[int, int] = (224, 224)


VGG16_CNN = CNNConfig(
    "vgg16", VGG16_LAYERS, pool_after=(1, 3, 6, 9, 12),
    classifier=(4096, 4096), input_hw=(224, 224))

ALEXNET_CNN = CNNConfig(
    "alexnet", ALEXNET_LAYERS, pool_after=(0, 1, 4),
    classifier=(4096, 4096), input_hw=(227, 227))


def init_cnn(generator: Union[torch.Generator, int], cfg: CNNConfig,
             device="cuda", dtype=torch.float32) -> Params:
    """He-normal conv kernels, 1/sqrt(fan_in) FC kernels, zero biases,
    drawn from ``generator`` (a ``torch.Generator`` on ``device``, or an
    int seed for one; on the CPU for the ``meta`` device, which gives
    shapes and dtypes only)."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(
            device="cpu" if dev.type == "meta" else dev).manual_seed(generator)

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (t * std).to(dtype)

    p: Params = {"conv": [], "fc": []}
    feat_hw = cfg.input_hw
    c_in = cfg.layers[0].M
    for i, l in enumerate(cfg.layers):
        fan_in = l.K * l.K * l.M
        p["conv"].append({
            "kernel": normal((l.K, l.K, l.M, l.N), (2.0 / fan_in) ** 0.5),
            "bias": torch.zeros((l.N,), dtype=dtype, device=dev)})
        feat_hw = (l.H_O, l.W_O)
        if i in cfg.pool_after:
            feat_hw = (feat_hw[0] // 2, feat_hw[1] // 2)
        c_in = l.N
    flat = feat_hw[0] * feat_hw[1] * c_in
    dims = (flat,) + cfg.classifier + (cfg.n_classes,)
    for i in range(len(dims) - 1):
        p["fc"].append({
            "kernel": normal((dims[i], dims[i + 1]), dims[i] ** -0.5),
            "bias": torch.zeros((dims[i + 1],), dtype=dtype, device=dev)})
    return p


def cnn_forward(params: Params, images: torch.Tensor, cfg: CNNConfig,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """images (B,H,W,C) float -> logits (B, n_classes) through the
    planned conv stack (each conv fused with its bias and ReLU)."""
    plan = plan_model(cfg, policy or ExecutionPolicy(),
                      c_in=int(images.shape[-1]))
    return plan.forward(params, images)


def cnn_loss(params: Params, batch, cfg: CNNConfig,
             policy: Optional[ExecutionPolicy] = None):
    """(ce, {"ce", "acc"}) of ``batch`` = {"images", "labels"}; on the
    kernel substrate its gradient runs the TrIM backward kernels."""
    plan = plan_model(cfg, policy or ExecutionPolicy(),
                      c_in=int(batch["images"].shape[-1]))
    return plan.loss(params, batch)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """One float conv weight -> symmetric per-tensor int8 and its scale.
    fp32 ``amax / 127`` and round-half-even, as the JAX package does, so
    the same float weights give the same int8 bits."""
    w = w.to(torch.float32)
    s = w.abs().max().clamp_min(1e-8) / 127.0
    return torch.round(w / s).clamp(-127, 127).to(torch.int8), float(s)


def quantize_cnn(params: Params, cfg: CNNConfig) -> Tuple[Params, List[float]]:
    """Float conv weights -> symmetric per-tensor int8 (`quantize_weight`
    per layer); returns (int params, scales)."""
    qp: Params = {"conv": []}
    scales: List[float] = []
    for i in range(len(cfg.layers)):
        qw, s = quantize_weight(params["conv"][i]["kernel"])
        qp["conv"].append({"kernel": qw})
        scales.append(s)
    return qp, scales


def quantize_cnn_int5(params: Params, cfg: CNNConfig, compensate: bool = True
                      ) -> Tuple[Params, List[float]]:
    """Float conv weights -> the int5 MSR lane's runtime params.

    :func:`quantize_cnn`, then each int8 kernel is compressed to sign +
    4-bit most-significant-run codes with one shift per output channel
    (``core.quant.msr_compress``) and factored as ``w_hat == w5 << e``
    (``core.quant.msr_operand``; ``compensate`` appends the expect-value
    bit, ``False`` is plain truncation).  Each conv entry is ``{"kernel":
    w5 (K,K,C,F) int8 with |w5| <= 31, "shift": e (F,) int32}`` on the
    params' device.  The scales are the int8 lane's.
    """
    qp8, scales = quantize_cnn(params, cfg)
    qp: Params = {"conv": []}
    for entry in qp8["conv"]:
        w8 = entry["kernel"]
        codes, shifts = msr_compress(w8.cpu().numpy())
        w5, e = msr_operand(codes, shifts, compensate=compensate)
        qp["conv"].append({"kernel": torch.from_numpy(w5).to(w8.device),
                           "shift": torch.from_numpy(e).to(w8.device)})
    return qp, scales


class ConvNet(nn.Module):
    """A planned CNN with its params held as module buffers (so ``.to``
    moves them); ``forward`` runs the float lane."""

    def __init__(self, cfg: CNNConfig, params: Params,
                 policy: ExecutionPolicy = ExecutionPolicy()):
        super().__init__()
        self.cfg = cfg
        self.plan = plan_model(cfg, policy)
        self._names = {}
        for part in ("conv", "fc"):
            self._names[part] = []
            for i, layer in enumerate(params[part]):
                names = {}
                for k, v in layer.items():
                    name = f"{part}{i}_{k}"
                    self.register_buffer(name, v)
                    names[k] = name
                self._names[part].append(names)

    def params(self) -> Params:
        return {part: [{k: getattr(self, n) for k, n in names.items()}
                       for names in layers]
                for part, layers in self._names.items()}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.plan.forward(self.params(), images)
