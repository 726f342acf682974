"""Execution policy: how to run the TrIM conv, decided in one place.

Port of ``repro/engine/policy.py``.  The dispatch rule lives in
:func:`resolve_substrate` and nowhere else, and it reads
only the device of the tensor being convolved — never the machine:

- ``"auto"`` / ``"kernel"``: the CUDA kernel's wrapper
  (``kernels.trim_conv2d.trim_conv2d``, ``kernels.trim_conv1d.trim_conv1d``,
  ``kernels.flash_attention.flash_attention``,
  ``kernels.trim_matmul.trim_matmul``),
  which launches the kernel on a CUDA tensor and runs its plain version
  on a CPU tensor;
- ``"oracle"``: the plain PyTorch version on every device;
- ``"f32exact"``: integer convs computed exactly on the fp32 conv path,
  cut into channel chunks whose partial sums stay below 2**24
  (``kernels.ref.conv2d_exact_f32``): each chunk runs through the TrIM
  kernel's fp32 wrapper, which launches its fp32 lane on a CUDA tensor
  (never cuDNN, whose Winograd and FFT algorithms are not exact) and runs
  the plain fp32 conv on a CPU tensor.  Float convs take the oracle; the
  other ops take their kernel's wrapper.

``emulate_hw`` replays the FPGA's strided-layer schedule: a stride-1
sweep, decimation and the unfused epilogue (``ConvLayerPlan.decimate``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

#: Substrate choices.
SUBSTRATES = ("auto", "kernel", "oracle", "f32exact")
#: The bounds :class:`ExecutionPolicy` holds its tile knobs to, as the JAX
#: package's policy does (``tile_h * tile_w`` and ``block_f``).  No CUDA
#: launch reads them: both conv lanes plan their own geometry.
PIX_SLOTS = 128
FILT_TILE = 32


def resolve_substrate(substrate: str, device) -> str:
    """THE dispatch rule — the only copy in the port: "oracle" runs the
    plain version anywhere; "auto" runs the kernel's wrapper on a CUDA
    tensor and the plain version on a CPU tensor; "kernel" always runs the
    wrapper (which itself takes the plain version for a CPU tensor);
    "f32exact" stays "f32exact" on every device (``execute.run_conv2d``
    runs its chunks through the fp32 wrapper)."""
    if substrate in ("oracle", "f32exact"):
        return substrate
    if substrate == "auto" and torch.device(device).type != "cuda":
        return "oracle"
    return "kernel"


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` without a usable
    card raises; the port never falls back to the CPU on its own.
    ``"meta"`` (shapes and dtypes, no data) is accepted for model init."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def fp32_ieee() -> None:
    """Keep fp32 IEEE on the card: PyTorch's fp32 matmuls and cuDNN's fp32
    convolutions may otherwise take TF32, and bf16 matmuls reduced-
    precision (split-K) reductions.  The FC head (``torch.matmul``), the
    LM projections and the fp32 oracle conv are held to full fp32 sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@dataclass(frozen=True)
class ExecutionPolicy:
    """Frozen, hashable description of how to run the TrIM conv.

    ``substrate``
        "auto" (the default), "kernel", "oracle" or "f32exact" — see the
        module doc.
    ``emulate_hw``
        Replay the FPGA's strided-layer schedule (stride-1 sweep +
        decimation + unfused epilogue, paper §V) instead of the strided
        fused conv.  Forward only on the kernel substrate.
    ``tile_h`` / ``tile_w`` / ``block_c`` / ``block_f``
        The JAX package's tile knobs (``tile_h * tile_w <= 128``,
        ``block_f <= 32``), kept and checked so that a policy means the
        same in both packages.  They shape no CUDA launch: the conv
        kernel's fp32 lane plans its geometry with
        ``kernels.trim_conv2d.f32_tile`` and its integer lane with
        ``kernels.trim_conv2d.u8_tile``; ``ConvLayerPlan.tile`` is the
        latter's.
    """

    substrate: str = "auto"
    emulate_hw: bool = False
    tile_h: int = 8
    tile_w: int = 16
    block_c: int = 32
    block_f: int = 32

    def __post_init__(self) -> None:
        if self.substrate not in SUBSTRATES:
            raise ValueError(
                f"substrate {self.substrate!r} not in {SUBSTRATES}")
        if min(self.tile_h, self.tile_w, self.block_c, self.block_f) < 1:
            raise ValueError("tile and block sizes must be >= 1")
        if self.tile_h * self.tile_w > PIX_SLOTS:
            raise ValueError(
                f"tile_h * tile_w must be <= {PIX_SLOTS}, got "
                f"{self.tile_h * self.tile_w}")
        if self.block_f > FILT_TILE:
            raise ValueError(f"block_f must be <= {FILT_TILE}")

    def with_overrides(self, **kw) -> "ExecutionPolicy":
        return dataclasses.replace(self, **kw)
