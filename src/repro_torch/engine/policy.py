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

The schedule knobs (``tile_h``, ``tile_w``, ``block_c``, ``n_split``,
``stages``, ``path``) override the conv kernel's launch geometry
(``kernels.trim_conv2d.Schedule``); ``tuning`` applies the plan
autotuner's persisted winners per layer (``engine/autotune.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.trim_conv2d import Schedule

#: Substrate choices.
SUBSTRATES = ("auto", "kernel", "oracle", "f32exact")
#: Plan-tuning modes: "off" plans from the policy, "cached" applies the
#: persisted autotuner winners (a miss plans from the policy), "auto"
#: tunes on a miss and persists the winner (``engine/autotune.py``).
TUNING_MODES = ("off", "cached", "auto")


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
    ``tile_h`` / ``tile_w`` / ``block_c`` / ``n_split`` / ``stages`` /
    ``path``
        Overrides of the conv kernel's launch geometry, None (the default)
        leaving each to the lane's planner (``kernels.trim_conv2d.
        f32_tile`` / ``u8_tile``); every layer planned under the policy
        takes them, and one its lane cannot take raises at plan time.
        ``tile_h`` x ``tile_w`` is a block's output tile (both or
        neither), as in the JAX package (fp32: one of ``F32_TILES``;
        u8: at most 128 pixels, 16 x 16 on the slide path); ``block_c``
        the fp32 lane's channels a chunk (JAX's ``block_c``, a channel
        block); ``n_split`` the contiguous ranges the channel sum is cut
        into; ``stages`` the u8 lane's cp.async stages; ``path`` the u8
        lane's path ("window", "gather", "slide").  JAX's ``block_f`` has
        no counterpart (both lanes' filter tile, 64, is compiled in), nor
        its ``vmem_budget``.
    ``tuning``
        "off", "cached" or "auto" (:data:`TUNING_MODES`, the launchers'
        ``--tuning``): under "cached" and "auto" each layer planned with
        ``substrate="auto"`` takes the autotuner's persisted winner for its
        key, "auto" measuring one on a miss.  A pinned substrate plans as
        if tuning were off.
    ``tune_device``
        Where the autotuner measures, and whose cache file it reads:
        "cuda" (the current card; without one tuning raises) or "cpu".
    """

    substrate: str = "auto"
    emulate_hw: bool = False
    tile_h: Optional[int] = None
    tile_w: Optional[int] = None
    block_c: Optional[int] = None
    n_split: Optional[int] = None
    stages: Optional[int] = None
    path: Optional[str] = None
    tuning: str = "off"
    tune_device: str = "cuda"

    def __post_init__(self) -> None:
        if self.substrate not in SUBSTRATES:
            raise ValueError(
                f"substrate {self.substrate!r} not in {SUBSTRATES}")
        if self.tuning not in TUNING_MODES:
            raise ValueError(f"tuning {self.tuning!r} not in {TUNING_MODES}")
        if (self.tile_h is None) != (self.tile_w is None):
            raise ValueError("tile_h and tile_w go together")
        if torch.device(self.tune_device).type not in ("cuda", "cpu"):
            raise ValueError(f"tune_device must be cuda or cpu, got "
                             f"{self.tune_device!r}")
        self.schedule                       # checks the knobs

    @property
    def schedule(self) -> Schedule:
        """The kernel launch overrides the policy's knobs make."""
        return Schedule(
            tile=None if self.tile_h is None else (self.tile_h, self.tile_w),
            block_c=self.block_c, n_split=self.n_split, stages=self.stages,
            path=self.path)

    def with_overrides(self, **kw) -> "ExecutionPolicy":
        return dataclasses.replace(self, **kw)
