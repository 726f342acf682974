"""TrIM conv2d on Hopper: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/trim_conv2d.py`` (``_trim_conv2d_kernel`` at line
283, driven by ``trim_conv2d_pallas`` at line 347).  The kernel itself is
``repro_torch/csrc/trim_conv2d.cu``; its header says what it keeps out of
device memory and what bounds it.

- :func:`trim_conv2d` is the wrapper: a CUDA tensor launches the kernel
  (or the wrapper raises), a CPU tensor takes :func:`trim_conv2d_plain`.
  Every launch adds one to :data:`LAUNCHES`.
- :func:`trim_conv2d_plain` is the same function in plain PyTorch: the
  ``ref.conv2d`` oracle followed by the unfused :func:`apply_epilogue`.
- :func:`conv_tile` is the GPU's own tile geometry (output tile, channel
  chunk sized to a shared-memory budget, filter tile).  The TPU's VMEM
  width-tile pick and its four-pass halo layout have no counterpart: the
  kernel loads the overlapping haloed window directly.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.requant import requant_mult_shift

#: Launches of the CUDA kernel since the last reset (a plain counter:
#: callers set it to 0 before a run and read it after).
LAUNCHES = 0

#: Output pixels one block computes (tile_h * tile_w may not exceed it)
#: and filters one block computes (block_f may not exceed it); both are
#: compiled into the kernel.
PIX_SLOTS = 128
FILT_TILE = 32
#: Shared memory the channel chunk is sized to (keeps several blocks
#: resident per SM), and the most one block can have on an H100.
SMEM_BUDGET = 48 * 1024
SMEM_MAX = 227 * 1024

_LIB_NAME = "trim_conv2d"
_SOURCES = ("trim_conv2d.cu",)
_BOUND: set = set()  # libraries whose ctypes signatures are declared


@dataclass(frozen=True)
class ConvTile:
    """One conv's launch geometry on the GPU (per conv group)."""

    H_O: int
    W_O: int
    p: int            # symmetric zero padding
    TH: int           # output rows per block
    TW: int           # output cols per block
    n_th: int
    n_tw: int
    Cb: int           # channels per shared-memory chunk
    Fb: int           # filters per block
    n_f: int
    smem_bytes: int


def conv_tile(hw: Tuple[int, int], c: int, k: int, f: int, *, stride: int,
              padding: Optional[int], tile_h: int, tile_w: int,
              block_c: int, block_f: int) -> ConvTile:
    """Geometry for x (N,H,W,c), w (k,k,c,f).  ``block_c``/``block_f`` are
    upper bounds: the channel chunk also shrinks until the haloed window
    plus the weight chunk fit :data:`SMEM_BUDGET` (never below 1)."""
    H, W = int(hw[0]), int(hw[1])
    S = int(stride)
    if S < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    p = k // 2 if padding is None else int(padding)
    H_O = (H + 2 * p - k) // S + 1
    W_O = (W + 2 * p - k) // S + 1
    if H_O < 1 or W_O < 1:
        raise ValueError(f"empty conv output for input {hw}, k={k}, p={p}")
    if tile_h * tile_w > PIX_SLOTS:
        raise ValueError(f"tile_h*tile_w = {tile_h * tile_w} > {PIX_SLOTS}")
    TH, TW = min(tile_h, H_O), min(tile_w, W_O)
    rows, cols = (TH - 1) * S + k, (TW - 1) * S + k
    per_c = 4 * (rows * cols + k * k * FILT_TILE)
    Cb = max(1, min(block_c, c, SMEM_BUDGET // per_c))
    smem = Cb * per_c
    if smem > SMEM_MAX:
        raise ValueError(f"conv tile needs {smem} B of shared memory "
                         f"(> {SMEM_MAX}); lower tile_h/tile_w")
    Fb = min(block_f, f, FILT_TILE)
    return ConvTile(H_O=H_O, W_O=W_O, p=p, TH=TH, TW=TW,
                    n_th=-(-H_O // TH), n_tw=-(-W_O // TW), Cb=Cb, Fb=Fb,
                    n_f=-(-f // Fb), smem_bytes=smem)


def apply_epilogue(out: torch.Tensor, bias: Optional[torch.Tensor],
                   relu: bool, requant_shift: Optional[int],
                   requant=None) -> torch.Tensor:
    """Unfused epilogue: bias -> ReLU -> power-of-two shift or
    multiplier+shift requant (both arithmetic shifts, uint8 out) — the
    fused kernel's order, bit for bit on the integer lane.  ``torch.relu``
    (on int32 too) has gradient 0 at exactly 0, as the custom VJP's
    ``out > 0`` mask does."""
    if bias is not None:
        out = out + bias.to(out.dtype)
    if relu:
        out = torch.relu(out)
    if requant_shift is not None:
        out = (out >> int(requant_shift)).clamp(0, 255).to(torch.uint8)
    if requant is not None:
        out = requant_mult_shift(out, requant[0], requant[1]).to(torch.uint8)
    return out


def trim_conv2d_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                      padding: Optional[int] = None,
                      bias: Optional[torch.Tensor] = None, relu: bool = False,
                      requant_shift: Optional[int] = None,
                      requant=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: oracle conv + epilogue."""
    _check_epilogue(x, requant_shift, requant)
    out = ref.conv2d(x, w, stride=stride, padding=padding)
    return apply_epilogue(out, bias, relu, requant_shift, requant)


def _check_epilogue(x, requant_shift, requant) -> None:
    if requant_shift is not None and requant is not None:
        raise ValueError("requant_shift (power-of-two) and requant "
                         "(mult+shift) are exclusive")
    if (requant_shift is not None or requant is not None) \
            and x.is_floating_point():
        raise ValueError("requantization needs the integer path")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its ctypes
    signatures declared; returns it."""
    lib = _build.load(_LIB_NAME, _SOURCES)
    if lib not in _BOUND:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trim_conv2d_f32.argtypes = [p] * 4 + [i] * 16 + [p]
        lib.trim_conv2d_f32.restype = i
        lib.trim_conv2d_u8s8.argtypes = [p] * 6 + [i] * 18 + [p]
        lib.trim_conv2d_u8s8.restype = i
        lib.trim_conv2d_error_string.argtypes = [i]
        lib.trim_conv2d_error_string.restype = ctypes.c_char_p
        lib.trim_conv2d_pix_slots.restype = i
        lib.trim_conv2d_filt_tile.restype = i
        if (lib.trim_conv2d_pix_slots() != PIX_SLOTS
                or lib.trim_conv2d_filt_tile() != FILT_TILE):
            raise RuntimeError("trim_conv2d library tile constants differ "
                               "from the wrapper's")
        _BOUND.add(lib)
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _per_channel(v, F: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int32, device=device)
    return t.expand(F).contiguous() if t.dim() == 0 else t


def trim_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                padding: Optional[int] = None,
                bias: Optional[torch.Tensor] = None, relu: bool = False,
                requant_shift: Optional[int] = None, requant=None,
                tile_h: int = 8, tile_w: int = 16, block_c: int = 32,
                block_f: int = 32) -> torch.Tensor:
    """TrIM conv. x (N,H,W,C), w (K,K,C,F) -> (N,H_O,W_O,F).

    fp32 x fp32 -> fp32, or uint8 x int8 -> int32 (uint8 with
    ``requant_shift`` or per-channel ``requant=(mult, shift)``).  ``bias``
    (F,) is fp32 on the float lane and int32 on the integer lane.  A CPU
    ``x`` runs :func:`trim_conv2d_plain`; a CUDA ``x`` launches the
    kernel on the current stream, or raises.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return trim_conv2d_plain(x, w, stride=stride, padding=padding,
                                 bias=bias, relu=relu,
                                 requant_shift=requant_shift, requant=requant)
    if x.device.type != "cuda":
        raise ValueError(f"trim_conv2d runs on cuda or cpu, not {x.device}")
    _check_epilogue(x, requant_shift, requant)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be NHWC and w (K,K,C,F): {x.shape}, {w.shape}")
    N, H, W, C = x.shape
    K, K2, Cw, F = w.shape
    if K != K2 or Cw != C:
        raise ValueError(f"weight {tuple(w.shape)} does not fit input "
                         f"{tuple(x.shape)}")
    if N < 1 or F < 1 or N > 65535:
        raise ValueError(f"batch {N} / filters {F} out of range")
    floating = x.dtype == torch.float32 and w.dtype == torch.float32
    integer = x.dtype == torch.uint8 and w.dtype == torch.int8
    if not (floating or integer):
        raise ValueError(f"unsupported dtypes x={x.dtype}, w={w.dtype}: the "
                         "kernel takes float32 x float32 or uint8 x int8")
    tensors = [x, w]
    if bias is not None:
        want = torch.float32 if floating else torch.int32
        if bias.shape != (F,) or bias.dtype != want:
            raise ValueError(f"bias must be ({F},) {want}, got "
                             f"{tuple(bias.shape)} {bias.dtype}")
        tensors.append(bias)
    mult = shift = None
    if requant is not None:
        mult = _per_channel(requant[0], F, x.device)
        shift = _per_channel(requant[1], F, x.device)
        if mult.shape != (F,) or shift.shape != (F,):
            raise ValueError(f"requant pairs must be scalars or ({F},)")
        tensors += [mult, shift]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError("trim_conv2d needs contiguous operands")
    if requant_shift is not None and not 0 <= int(requant_shift) <= 31:
        raise ValueError(f"requant_shift {requant_shift} not in [0, 31]")

    g = conv_tile((H, W), C, K, F, stride=stride, padding=padding,
                  tile_h=tile_h, tile_w=tile_w, block_c=block_c,
                  block_f=block_f)
    if g.n_f > 65535:
        raise ValueError(f"{F} filters need {g.n_f} filter tiles (> 65535)")
    if floating:
        out_dtype = torch.float32
    elif requant_shift is not None or requant is not None:
        out_dtype = torch.uint8
    else:
        out_dtype = torch.int32
    out = torch.empty((N, g.H_O, g.W_O, F), dtype=out_dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        shape = (N, H, W, C, K, F, g.H_O, g.W_O, int(stride), g.p,
                 g.TH, g.TW, g.Cb, g.Fb, int(relu))
        if floating:
            rc = lib.trim_conv2d_f32(_ptr(x), _ptr(w), _ptr(bias), _ptr(out),
                                     *shape, g.smem_bytes, stream)
        else:
            rq_kind = (2 if requant is not None
                       else 1 if requant_shift is not None else 0)
            rc = lib.trim_conv2d_u8s8(
                _ptr(x), _ptr(w), _ptr(bias), _ptr(mult), _ptr(shift),
                _ptr(out), *shape, rq_kind, int(requant_shift or 0),
                g.smem_bytes, stream)
    if rc != 0:
        msg = lib.trim_conv2d_error_string(rc).decode()
        raise RuntimeError(f"trim_conv2d launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES += 1
    return out
