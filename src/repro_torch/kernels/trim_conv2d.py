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
- :func:`f32_tile` is the fp32 lane's geometry, from the per-image shape
  alone (never the batch): the path (the window slid in registers at K =
  3 or 5 and stride 1, else generic), the output tile, the channel chunk
  and stages of the cp.async ring, and the fixed-order channel split of
  the layers whose tiles cannot fill the card (:func:`f32_ranges`).
  :func:`f32_output_map` lists the outputs each thread writes.
- :func:`conv_tile` is the u8 x s8 lane's geometry (output tile, channel
  chunk sized to a shared-memory budget, filter tile).  The TPU's VMEM
  width-tile pick and its four-pass halo layout have no counterpart: both
  lanes load the overlapping haloed window directly.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.requant import requant_mult_shift

#: Launches of the CUDA kernel since the last reset (a plain counter:
#: callers set it to 0 before a run and read it after).
LAUNCHES = 0

#: The u8 x s8 lane: output pixels one block computes (tile_h * tile_w
#: may not exceed it) and filters one block computes (block_f may not
#: exceed it); both are compiled into the kernel.
PIX_SLOTS = 128
FILT_TILE = 32
#: Shared memory the channel chunk is sized to (keeps several blocks
#: resident per SM), and the most one block can have on an H100.
SMEM_BUDGET = 48 * 1024
SMEM_MAX = 227 * 1024

#: The fp32 lane, compiled into the kernel: threads a block, output
#: pixels of one row a thread owns (its run), filters a block (8 groups of
#: 8, one group a thread).
F32_THREADS, F32_RUN, F32_FB = 256, 8, 64
#: Paths: the generic one, and the K (at stride 1) whose window slides in
#: registers.
F32_GENERIC = 0
F32_SLIDE_KS = (3, 5)
#: Output tiles (TH, TW) of 32 runs, in the order ties are broken.
F32_TILES = ((32, 8), (16, 16), (8, 32), (4, 64))
#: Most channels a chunk; stages of the ring, most preferred first.
F32_MAX_CB = 8
F32_STAGES = (3, 2)
#: The H100's SMs and one SM's shared memory; a block that takes at most
#: F32_SMEM_PAIR bytes leaves room for a second (1 KB reserved a block;
#: the kernel is built for two blocks an SM: 128 registers a thread).
SMS = 132
SM_SMEM = 228 * 1024
F32_SMEM_PAIR = SM_SMEM // 2 - 1024
#: A split range holds at least this many (channel, tap) rows.
F32_MIN_RANGE_TAPS = 96

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


def fewest_ranges(items: int, tiles: int, slots: int, cap: int) -> int:
    """The fewest ranges that minimise the makespan of ``items`` cut into
    ranges over ``tiles`` output tiles: waves of ``slots`` blocks times
    the items of the longest range (past two waves' worth of ranges it
    only grows); never more than ``cap`` or ``items``."""
    best = (None, 1)
    top = min(items, cap, 2 * -(-slots // tiles) + 1)
    for s in range(1, max(1, top) + 1):
        span = -(-tiles * s // slots) * -(-items // s)
        if best[0] is None or span < best[0]:
            best = (span, s)
    return best[1]


@dataclass(frozen=True)
class F32Tile:
    """One fp32 conv's launch geometry on the GPU (per conv group)."""

    H_O: int
    W_O: int
    p: int            # symmetric zero padding
    path: int         # F32_GENERIC, or the K of a stride-1 sliding path
    TH: int           # output rows per block
    TW: int           # output cols per block (a multiple of F32_RUN)
    n_th: int
    n_tw: int
    n_f: int          # filter tiles of F32_FB
    rows: int         # the haloed window of one tile
    cols: int
    RS: int           # floats between window rows (cols rounded up to 4)
    plane: int        # floats of one channel's window (4 mod 32)
    Cb: int           # channels per chunk
    n_chunks: int
    stages: int       # cp.async ring stages (2 or 3)
    n_split: int      # contiguous ranges of chunks the channel sum is cut into
    smem_bytes: int


def _f32_smem(stages: int, Cb: int, plane: int, K: int) -> int:
    return 4 * stages * Cb * (plane + K * K * F32_FB)


@functools.lru_cache(maxsize=256)
def f32_tile(hw: Tuple[int, int], c: int, k: int, f: int, *, stride: int,
             padding: Optional[int]) -> F32Tile:
    """The fp32 lane's geometry for x (·,H,W,c), w (k,k,c,f), from the
    per-image shape alone: the batch never enters, so every output's sum
    runs in one order in every batch (bucketed == unbatched, bit for bit).
    The policy's ``tile_h``/``tile_w``/``block_c``/``block_f`` do not
    apply to this lane.

    The output tile is the one of :data:`F32_TILES` with the fewest padded
    pixels, then the smallest window.  The chunk is the most channels (up
    to :data:`F32_MAX_CB`) whose 3 stages, else 2, fit
    :data:`F32_SMEM_PAIR` (two blocks an SM), else one channel in 2
    stages up to :data:`SMEM_MAX`.  Where one image's tiles x filter tiles
    do not give every SM a block, the chunks are cut into the fewest
    contiguous ranges that minimise the makespan with one block an SM
    (:func:`fewest_ranges`), no more ranges than give every SM one block,
    each range at least :data:`F32_MIN_RANGE_TAPS` (channel, tap) rows.
    One block an SM, not the two that fit: each range's partials cost a
    write and a read of the output, which at the train phase's batch of 8
    outweighs a fuller card, and the split depends on the image alone.
    """
    H, W = int(hw[0]), int(hw[1])
    S, K, C, F = int(stride), int(k), int(c), int(f)
    if S < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    p = K // 2 if padding is None else int(padding)
    H_O = (H + 2 * p - K) // S + 1
    W_O = (W + 2 * p - K) // S + 1
    if H_O < 1 or W_O < 1:
        raise ValueError(f"empty conv output for input {hw}, k={K}, p={p}")
    path = K if S == 1 and K in F32_SLIDE_KS else F32_GENERIC
    best = None
    for TH, TW in F32_TILES:
        rows, cols = (TH - 1) * S + K, (TW - 1) * S + K
        RS = -(-cols // 4) * 4
        plane = rows * RS + (4 - rows * RS) % 32
        n_th, n_tw = -(-H_O // TH), -(-W_O // TW)
        key = (n_th * TH * n_tw * TW, rows * RS)
        if _f32_smem(2, 1, plane, K) <= SMEM_MAX and (
                best is None or key < best[0]):
            best = (key, TH, TW, rows, cols, RS, plane, n_th, n_tw)
    if best is None:
        raise ValueError(f"no fp32 conv tile fits K={K}, S={S} in "
                         f"{SMEM_MAX} bytes of shared memory")
    _, TH, TW, rows, cols, RS, plane, n_th, n_tw = best
    fit = next(((st, cb) for st in F32_STAGES
                for cb in range(min(C, F32_MAX_CB), 0, -1)
                if _f32_smem(st, cb, plane, K) <= F32_SMEM_PAIR), (2, 1))
    stages, Cb = fit
    smem = _f32_smem(stages, Cb, plane, K)
    n_chunks, n_f = -(-C // Cb), -(-F // F32_FB)
    tiles = n_th * n_tw * n_f
    n_split = 1
    if tiles < SMS:
        cap = n_chunks // -(-F32_MIN_RANGE_TAPS // (Cb * K * K))
        n_split = fewest_ranges(n_chunks, tiles, SMS,
                                min(max(1, cap), -(-SMS // tiles),
                                    65535 // n_f))
    return F32Tile(H_O=H_O, W_O=W_O, p=p, path=path, TH=TH, TW=TW,
                   n_th=n_th, n_tw=n_tw, n_f=n_f, rows=rows, cols=cols,
                   RS=RS, plane=plane, Cb=Cb, n_chunks=n_chunks,
                   stages=stages, n_split=n_split, smem_bytes=smem)


def f32_ranges(t: F32Tile, c: int):
    """The channel ranges ``[(c0, c1), ...]`` of the n_split blocks of a
    tile, in split order (the kernel's: chunks ``n_chunks * s // n_split``
    up to ``n_chunks * (s + 1) // n_split``)."""
    return [(t.n_chunks * s // t.n_split * t.Cb,
             min(c, t.n_chunks * (s + 1) // t.n_split * t.Cb))
            for s in range(t.n_split)]


def f32_output_map(t: F32Tile, f: int):
    """Every output the kernel's threads write for one image and one split
    range, as flat index tensors ``(ho, wo, filter)``: block (tile, filter
    tile), thread (filter group = tid % 8, run = tid // 8 at row run //
    (TW/8), column (run % (TW/8)) * 8), accumulator (pixel p of the run,
    filter j of the group), those inside H_O x W_O x f."""
    tile = torch.arange(t.n_th * t.n_tw).view(-1, 1, 1, 1, 1)
    ft = torch.arange(t.n_f).view(1, -1, 1, 1, 1)
    tid = torch.arange(F32_THREADS).view(1, 1, -1, 1, 1)
    pix = torch.arange(F32_RUN).view(1, 1, 1, -1, 1)
    j = torch.arange(8).view(1, 1, 1, 1, -1)
    rpr = t.TW // F32_RUN
    run = tid // 8
    ho = (tile // t.n_tw) * t.TH + run // rpr
    wo = (tile % t.n_tw) * t.TW + (run % rpr) * F32_RUN + pix
    fo = ft * F32_FB + (tid % 8) * 8 + j
    ho, wo, fo = torch.broadcast_tensors(ho, wo, fo)
    keep = (ho < t.H_O) & (wo < t.W_O) & (fo < f)
    return ho[keep], wo[keep], fo[keep]


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
        lib.trim_conv2d_f32.argtypes = [p] * 5 + [i] * 21 + [p]
        lib.trim_conv2d_f32.restype = i
        lib.trim_conv2d_u8s8.argtypes = [p] * 6 + [i] * 18 + [p]
        lib.trim_conv2d_u8s8.restype = i
        lib.trim_conv2d_error_string.argtypes = [i]
        lib.trim_conv2d_error_string.restype = ctypes.c_char_p
        for name in ("pix_slots", "filt_tile", "f32_threads",
                     "f32_filters"):
            getattr(lib, f"trim_conv2d_{name}").restype = i
        if (lib.trim_conv2d_pix_slots() != PIX_SLOTS
                or lib.trim_conv2d_filt_tile() != FILT_TILE
                or lib.trim_conv2d_f32_threads() != F32_THREADS
                or lib.trim_conv2d_f32_filters() != F32_FB):
            raise RuntimeError("trim_conv2d library tile constants differ "
                               "from the wrapper's")
        _BOUND.add(lib)
    return lib


@functools.lru_cache(maxsize=256)
def f32_launch_args(x_shape: Tuple[int, int, int, int], K: int, F: int,
                    S: int, padding: Optional[int], w_aligned: bool):
    """The fp32 geometry and the C function's integer arguments for one
    call's shape (cached: the wrapper's host time bounds the small
    shapes).  The geometry does not depend on the batch ``x_shape[0]``."""
    N, H, W, C = x_shape
    t = f32_tile((H, W), C, K, F, stride=S, padding=padding)
    return t, (N, H, W, C, K, F, t.H_O, t.W_O, S, t.p, t.path, t.TH, t.TW,
               t.Cb, t.n_split, t.stages, t.RS, t.plane,
               int(F % 4 == 0 and w_aligned))


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
    kernel on the current stream, or raises.  ``tile_h``/``tile_w``/
    ``block_c``/``block_f`` shape the integer lane only; the fp32 lane
    plans its own geometry from the per-image shape (:func:`f32_tile`),
    and where it splits the channel sum, one call launches the conv and
    the kernel that merges its partials (one count in :data:`LAUNCHES`).
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

    lib = load_library()
    if floating:
        t, args = f32_launch_args((N, H, W, C), K, F, int(stride), padding,
                                  w.data_ptr() % 16 == 0)
        if t.n_f * t.n_split > 65535:
            raise ValueError(f"{F} filters need {t.n_f} filter tiles "
                             f"(x {t.n_split} ranges > 65535)")
        out = torch.empty((N, t.H_O, t.W_O, F), dtype=torch.float32,
                          device=x.device)
        parts = (None if t.n_split == 1 else torch.empty(
            (t.n_split, N, t.H_O, t.W_O, F), dtype=torch.float32,
            device=x.device))
        with torch.cuda.device(x.device):
            rc = lib.trim_conv2d_f32(
                _ptr(x), _ptr(w), _ptr(bias), _ptr(out), _ptr(parts), *args,
                int(relu), t.smem_bytes,
                torch.cuda.current_stream(x.device).cuda_stream)
    else:
        g = conv_tile((H, W), C, K, F, stride=stride, padding=padding,
                      tile_h=tile_h, tile_w=tile_w, block_c=block_c,
                      block_f=block_f)
        if g.n_f > 65535:
            raise ValueError(f"{F} filters need {g.n_f} filter tiles "
                             "(> 65535)")
        out_dtype = (torch.uint8 if requant_shift is not None
                     or requant is not None else torch.int32)
        out = torch.empty((N, g.H_O, g.W_O, F), dtype=out_dtype,
                          device=x.device)
        rq_kind = (2 if requant is not None
                   else 1 if requant_shift is not None else 0)
        with torch.cuda.device(x.device):
            rc = lib.trim_conv2d_u8s8(
                _ptr(x), _ptr(w), _ptr(bias), _ptr(mult), _ptr(shift),
                _ptr(out), N, H, W, C, K, F, g.H_O, g.W_O, int(stride), g.p,
                g.TH, g.TW, g.Cb, g.Fb, int(relu), rq_kind,
                int(requant_shift or 0), g.smem_bytes,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.trim_conv2d_error_string(rc).decode()
        raise RuntimeError(f"trim_conv2d launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES += 1
    return out
