"""TrIM conv2d on Hopper: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/trim_conv2d.py`` (``_trim_conv2d_kernel`` at line
283, driven by ``trim_conv2d_pallas`` at line 347).  The kernel itself is
``repro_torch/csrc/trim_conv2d.cu``; its header says what it keeps out of
device memory and what bounds it.

- :func:`trim_conv2d` is the wrapper: a CUDA tensor launches the kernel
  (or the wrapper raises), a CPU tensor takes :func:`trim_conv2d_plain`.
  Every launch adds one to :data:`LAUNCHES` and to its lane's count in
  :data:`LAUNCHES_BY_LANE`.  Lanes: fp32, bf16 (fp32 sums, rounded once)
  and u8 x s8.
- :func:`trim_conv2d_plain` is the same function in plain PyTorch: the
  ``ref.conv2d`` oracle followed by the unfused :func:`apply_epilogue`,
  a float result rounded once to x's dtype.
- :func:`f32_tile` is the fp32 lane's geometry, from the per-image shape
  alone (never the batch): the path (the window slid in registers at K =
  3 or 5 and stride 1, else generic), the output tile, the channel chunk
  and stages of the cp.async ring, and the fixed-order channel split of
  the layers whose tiles cannot fill the card (:func:`f32_ranges`).
  :func:`f32_output_map` lists the outputs each thread writes.
- :func:`u8_tile` is the u8 x s8 lane's geometry (the tensor-core
  implicit GEMM), from the shape and the batch: the path (the window's
  shifted views; at K = 3 and stride 1 where its tiles fill the card,
  window rows reused across taps in registers; or, where C <= 8, the
  im2col rows gathered from the window), the output tile, the steps of
  an item and the stages of the cp.async ring, and the channel split of
  the layers whose tiles cannot fill the card (:func:`u8_ranges`).
  :func:`u8_output_map` lists the outputs each warp writes.
  :func:`bf16_tile` is the bf16 lane's: the same planner on 2-byte
  elements (16 channels a k-step), from the per-image shape alone, no
  slide path, no weight pre-pass.  The u8 lane's
  weights, transposed so that the depth is contiguous, are written once
  per weight tensor and kept while it lives unchanged
  (:func:`u8_weights`).  The TPU's VMEM width-tile pick and its four-pass halo
  layout have no counterpart: both lanes load the overlapping haloed
  window directly.
- :class:`Schedule` overrides what the planners choose (the output tile,
  the fp32 chunk, the split, the u8 stages and path); each override is
  checked against the shape and raises where the kernel cannot take it.
  The plan autotuner (``engine/autotune.py``) searches these.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.requant import requant_mult_shift

#: Launches of the CUDA kernel since the last reset (a plain counter:
#: callers set it to 0 before a run and read it after).
LAUNCHES = 0
#: The same launches by lane ("f32", "bf16", "u8"), reset alike
LAUNCHES_BY_LANE = {"f32": 0, "bf16": 0, "u8": 0}
#: u8 x s8 launches that also wrote their transposed weights (the weight
#: pre-pass; :func:`u8_weights` had no kept buffer), since the last reset
PREPASSES = 0

#: The most shared memory one block can have on an H100.
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
#: SMEM_PAIR bytes leaves room for a second (1 KB reserved a block; both
#: lanes are built for two blocks an SM: 128 registers a thread).
SMS = 132
SM_SMEM = 228 * 1024
SMEM_PAIR = SM_SMEM // 2 - 1024
#: A split range holds at least this many (channel, tap) rows.
F32_MIN_RANGE_TAPS = 96

#: The u8 x s8 lane, compiled into the kernel: threads a block (8 warps
#: of 32 pixels x 32 filters), output pixels and filters a block, depth
#: bytes a tensor-core step (mma m16n8k32), and the most K*K*C whose sum
#: cannot leave int32 (255 * 128 * K*K*C < 2^31).
U8_THREADS, U8_M, U8_FB, U8_STEP = 256, 128, 64, 32
U8_MAX_DEPTH = 65793
#: Paths: ldmatrix reads the window's shifted views (C > U8_GATHER_MAX_C);
#: the im2col rows are gathered from the window (C <= 8: a 32-channel
#: chunk would do 4x the work or more); or, at K = 3 and stride 1 (C > 8)
#: where its tiles fill the card, the slide path: 16 x 16-pixel blocks
#: whose warps own 4 output rows each and reuse every window row they
#: load for up to 3 taps.
U8_WINDOW, U8_GATHER, U8_SLIDE = 0, 1, 2
U8_GATHER_MAX_C = 8
U8_SLIDE_TILE = 16
#: Gather path: most depth steps a chunk.  Stages of the ring, most
#: preferred first.  A split range holds at least this many steps.
U8_GATHER_STEPS = 4
U8_STAGES = (3, 2)
U8_MIN_RANGE_STEPS = 16

#: The bf16 lane's wgmma window path, compiled into the kernel: output
#: pixels a block (two consumer warpgroups of 64), the filters a block may
#: take (its template instances), channels a chunk (one 128-byte TMA row),
#: the most cluster blocks a split may have (the portable cluster size) and
#: the weight ring's stages, most preferred first; a TMA box's most
#: elements a dimension.
BF16_PIX = 128
BF16_FB = (128, 64)
BF16_CHUNK = 64
BF16_MAX_SPLIT = 8
BF16_STAGES = (4, 3, 2)
#: The planner's own cap on the split's cluster: on the H100 clusters of
#: 4 and 8 ran VGG-16's batch-8 convs slower than clusters of 2 (fewer
#: large clusters are resident at once; ``tools/bf16_conv_times.py
#: --caps``); a ``Schedule`` may still ask for up to BF16_MAX_SPLIT.
BF16_SPLIT_CAP = 2
TMA_BOX_MAX = 256

_LIB_NAME = "trim_conv2d"
_SOURCES = ("trim_conv2d.cu",)
_BOUND: set = set()  # libraries whose ctypes signatures are declared

#: The integer lane's transposed weights, kept per weight tensor:
#: id(w) -> (weak reference to w, {layout key: ((version, address), wt)}).
_WT: dict = {}


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


#: The integer lane's path names, by their number.
U8_PATH_NAMES = ("window", "gather", "slide")


@dataclass(frozen=True)
class Schedule:
    """Overrides of one conv's launch geometry; None leaves a knob to its
    planner (:func:`f32_tile`, :func:`u8_tile`).

    ``tile`` (TH, TW), the output tile of a block (fp32: one of
    :data:`F32_TILES`; u8: TH * TW <= :data:`U8_M`, 16 x 16 on the slide
    path); ``block_c``, the fp32 lane's channels a chunk; ``n_split``, the
    contiguous ranges the channel sum is cut into (both lanes); ``stages``,
    the u8 and bf16 lanes' cp.async ring stages (:data:`U8_STAGES`);
    ``path``, the u8 and bf16 lanes' path (:data:`U8_PATH_NAMES`; bf16 has
    no slide path).  A knob the lane does not have is ignored on the u8
    (``block_c``) and fp32 (``stages``/``path``) lanes and raises on the
    bf16 lane (``block_c``).
    """

    tile: Optional[Tuple[int, int]] = None
    block_c: Optional[int] = None
    n_split: Optional[int] = None
    stages: Optional[int] = None
    path: Optional[str] = None

    def __post_init__(self):
        if self.tile is not None:
            object.__setattr__(self, "tile", tuple(int(v)
                                                   for v in self.tile))
            if len(self.tile) != 2 or min(self.tile) < 1:
                raise ValueError(f"tile must be (TH, TW) >= 1, got "
                                 f"{self.tile}")
        for name in ("block_c", "n_split", "stages"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name} must be an int >= 1, got {v!r}")
        if self.path is not None and self.path not in U8_PATH_NAMES:
            raise ValueError(f"path {self.path!r} not in {U8_PATH_NAMES}")

    @property
    def default(self) -> bool:
        return self == Schedule()

    def f32(self) -> dict:
        """:func:`f32_tile`'s keyword overrides."""
        return dict(tile=self.tile, block_c=self.block_c,
                    n_split=self.n_split)

    def u8(self) -> dict:
        """:func:`u8_tile`'s keyword overrides."""
        return dict(path=(None if self.path is None
                          else U8_PATH_NAMES.index(self.path)),
                    tile=self.tile, n_split=self.n_split,
                    stages=self.stages)

    def bf16(self) -> dict:
        """:func:`bf16_tile`'s keyword overrides; ``block_c``, a knob the
        bf16 lane does not have, raises."""
        if self.block_c is not None:
            raise ValueError("the bf16 lane has no block_c (its k-step is "
                             "16 channels)")
        return self.u8()


def _check_split(n_split: int, n_items: int, n_f: int, what: str) -> None:
    if not 1 <= n_split <= n_items:
        raise ValueError(f"n_split {n_split} not in [1, {n_items}] "
                         f"({what})")
    if n_f * n_split > 65535:
        raise ValueError(f"n_split {n_split} x {n_f} filter tiles > 65535 "
                         "grid rows")


@functools.lru_cache(maxsize=256)
def f32_tile(hw: Tuple[int, int], c: int, k: int, f: int, *, stride: int,
             padding: Optional[int], tile: Optional[Tuple[int, int]] = None,
             block_c: Optional[int] = None,
             n_split: Optional[int] = None) -> F32Tile:
    """The fp32 lane's geometry for x (·,H,W,c), w (k,k,c,f), from the
    per-image shape alone: the batch never enters, so every output's sum
    runs in one order in every batch (bucketed == unbatched, bit for bit).
    ``tile`` (one of :data:`F32_TILES`), ``block_c`` (the chunk) and
    ``n_split`` override the choices below; each is checked (the tile's
    window and the chunk's ring in :data:`SMEM_MAX`, the split within the
    chunks and the grid) and raises where it does not fit.

    The output tile is the one of :data:`F32_TILES` with the fewest padded
    pixels, then the smallest window.  The chunk is the most channels (up
    to :data:`F32_MAX_CB`) whose 3 stages, else 2, fit
    :data:`SMEM_PAIR` (two blocks an SM), else one channel in 2
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
    if tile is not None and tuple(tile) not in F32_TILES:
        raise ValueError(f"fp32 tile {tuple(tile)} not in {F32_TILES}")
    best = None
    for TH, TW in ((tuple(tile),) if tile is not None else F32_TILES):
        rows, cols = (TH - 1) * S + K, (TW - 1) * S + K
        RS = -(-cols // 4) * 4
        plane = rows * RS + (4 - rows * RS) % 32
        n_th, n_tw = -(-H_O // TH), -(-W_O // TW)
        key = (n_th * TH * n_tw * TW, rows * RS)
        if _f32_smem(2, 1, plane, K) <= SMEM_MAX and (
                best is None or key < best[0]):
            best = (key, TH, TW, rows, cols, RS, plane, n_th, n_tw)
    if best is None:
        raise ValueError(f"no fp32 conv tile {'' if tile is None else tile} "
                         f"fits K={K}, S={S} in {SMEM_MAX} bytes of shared "
                         "memory")
    _, TH, TW, rows, cols, RS, plane, n_th, n_tw = best
    if block_c is None:
        fit = next(((st, cb) for st in F32_STAGES
                    for cb in range(min(C, F32_MAX_CB), 0, -1)
                    if _f32_smem(st, cb, plane, K) <= SMEM_PAIR), (2, 1))
    else:
        if not 1 <= block_c <= C:
            raise ValueError(f"block_c {block_c} not in [1, {C}]")
        fit = next(((st, block_c) for lim in (SMEM_PAIR, SMEM_MAX)
                    for st in F32_STAGES
                    if _f32_smem(st, block_c, plane, K) <= lim), None)
        if fit is None:
            raise ValueError(f"block_c {block_c} does not fit {SMEM_MAX} "
                             "bytes of shared memory in 2 stages")
    stages, Cb = fit
    smem = _f32_smem(stages, Cb, plane, K)
    n_chunks, n_f = -(-C // Cb), -(-F // F32_FB)
    tiles = n_th * n_tw * n_f
    if n_split is not None:
        _check_split(n_split, n_chunks, n_f, f"{n_chunks} chunks")
    else:
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


def u8_block_pixels(path: int) -> int:
    """Output pixels one block of ``path`` computes."""
    return U8_SLIDE_TILE ** 2 if path == U8_SLIDE else U8_M


@dataclass(frozen=True)
class U8Tile:
    """One u8 x s8 conv's launch geometry on the GPU (per conv group)."""

    H_O: int
    W_O: int
    p: int            # symmetric zero padding
    path: int         # U8_WINDOW, U8_GATHER or U8_SLIDE
    TH: int           # output rows per block (TH * TW <= its pixels)
    TW: int           # output cols per block
    n_th: int
    n_tw: int
    n_f: int          # filter tiles of U8_FB
    rows: int         # the haloed window of one tile
    cols: int
    steps: int        # k32 steps an item (window: taps of a group)
    n_tg: int         # window path: tap groups a 32-channel chunk (else 1)
    n_items: int      # window: chunks x tap groups; gather: depth chunks
    n_split: int      # contiguous ranges of items the sum is cut into
    stages: int       # cp.async ring stages (2 or 3)
    win_bytes: int    # the window's bytes (rounded up to 128)
    stage_bytes: int
    smem_bytes: int
    wt_bytes: int     # scratch for the transposed weights [G][Fp][L]


def _u8_smem(path: int, win: int, steps: int, stages: int):
    """(stage bytes, shared memory) of one block: window and slide paths,
    ``stages`` x (window + the weights of ``steps`` taps); gather path,
    the window + ``stages`` x the weights of ``steps`` depth steps + the
    gathered A rows."""
    wb = steps * U8_FB * U8_STEP
    if path != U8_GATHER:
        stage = win + wb
        return stage, stages * stage
    return wb, win + stages * wb + steps * U8_M * U8_STEP


@functools.lru_cache(maxsize=512)
def u8_tile(hw: Tuple[int, int], c: int, k: int, f: int, *, stride: int,
            padding: Optional[int], batch: int = 1,
            path: Optional[int] = None,
            tile: Optional[Tuple[int, int]] = None,
            n_split: Optional[int] = None,
            stages: Optional[int] = None) -> U8Tile:
    """The u8 x s8 lane's geometry for x (batch,H,W,c), w (k,k,c,f).
    ``path``, ``tile`` (TH, TW), ``n_split`` and ``stages`` override the
    choices below; each is checked (the path against K and S, the tile
    against the path's pixels, the ring in :data:`SMEM_MAX`, the split
    within the items and the grid) and raises where it does not fit.

    The path is the gather path where C <= :data:`U8_GATHER_MAX_C`, else
    the slide path at K = 3 and stride 1 where its 16 x 16 output tiles
    x filter tiles give every SM a block without a split (at batch 8 every
    VGG-16 conv but CL1 and CL11-CL13; at batch 1 only CL2), else the
    window path.  The window and gather paths' output tile is the TH x TW
    <= :data:`U8_M` with the fewest tiles, then widths that are a
    multiple of 8 (an ldmatrix phase on one window row), then the
    smallest window, then the widest.  The window and slide paths take
    every tap of a 32-channel chunk in one item (its window loaded once
    for all K*K taps) with 3 stages, else 2, in half an SM (two blocks an
    SM), else in :data:`SMEM_MAX`, else as many taps an item as fit; the
    gather path takes up to :data:`U8_GATHER_STEPS` steps a chunk.  Where the batch's tiles x filter tiles do not fill every SM's
    blocks, the items are cut into the fewest contiguous ranges that
    minimise the makespan (:func:`fewest_ranges`), each range at least
    :data:`U8_MIN_RANGE_STEPS` steps where the layer has them (never on
    the slide path, which fills the card unsplit).  Integer sums are
    exact in any order, so the path and the split may follow the batch.
    ``path`` forces a path (the slide path needs K = 3 at stride 1).
    """
    if int(k) ** 2 * int(c) > U8_MAX_DEPTH:
        raise ValueError(f"K*K*C = {int(k) ** 2 * int(c)} > {U8_MAX_DEPTH}: "
                         "the int32 sum could wrap")
    return _mma_tile(hw, c, k, f, stride=stride, padding=padding,
                     batch=batch, path=path, tile=tile, n_split=n_split,
                     stages=stages, elem=1)


@dataclass(frozen=True)
class Bf16Tile:
    """One bf16 conv's launch geometry on the wgmma window path."""

    H_O: int
    W_O: int
    p: int            # symmetric zero padding
    path: int         # U8_WINDOW
    TH: int           # output rows per block (TH * TW <= BF16_PIX)
    TW: int           # output cols per block
    n_th: int
    n_tw: int
    fb: int           # filters a block (one of BF16_FB)
    n_f: int          # filter tiles of fb
    rows: int         # the haloed window of one tile
    cols: int
    n_cc: int         # 64-channel chunks
    n_split: int      # cluster blocks the chunks are cut into (1: none)
    stages: int       # weight-ring stages
    win_bytes: int    # one window stage (rounded up to 1024)
    smem_bytes: int
    wt_bytes: int = 0  # no weight pre-pass


def _bwc_smem(rows: int, cols: int, fb: int, stages: int,
              n_split: int) -> Tuple[int, int]:
    """(window stage bytes, shared memory) of a wgmma window block: the
    2-stage window ring and the weight ring, or the epilogue's staging
    (bf16 rows, fp32 ones when split) where larger, the mbarriers, and
    1024 bytes to align the base (the kernel's ``bwc_smem``)."""
    win = -(-(rows * cols * 128) // 1024) * 1024
    ring = 2 * win + stages * 64 * fb * 2
    stage = BF16_PIX * (fb * 4 + 16 if n_split > 1 else fb * 2 + 16)
    return win, max(ring, stage) + 8 * (4 + 2 * stages) + 1024


@functools.lru_cache(maxsize=512)
def bf16_tile(hw: Tuple[int, int], c: int, k: int, f: int, *, stride: int,
              padding: Optional[int], path: Optional[int] = None,
              tile: Optional[Tuple[int, int]] = None,
              n_split: Optional[int] = None,
              stages: Optional[int] = None):
    """The bf16 lane's geometry for x (·,H,W,c), w (k,k,c,f), from the
    per-image shape alone: fp32 sums are not exact in every order, so the
    path, the tile, the filters a block and the split never follow the
    batch, and a batch of N equals N calls of one image bit for bit.

    The path is the wgmma window path (a :class:`Bf16Tile`) where c > 8
    and c and f are multiples of 8 (its TMA maps' row strides must be
    16-byte multiples), else the gather path (a :class:`U8Tile` of the
    u8 x s8 lane's planner on 2-byte elements, :func:`u8_tile`); there is
    no slide path (``path`` :data:`U8_SLIDE` raises).  Window path: the
    output tile TH x TW <= :data:`BF16_PIX` with the fewest tiles, then
    the smallest haloed window (rows and cols <= :data:`TMA_BOX_MAX`),
    then the widest; 128 filters a block where f > 64, else 64 (the
    m64n128 products ran 8-22% faster than twice as many m64n64 ones at
    VGG-16's CL6-CL13 on the H100, split or not); and the split, the
    fewest clusters of blocks, each block a contiguous range of the
    64-channel chunks, that minimise the makespan over one image's blocks
    with one block an SM (:func:`fewest_ranges`, at most
    :data:`BF16_SPLIT_CAP` and the chunks; ``n_split`` up to
    :data:`BF16_MAX_SPLIT`, the portable cluster); the weight ring takes the
    most of :data:`BF16_STAGES` that let two blocks share an SM (the
    kernel's launch bounds), else that fit :data:`SMEM_MAX`.  ``path``, ``tile``, ``n_split`` and
    ``stages`` override these choices; each is checked and raises where
    the kernel cannot take it."""
    if path == U8_SLIDE:
        raise ValueError("the bf16 lane has no slide path")
    C, F = int(c), int(f)
    window = C > U8_GATHER_MAX_C and C % 8 == 0 and F % 8 == 0
    if path is None:
        path = U8_WINDOW if window else U8_GATHER
    if path == U8_GATHER:
        return _mma_tile(hw, c, k, f, stride=stride, padding=padding,
                         batch=1, path=path, tile=tile, n_split=n_split,
                         stages=stages, elem=2)
    if path != U8_WINDOW:
        raise ValueError(f"path {path} not in {U8_PATH_NAMES[:2]}")
    if C % 8 or F % 8:
        raise ValueError(f"the bf16 window path needs C and F multiples of "
                         f"8 (its TMA maps' 16-byte strides), got C={C}, "
                         f"F={F}")
    H, W = int(hw[0]), int(hw[1])
    S, K = int(stride), int(k)
    if S < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    p = K // 2 if padding is None else int(padding)
    H_O, W_O = (H + 2 * p - K) // S + 1, (W + 2 * p - K) // S + 1
    if H_O < 1 or W_O < 1:
        raise ValueError(f"empty conv output for input {hw}, k={K}, p={p}")
    if tile is not None:
        TH, TW = (int(v) for v in tile)
        if min(TH, TW) < 1 or TH * TW > BF16_PIX:
            raise ValueError(f"bf16 tile {TH} x {TW} not within {BF16_PIX} "
                             "pixels")
        cands = [(TH, TW)]
    else:
        cands = [(TH, TW) for TW in range(1, min(W_O, BF16_PIX) + 1)
                 for TH in range(1, min(BF16_PIX // TW, H_O) + 1)]
    best = None
    for TH, TW in cands:
        rows, cols = (TH - 1) * S + K, (TW - 1) * S + K
        if rows > TMA_BOX_MAX or cols > TMA_BOX_MAX:
            continue
        key = (-(-H_O // TH) * -(-W_O // TW), rows * cols, -TW)
        if best is None or key < best[0]:
            best = (key, TH, TW, rows, cols)
    if best is None:
        raise ValueError(f"no bf16 tile {'' if tile is None else tile} keeps "
                         f"its window within {TMA_BOX_MAX} x {TMA_BOX_MAX} "
                         f"(K={K}, S={S})")
    _, TH, TW, rows, cols = best
    n_th, n_tw = -(-H_O // TH), -(-W_O // TW)
    n_cc = -(-C // BF16_CHUNK)
    cap = min(n_cc, BF16_MAX_SPLIT)
    if n_split is not None and not 1 <= n_split <= cap:
        raise ValueError(f"n_split {n_split} not in [1, {cap}] (the "
                         f"{n_cc} 64-channel chunks, clusters of at most "
                         f"{BF16_MAX_SPLIT})")
    cap = min(cap, BF16_SPLIT_CAP)
    if stages is not None and stages not in BF16_STAGES:
        raise ValueError(f"stages {stages} not in {BF16_STAGES}")
    fb = BF16_FB[0] if F > BF16_FB[1] else BF16_FB[1]
    n_f = -(-F // fb)
    blocks = n_th * n_tw * n_f
    ns = n_split if n_split is not None else (
        fewest_ranges(n_cc, blocks, SMS, cap) if blocks < SMS else 1)
    fit = [st for lim in (SM_SMEM // 2 - 1024, SMEM_MAX)
           for st in (BF16_STAGES if stages is None else (stages,))
           if _bwc_smem(rows, cols, fb, st, ns)[1] <= lim]
    if not fit:
        raise ValueError(f"no bf16 window ring fits K={K}, S={S}, tile "
                         f"{TH} x {TW} in {SMEM_MAX} bytes of shared memory")
    win, smem = _bwc_smem(rows, cols, fb, fit[0], ns)
    return Bf16Tile(H_O=H_O, W_O=W_O, p=p, path=U8_WINDOW, TH=TH, TW=TW,
                    n_th=n_th, n_tw=n_tw, fb=fb, n_f=n_f, rows=rows,
                    cols=cols, n_cc=n_cc, n_split=ns, stages=fit[0],
                    win_bytes=win, smem_bytes=smem)


def bf16_ranges(t: Bf16Tile):
    """The window path's channel-chunk ranges ``[(c0, c1), ...]`` of the
    n_split blocks of a cluster, in rank order (the kernel's: chunks
    ``n_cc * r // n_split`` up to ``n_cc * (r + 1) // n_split``)."""
    return [(t.n_cc * r // t.n_split, t.n_cc * (r + 1) // t.n_split)
            for r in range(t.n_split)]


def bf16_output_map(t: Bf16Tile, f: int):
    """Every output the window path's blocks write for one image, as flat
    index tensors ``(ho, wo, filter)``: block (tile, filter tile, cluster
    rank r), pixel m of the tile's BF16_PIX and filter of its fb -- unsplit
    the block writes its whole tile, split rank r the pixels [BF16_PIX r /
    n_split, BF16_PIX (r + 1) / n_split) summed over the cluster -- those
    inside TH * TW and H_O x W_O x f."""
    tile = torch.arange(t.n_th * t.n_tw).view(-1, 1, 1, 1, 1)
    ft = torch.arange(t.n_f).view(1, -1, 1, 1, 1)
    r = torch.arange(t.n_split).view(1, 1, -1, 1, 1)
    m = torch.arange(BF16_PIX).view(1, 1, 1, -1, 1)
    j = torch.arange(t.fb).view(1, 1, 1, 1, -1)
    mine = ((m >= BF16_PIX * r // t.n_split)
            & (m < BF16_PIX * (r + 1) // t.n_split))
    ho = (tile // t.n_tw) * t.TH + m // t.TW
    wo = (tile % t.n_tw) * t.TW + m % t.TW
    fo = ft * t.fb + j
    mine, m, ho, wo, fo = torch.broadcast_tensors(mine, m, ho, wo, fo)
    keep = (mine & (m < t.TH * t.TW) & (ho < t.H_O) & (wo < t.W_O)
            & (fo < f))
    return ho[keep], wo[keep], fo[keep]


def _mma_tile(hw, c, k, f, *, stride, padding, batch, path, tile, n_split,
              stages, elem) -> U8Tile:
    """The tensor-core lanes' planner (:func:`u8_tile`, :func:`bf16_tile`)
    for ``elem``-byte elements (1: u8 x s8, 2: bf16)."""
    H, W = int(hw[0]), int(hw[1])
    S, K, C, F = int(stride), int(k), int(c), int(f)
    sc = U8_STEP // elem            # channels (depth values) a k-step
    if S < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    p = K // 2 if padding is None else int(padding)
    H_O = (H + 2 * p - K) // S + 1
    W_O = (W + 2 * p - K) // S + 1
    if H_O < 1 or W_O < 1:
        raise ValueError(f"empty conv output for input {hw}, k={K}, p={p}")
    n_f = -(-F // U8_FB)
    T = U8_SLIDE_TILE
    if path is None:
        path = (U8_GATHER if C <= U8_GATHER_MAX_C
                else U8_SLIDE if elem == 1 and K == 3 and S == 1 and (
                    -(-H_O // T) * -(-W_O // T) * n_f * int(batch) >= SMS)
                else U8_WINDOW)
    elif path not in (U8_WINDOW, U8_GATHER, U8_SLIDE) or (
            path == U8_SLIDE and (K, S) != (3, 1)):
        raise ValueError(f"path {path} does not take K={K}, S={S}")
    if tile is not None:
        TH, TW = (int(v) for v in tile)
        if path == U8_SLIDE and (TH, TW) != (U8_SLIDE_TILE,) * 2:
            raise ValueError(f"the slide path's tile is {U8_SLIDE_TILE} x "
                             f"{U8_SLIDE_TILE}, not {TH} x {TW}")
        if min(TH, TW) < 1 or TH * TW > U8_M:
            raise ValueError(f"{'u8' if elem == 1 else 'bf16'} tile {TH} x "
                             f"{TW} not within {U8_M} pixels")
        cands = [(TH, TW)]
    elif path == U8_SLIDE:
        cands = [(U8_SLIDE_TILE, U8_SLIDE_TILE)]
    else:
        cands = [(min(U8_M // TW, H_O), TW)
                 for TW in range(1, min(W_O, U8_M) + 1)]
    best = None
    for TH, TW in cands:
        rows, cols = (TH - 1) * S + K, (TW - 1) * S + K
        n_th, n_tw = -(-H_O // TH), -(-W_O // TW)
        key = (n_th * n_tw, TW % 8 != 0, rows * cols, -TW)
        if best is None or key < best[0]:
            best = (key, TH, TW, rows, cols, n_th, n_tw)
    _, TH, TW, rows, cols, n_th, n_tw = best
    if stages is not None and stages not in U8_STAGES:
        raise ValueError(f"stages {stages} not in {U8_STAGES}")
    sts = U8_STAGES if stages is None else (stages,)
    if path != U8_GATHER:
        win = -(-(rows * cols * U8_STEP) // 128) * 128
        fits = [(K * K, st, lim) for lim in (SMEM_PAIR, SMEM_MAX)
                for st in sts]
        if path != U8_SLIDE:    # the slide path takes every tap an item
            fits += [(g, min(sts), SMEM_MAX)
                     for g in range(K * K - 1, 0, -1)]
    else:
        win = -(-(rows * cols * C * elem) // 128) * 128
        g = min(U8_GATHER_STEPS, -(-(K * K * C) // sc))
        fits = [(g, st, lim) for lim in (SMEM_PAIR, SMEM_MAX)
                for st in sts]
    steps, stages = next(((g, st) for g, st, lim in fits
                          if _u8_smem(path, win, g, st)[1] <= lim),
                         (None, None))
    if steps is None:
        raise ValueError(f"no {'u8' if elem == 1 else 'bf16'} conv tile "
                         f"fits K={K}, S={S}, C={C} in {SMEM_MAX} bytes of "
                         "shared memory")
    stage_bytes, smem = _u8_smem(path, win, steps, stages)
    if path != U8_GATHER:
        n_tg = -(-(K * K) // steps)
        n_items = -(-C // sc) * n_tg
    else:
        n_tg = 1
        n_items = -(-(K * K * C) // (steps * sc))
    wt_bytes = (0 if elem != 1
                else K * K * n_f * U8_FB * -(-C // U8_STEP) * U8_STEP
                if path != U8_GATHER
                else n_f * U8_FB * n_items * steps * U8_STEP)
    tiles = n_th * n_tw * n_f * int(batch)
    # blocks an SM: the gather path is built for 3, the others for 2
    slots = SMS * min(3 if path == U8_GATHER else 2,
                      SM_SMEM // (smem + 1024))
    if n_split is not None:
        if path == U8_SLIDE and n_split != 1:
            raise ValueError("the slide path does not split its sum")
        _check_split(n_split, n_items, n_f, f"{n_items} items")
    else:
        n_split = 1
        if tiles < slots and path != U8_SLIDE:
            # in steps of 128 pixels
            m128 = steps * u8_block_pixels(path) // U8_M
            cap = n_items // -(-U8_MIN_RANGE_STEPS // m128)
            n_split = fewest_ranges(n_items, tiles, slots,
                                    min(max(1, cap), 65535 // n_f))
    return U8Tile(H_O=H_O, W_O=W_O, p=p, path=path, TH=TH, TW=TW,
                  n_th=n_th, n_tw=n_tw, n_f=n_f, rows=rows, cols=cols,
                  steps=steps, n_tg=n_tg, n_items=n_items, n_split=n_split,
                  stages=stages, win_bytes=win, stage_bytes=stage_bytes,
                  smem_bytes=smem, wt_bytes=wt_bytes)


def u8_ranges(t: U8Tile):
    """The item ranges ``[(k0, k1), ...]`` of the n_split blocks of a
    tile, in split order (the kernel's: items ``n_items * s // n_split``
    up to ``n_items * (s + 1) // n_split``)."""
    return [(t.n_items * s // t.n_split, t.n_items * (s + 1) // t.n_split)
            for s in range(t.n_split)]


def u8_output_map(t: U8Tile, f: int):
    """Every output the kernel's threads write for one image and one split
    range, as flat index tensors ``(ho, wo, filter)``: block (tile, filter
    tile), warp (pixels (warp % 4) * M / 4 of the block's M, filters
    (warp // 4) * 32), m16n8 tile (mt of M / 64, nt of 4), lane and
    accumulator q (pixel mt * 16 + (lane >> 2) + 8 * (q >> 1), filter
    (lane & 3) * 2 + (q & 1)), those inside TH * TW and H_O x W_O x f."""
    M = u8_block_pixels(t.path)
    tile = torch.arange(t.n_th * t.n_tw).view(-1, 1, 1, 1, 1, 1, 1)
    ft = torch.arange(t.n_f).view(1, -1, 1, 1, 1, 1, 1)
    warp = torch.arange(U8_THREADS // 32).view(1, 1, -1, 1, 1, 1, 1)
    mt = torch.arange(M // 64).view(1, 1, 1, -1, 1, 1, 1)
    nt = torch.arange(4).view(1, 1, 1, 1, -1, 1, 1)
    lane = torch.arange(32).view(1, 1, 1, 1, 1, -1, 1)
    q = torch.arange(4).view(1, 1, 1, 1, 1, 1, -1)
    m = (warp % 4) * (M // 4) + mt * 16 + lane // 4 + 8 * (q // 2)
    fo = ft * U8_FB + (warp // 4) * 32 + nt * 8 + (lane % 4) * 2 + q % 2
    ho = (tile // t.n_tw) * t.TH + m // t.TW
    wo = (tile % t.n_tw) * t.TW + m % t.TW
    m, ho, wo, fo = torch.broadcast_tensors(m, ho, wo, fo)
    keep = (m < t.TH * t.TW) & (ho < t.H_O) & (wo < t.W_O) & (fo < f)
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
    """The kernel's function in plain PyTorch: oracle conv + epilogue.  A
    float ``x`` gets the Pallas kernel's float lane: fp32 sums, the bias
    (fp32 or bf16) added in fp32, ReLU in fp32, one rounding to x's
    dtype at the end."""
    _check_epilogue(x, requant_shift, requant)
    out = ref.conv2d(x, w, stride=stride, padding=padding)
    out = apply_epilogue(out, bias, relu, requant_shift, requant)
    return out.to(x.dtype) if x.is_floating_point() else out


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
        lib.trim_conv2d_u8s8.argtypes = [p] * 8 + [i] * 21 + [p]
        lib.trim_conv2d_u8s8.restype = i
        lib.trim_conv2d_bf16.argtypes = [p] * 5 + [i] * 19 + [p]
        lib.trim_conv2d_bf16.restype = i
        lib.trim_conv2d_error_string.argtypes = [i]
        lib.trim_conv2d_error_string.restype = ctypes.c_char_p
        for name in ("f32_threads", "f32_filters", "u8_pixels",
                     "u8_filters", "u8_max_depth", "bf16_pixels",
                     "bf16_max_split", "bf16_max_stages"):
            getattr(lib, f"trim_conv2d_{name}").restype = i
        if (lib.trim_conv2d_f32_threads() != F32_THREADS
                or lib.trim_conv2d_f32_filters() != F32_FB
                or lib.trim_conv2d_u8_pixels() != U8_M
                or lib.trim_conv2d_u8_filters() != U8_FB
                or lib.trim_conv2d_u8_max_depth() != U8_MAX_DEPTH
                or lib.trim_conv2d_bf16_pixels() != BF16_PIX
                or lib.trim_conv2d_bf16_max_split() != BF16_MAX_SPLIT
                or lib.trim_conv2d_bf16_max_stages() != max(BF16_STAGES)):
            raise RuntimeError("trim_conv2d library tile constants differ "
                               "from the wrapper's")
        _BOUND.add(lib)
    return lib


@functools.lru_cache(maxsize=256)
def f32_launch_args(x_shape: Tuple[int, int, int, int], K: int, F: int,
                    S: int, padding: Optional[int], w_aligned: bool,
                    schedule: Optional[Schedule] = None):
    """The fp32 geometry and the C function's integer arguments for one
    call's shape and ``schedule`` (cached: the wrapper's host time bounds
    the small shapes).  The geometry does not depend on the batch
    ``x_shape[0]``."""
    N, H, W, C = x_shape
    t = f32_tile((H, W), C, K, F, stride=S, padding=padding,
                 **(schedule or Schedule()).f32())
    return t, (N, H, W, C, K, F, t.H_O, t.W_O, S, t.p, t.path, t.TH, t.TW,
               t.Cb, t.n_split, t.stages, t.RS, t.plane,
               int(F % 4 == 0 and w_aligned))


@functools.lru_cache(maxsize=512)
def u8_launch_args(x_shape: Tuple[int, int, int, int], K: int, F: int,
                   S: int, padding: Optional[int],
                   schedule: Optional[Schedule] = None):
    """The u8 x s8 geometry and the C function's integer arguments for one
    call's shape and ``schedule`` (cached, as :func:`f32_launch_args`)."""
    N, H, W, C = x_shape
    t = u8_tile((H, W), C, K, F, stride=S, padding=padding, batch=N,
                **(schedule or Schedule()).u8())
    return t, (N, H, W, C, K, F, t.H_O, t.W_O, S, t.p, t.path, t.TH, t.TW,
               t.steps, t.n_split, t.stages)


@functools.lru_cache(maxsize=512)
def bf16_launch_args(x_shape: Tuple[int, int, int, int], K: int, F: int,
                     S: int, padding: Optional[int],
                     schedule: Optional[Schedule] = None):
    """The bf16 geometry and the C function's integer arguments for one
    call's shape and ``schedule`` (cached, as :func:`f32_launch_args`).
    The geometry does not depend on the batch ``x_shape[0]``."""
    N, H, W, C = x_shape
    t = bf16_tile((H, W), C, K, F, stride=S, padding=padding,
                  **(schedule or Schedule()).bf16())
    return t, (N, H, W, C, K, F, t.H_O, t.W_O, S, t.p, t.path, t.TH, t.TW,
               t.fb if t.path == U8_WINDOW else t.steps, t.n_split,
               t.stages)


def lane_of(x_dtype: torch.dtype, w_dtype: torch.dtype) -> Optional[str]:
    """The kernel's lane for x and w of these dtypes: "f32", "bf16",
    "u8", or None where the kernel takes no such pair."""
    return {(torch.float32, torch.float32): "f32",
            (torch.bfloat16, torch.bfloat16): "bf16",
            (torch.uint8, torch.int8): "u8"}.get((x_dtype, w_dtype))


def u8_weights(w: torch.Tensor, key, nbytes: int):
    """The buffer for ``w``'s transposed weights under layout ``key`` (the
    stream included), and whether it already holds them: ``(wt, ready)``.
    A buffer is kept per weight tensor and key while ``w`` lives and its
    version counter and address stand, so an in-place update of ``w``
    makes the next call write it anew (an update that the counter does
    not see, through ``.data`` or a raw pointer, needs a new tensor).  An
    inference tensor has no version counter: every call writes its own
    buffer.  :func:`u8_weights_keep` records a buffer once its writing
    launch is queued."""
    if not w.is_inference():
        ent = _WT.get(id(w))
        if ent is not None and ent[0]() is w:
            hit = ent[1].get(key)
            if hit is not None and hit[0] == (w._version, w.data_ptr()):
                return hit[1], True
    return torch.empty(nbytes, dtype=torch.int8, device=w.device), False


def u8_weights_keep(w: torch.Tensor, key, wt: torch.Tensor) -> None:
    """Keep ``wt``, just written from ``w`` under ``key``, for the later
    calls of :func:`u8_weights`; dropped with ``w``."""
    if w.is_inference():
        return
    k = id(w)
    ent = _WT.get(k)
    if ent is None or ent[0]() is not w:
        def drop(ref, k=k):
            if _WT.get(k, (None,))[0] is ref:
                del _WT[k]
        ent = (weakref.ref(w, drop), {})
        _WT[k] = ent
    ent[1][key] = ((w._version, w.data_ptr()), wt)


def check_schedule(schedule: Schedule, x_shape, w_shape, stride: int,
                   padding: Optional[int], lane: str):
    """The geometry ``schedule`` gives a call of x ``x_shape`` (N,H,W,C)
    and w ``w_shape`` (K,K,C,F) on ``lane`` ("f32", "bf16" or "u8"): an
    :class:`F32Tile` or a :class:`U8Tile`; raises where the kernel cannot
    take an override."""
    N, H, W, C = (int(v) for v in x_shape)
    K, F = int(w_shape[0]), int(w_shape[-1])
    kw = dict(stride=int(stride), padding=padding)
    if lane == "f32":
        return f32_tile((H, W), C, K, F, **kw, **schedule.f32())
    if lane == "bf16":
        return bf16_tile((H, W), C, K, F, **kw, **schedule.bf16())
    return u8_tile((H, W), C, K, F, **kw, batch=N, **schedule.u8())


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _on_stream(x: torch.Tensor, launch):
    """``launch(stream)`` on x's device and its current stream; the device
    is switched only where x is not on the current one (the switch and
    the stream lookup by device cost the host more than the launch)."""
    idx = x.get_device()
    if idx == torch.cuda.current_device():
        return launch(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(idx):
        return launch(torch.cuda.current_stream().cuda_stream)


def _per_channel(v, F: int, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.int32, device=device)
    return t.expand(F).contiguous() if t.dim() == 0 else t


def trim_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                padding: Optional[int] = None,
                bias: Optional[torch.Tensor] = None, relu: bool = False,
                requant_shift: Optional[int] = None, requant=None,
                schedule: Optional[Schedule] = None) -> torch.Tensor:
    """TrIM conv. x (N,H,W,C), w (K,K,C,F) -> (N,H_O,W_O,F).

    fp32 x fp32 -> fp32, bf16 x bf16 -> bf16 (fp32 sums and epilogue,
    rounded once), or uint8 x int8 -> int32 (uint8 with ``requant_shift``
    or per-channel ``requant=(mult, shift)``).  ``bias`` (F,) is fp32 on
    the fp32 lane, fp32 or bf16 on the bf16 lane and int32 on the integer
    lane.  A CPU ``x`` runs :func:`trim_conv2d_plain` (``schedule``
    checked, the same function whatever it says); a CUDA ``x`` launches
    the kernel on the current stream, or raises.  The fp32 and bf16 lanes
    plan their geometry from the per-image shape (:func:`f32_tile`,
    :func:`bf16_tile`), the integer lane from the shape and the batch
    (:func:`u8_tile`), each with ``schedule``'s overrides (an illegal one
    raises).  Where a lane splits its sum, one call launches the conv and
    the kernel that merges its partials; the integer lane's first call on
    a weight tensor (or after it changed) also launches the weights'
    transposition (:func:`u8_weights`).  One count in :data:`LAUNCHES` a
    call, and one in its lane's :data:`LAUNCHES_BY_LANE`.
    """
    global LAUNCHES
    if schedule is not None and not isinstance(schedule, Schedule):
        raise TypeError(f"schedule must be a Schedule, got {schedule!r}")
    lane = lane_of(x.dtype, w.dtype)
    if x.device.type == "cpu":
        if schedule is not None and not schedule.default:
            check_schedule(schedule, x.shape, w.shape, stride, padding,
                           lane or ("f32" if x.is_floating_point()
                                    else "u8"))
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
    if lane is None:
        raise ValueError(f"unsupported dtypes x={x.dtype}, w={w.dtype}: the "
                         "kernel takes float32 x float32, bfloat16 x "
                         "bfloat16 or uint8 x int8")
    tensors = [x, w]
    if bias is not None:
        want = {"f32": (torch.float32,), "u8": (torch.int32,),
                "bf16": (torch.float32, torch.bfloat16)}[lane]
        if bias.shape != (F,) or bias.dtype not in want:
            raise ValueError(f"bias must be ({F},) {' or '.join(map(str, want))}"
                             f", got {tuple(bias.shape)} {bias.dtype}")
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
    shape = (N, H, W, C)
    if lane == "bf16":
        t, args = bf16_launch_args(shape, K, F, int(stride), padding,
                                   schedule)
    elif lane == "f32":
        t, args = f32_launch_args(shape, K, F, int(stride), padding,
                                  w.data_ptr() % 16 == 0, schedule)
    else:
        t, args = u8_launch_args(shape, K, F, int(stride), padding,
                                 schedule)
    if t.n_f * t.n_split > 65535:
        raise ValueError(f"{F} filters need {t.n_f} filter tiles "
                         f"(x {t.n_split} ranges > 65535)")
    out_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}.get(
        lane, torch.uint8 if requant_shift is not None
        or requant is not None else torch.int32)
    out = torch.empty((N, t.H_O, t.W_O, F), dtype=out_dtype,
                      device=x.device)
    window = lane == "bf16" and t.path == U8_WINDOW
    if window and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the bf16 window path's tensor maps need x and w "
                         "16-byte aligned")
    parts = (None if t.n_split == 1 or window else torch.empty(
        (t.n_split, N, t.H_O, t.W_O, F), device=x.device,
        dtype=torch.int32 if lane == "u8" else torch.float32))
    if lane == "bf16":
        bias_bf16 = int(bias is not None and bias.dtype == torch.bfloat16)
        rc = _on_stream(x, lambda stream: lib.trim_conv2d_bf16(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(out), _ptr(parts), *args,
            bias_bf16, int(relu), t.smem_bytes, stream))
    elif lane == "f32":
        rc = _on_stream(x, lambda stream: lib.trim_conv2d_f32(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(out), _ptr(parts), *args,
            int(relu), t.smem_bytes, stream))
    else:
        rq_kind = (2 if requant is not None
                   else 1 if requant_shift is not None else 0)

        def launch(stream):
            global PREPASSES
            gather = t.path == U8_GATHER
            key = (stream, gather, t.steps if gather else 0, t.wt_bytes)
            wt, ready = u8_weights(w, key, -(-t.wt_bytes // 16) * 16)
            rc = lib.trim_conv2d_u8s8(
                _ptr(x), _ptr(w), _ptr(bias), _ptr(mult), _ptr(shift),
                _ptr(out), _ptr(wt), _ptr(parts), *args, int(relu), rq_kind,
                int(requant_shift or 0), int(ready), t.smem_bytes, stream)
            if rc == 0 and not ready:
                u8_weights_keep(w, key, wt)
                PREPASSES += 1
            return rc

        rc = _on_stream(x, launch)
    if rc != 0:
        msg = lib.trim_conv2d_error_string(rc).decode()
        raise RuntimeError(f"trim_conv2d launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES += 1
    LAUNCHES_BY_LANE[lane] += 1
    return out
