"""The TrIM conv's backward on Hopper: the weight-gradient kernel's
wrapper, its plain version, the input gradient through the forward kernel,
and the autograd Function that ties them to the fused forward.

Port of ``repro/kernels/trim_conv2d_vjp.py``.

- :func:`trim_conv2d_wgrad` is the wrapper of the CUDA kernel
  ``repro_torch/csrc/trim_conv2d_wgrad.cu`` (the port of
  ``_trim_conv2d_wgrad_kernel`` at line 92): a CUDA tensor launches it (or
  the wrapper raises), a CPU tensor takes :func:`trim_conv2d_wgrad_plain`.
  Every launch adds one to :data:`WGRAD_LAUNCHES`.
- :func:`trim_conv2d_wgrad_plain` is the same function in plain PyTorch:
  a loop over the K*K taps, each an fp32 contraction of the shifted
  input view with the cotangent.
- :func:`wgrad_bf16_tile` is the bf16 lane's geometry: the window path
  (C and F multiples of 8: a block owns all the taps of a 64-channel x
  64-filter tile of dw on wgmma, its input window and cotangent tile
  brought in once a chunk by TMA, the output pixels as the reduction in
  TH x TW chunks) or the GEMM path (64 depth rows x 64 filters a block,
  the pixels in chunks of 64), and into how many contiguous ranges the
  chunks are cut to fill the card (:func:`wgrad_bf16_ranges`), from the
  shape alone; :func:`wgrad_bf16_output_map` lists the dw elements the
  threads write.
- :func:`wgrad_tile` is the kernel's geometry: its path, output tile,
  channel and filter tile, which (tap, channel) rows and filters each
  thread's register tile holds (8 x 8, or 9 taps x 8 on the K = 3 path:
  :func:`wgrad_thread_outputs`), and into how many
  ranges the (image, output tile) reduction is cut to fill the card
  (:func:`wgrad_ranges`).
- :func:`trim_conv2d_input_grad` is dL/dx as a forward TrIM conv at
  stride 1 (``kernels.trim_conv2d.trim_conv2d``, kernel 1) with the
  flipped, transposed weights: on the cotangent itself at padding K-1-p
  where the forward stride is 1, else on the zero-stuffed, padded one.
- :class:`TrimConv2dFn` is the fused conv + bias + ReLU with this
  backward (``make_trim_conv2d_vjp`` at line 223).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.trim_conv2d import (SMEM_MAX, TMA_BOX_MAX,
                                             Schedule, fewest_ranges,
                                             trim_conv2d)

#: Launches of the weight-gradient kernel since the last reset (a plain
#: counter: callers set it to 0 before a run and read it after).
WGRAD_LAUNCHES = 0
#: The same launches by lane ("f32", "bf16"), reset alike
WGRAD_LAUNCHES_BY_LANE = {"f32": 0, "bf16": 0}

#: The kernel's paths: scalar window rows (C < 8), 16-byte window rows
#: (Cb % 8 == 0) and, at K = 3 and stride 1 with a 32 x 64 tile, the nine
#: taps of one channel in registers (every VGG-16 layer but CL1).
PATH_SCALAR, PATH_VEC, PATH_K3 = 0, 1, 2
#: Threads a block may have and cp.async stages; both are compiled into
#: the kernel.
WGRAD_MAX_THREADS = 288
WGRAD_STAGES = 2
#: The K = 3 path's channel and filter tile and threads.
K3_CB, K3_FB, K3_THREADS = 32, 64, 256
#: Registers per thread of each path's kernel as ``nvcc -Xptxas -v``
#: reports them on the H100 (157, 96, 113: the build log beside the
#: library), rounded up to the allocation unit of 8: what the split and
#: the output tile reckon the card's occupancy with.
WGRAD_REGS = {PATH_SCALAR: 160, PATH_VEC: 96, PATH_K3: 120}
#: Warps an SM should hold: below it, a block's output tile is halved
#: (down to WGRAD_MIN_PIXELS) so that more blocks fit.
WGRAD_MIN_WARPS = 8
WGRAD_MIN_PIXELS = 32
#: Largest channel and filter tile a block takes.
WGRAD_MAX_CB, WGRAD_MAX_FB = 64, 64
#: Output tile of one reduction item (the forward kernel's default),
#: halved while the two stages do not fit the shared memory.
WGRAD_TILE_H, WGRAD_TILE_W = 8, 16
#: The H100's SMs and the shared memory, registers and threads of one.
WGRAD_SMS = 132
SM_SMEM = 228 * 1024
SM_REGS = 65536
SM_THREADS = 2048
#: Most scratch the split partials may take.
WGRAD_WORKSPACE_MAX = 256 * 1024 * 1024
#: The bf16 lane's paths: the 64 x 64 GEMM over im2col rows (any C and
#: F: VGG-16 CL1, C = 3) and the window path on wgmma and TMA (C and F
#: multiples of 8, the tensor maps' 16-byte strides).
BF16_GEMM, BF16_WINDOW = 0, 1
BF16_PATH_NAMES = ("gemm", "window")
#: The GEMM path, compiled into the kernel: depth rows (tap, channel) and
#: filters a block, output pixels a chunk; blocks an SM (128 threads, 48
#: KB of shared memory each).
BF16_M, BF16_N, BF16_P = 64, 64, 64
BF16_BLOCKS_PER_SM = 4
BF16_GEMM_SMEM = 3 * 2 * BF16_P * 128
#: The window path, compiled into the kernel: channels (one 128-byte TMA
#: row) and filters a block, taps a block (three consumer warpgroups of
#: three taps), most ring stages, the pixel rows of a chunk (eight k16
#: steps; TH * TW of them are output pixels).  One block an SM (384
#: threads at up to 168 registers).
WIN_C, WIN_F, WIN_TAPS, WIN_MAX_STAGES = 64, 64, 9, 4
WIN_PIXELS = 128
#: The window path's split clusters: at most the portable 8 blocks, each
#: staging its fp32 sums ([taps][channels][filters]) in its idle ring,
#: which must hold them.
WIN_MAX_CLUSTER = 8
WIN_STAGE = WIN_TAPS * WIN_C * WIN_F * 4
#: The planner's cap on a cluster: on the H100 clusters of 4 and 8 ran
#: VGG-16's batch-8 weight gradients slower than clusters of 2 or no
#: cluster at all (``tools/bf16_conv_times.py --caps``).
WIN_CLUSTER_CAP = 2

_LIB_NAME = "trim_conv2d_wgrad"
_SOURCES = ("trim_conv2d_wgrad.cu",)
_BOUND: set = set()  # libraries whose ctypes signatures are declared


@dataclass(frozen=True)
class WgradTile:
    """One weight-gradient call's launch geometry on the GPU."""

    H_O: int
    W_O: int
    p: int            # symmetric zero padding
    TH: int           # output rows per reduction item
    TW: int           # output cols per reduction item
    n_th: int
    n_tw: int
    path: int         # PATH_SCALAR, PATH_VEC or PATH_K3
    Cb: int           # channels per block
    Cbp: int          # floats per window position in shared memory (>= Cb)
    Fb: int           # filters per block (a multiple of 8)
    n_c: int
    n_f: int
    work: int         # threads holding an 8 x 8 register tile
    threads: int      # threads per block (work rounded up to a warp)
    n_split: int      # ranges the (image, output tile) reduction is cut into
    smem_bytes: int   # the two stages of window + cotangent tile
    blocks_per_sm: int


def _stage_floats(TH: int, TW: int, S: int, K: int, Cbp: int,
                  Fb: int) -> int:
    rows, cols = (TH - 1) * S + K, (TW - 1) * S + K
    return -(-(rows * cols * Cbp) // 4) * 4 + TH * TW * Fb


def _row_groups(K: int, Cb: int) -> int:
    return -(-K * K * Cb // 8)


def _blocks_per_sm(threads: int, smem: int, path: int) -> int:
    """Resident blocks per SM by threads, registers and shared memory
    (1 KB reserved a block)."""
    return max(1, min(SM_THREADS // threads,
                      SM_REGS // (threads * WGRAD_REGS[path]),
                      SM_SMEM // (smem + 1024), 32))


@functools.lru_cache(maxsize=256)
def wgrad_tile(x_shape: Tuple[int, int, int, int], k: int, f: int, *,
               stride: int, padding: Optional[int]) -> WgradTile:
    """Geometry for x (N,H,W,C) and dw (k,k,C,f).

    With C >= 8 the channel tile Cb is a multiple of 8 (the 16-byte row
    loads), below that Cb = C (scalar row loads); the filter tile Fb is a
    multiple of 8.  Of the (Cb, Fb) whose row groups x filter groups fit
    :data:`WGRAD_MAX_THREADS`, the one with the least padded work (rows
    and filters past C and F), then the largest tile, then the widest Fb
    wins.  A window position takes Cb + 4 floats where fewer than four
    filter groups put two taps in one quarter warp.  The output tile is
    halved until the two stages fit the shared memory, an SM holds
    :data:`WGRAD_MIN_WARPS` warps and the items x tiles give every SM a
    block (or the tile is down to :data:`WGRAD_MIN_PIXELS` pixels: VGG-16
    CL1's one-warp blocks, AlexNet CL1 at batch 1).  The reduction is
    then cut into the fewest ranges that minimise waves x items per range
    over the blocks the card holds at once, never more ranges than items
    and never more scratch than :data:`WGRAD_WORKSPACE_MAX`.
    """
    N, H, W, C = (int(v) for v in x_shape)
    S, K, F = int(stride), int(k), int(f)
    if S < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    p = K // 2 if padding is None else int(padding)
    H_O = (H + 2 * p - K) // S + 1
    W_O = (W + 2 * p - K) // S + 1
    if H_O < 1 or W_O < 1:
        raise ValueError(f"empty conv output for input {(H, W)}, k={K}, p={p}")
    vec = C >= 8 and K * K <= WGRAD_MAX_THREADS
    cbs = (range(8, min(WGRAD_MAX_CB, -(-C // 8) * 8) + 1, 8) if vec
           else range(min(C, 7), 0, -1))
    best = None
    for Cb in cbs:
        rg = _row_groups(K, Cb)
        for Fb in range(8, min(WGRAD_MAX_FB, -(-F // 8) * 8) + 1, 8):
            work = rg * (Fb // 8)
            if work > WGRAD_MAX_THREADS:
                continue
            padded = -(-C // Cb) * rg * 8 * -(-F // Fb) * Fb
            key = (padded, -Cb * Fb, -Fb)
            if best is None or key < best[0]:
                best = (key, Cb, Fb, work)
    if best is None:
        raise ValueError(f"no weight-gradient tile fits K={K} in "
                         f"{WGRAD_MAX_THREADS} threads")
    _, Cb, Fb, work = best
    path = PATH_VEC if vec else PATH_SCALAR
    if vec and K == 3 and S == 1 and (Cb, Fb) == (K3_CB, K3_FB):
        path, work = PATH_K3, K3_THREADS
    Cbp = Cb + 4 if vec and Fb // 8 < 4 else Cb
    threads = -(-work // 32) * 32
    TH, TW = min(WGRAD_TILE_H, H_O), min(WGRAD_TILE_W, W_O)
    while True:
        smem = WGRAD_STAGES * 4 * _stage_floats(TH, TW, S, K, Cbp, Fb)
        per_sm = _blocks_per_sm(threads, smem, path)
        blocks = (N * -(-H_O // TH) * -(-W_O // TW) * -(-C // Cb)
                  * -(-F // Fb))
        if smem <= SMEM_MAX and (
                TH * TW <= WGRAD_MIN_PIXELS
                or (per_sm * threads >= 32 * WGRAD_MIN_WARPS
                    and blocks >= WGRAD_SMS)):
            break
        if TH == TW == 1:
            raise ValueError(f"no weight-gradient tile fits K={K}, S={S}, "
                             f"Cb={Cb} in {SMEM_MAX} bytes")
        if TW >= TH:
            TW = -(-TW // 2)
        else:
            TH = -(-TH // 2)
    n_th, n_tw = -(-H_O // TH), -(-W_O // TW)
    n_c, n_f = -(-C // Cb), -(-F // Fb)
    items = N * n_th * n_tw
    slab = K * K * C * F * 4
    n_split = fewest_ranges(items, n_c * n_f, WGRAD_SMS * per_sm,
                            min(65535, WGRAD_WORKSPACE_MAX // slab))
    return WgradTile(H_O=H_O, W_O=W_O, p=p, TH=TH, TW=TW, n_th=n_th,
                     n_tw=n_tw, path=path, Cb=Cb, Cbp=Cbp, Fb=Fb,
                     n_c=n_c, n_f=n_f, work=work, threads=threads,
                     n_split=n_split, smem_bytes=smem, blocks_per_sm=per_sm)


def wgrad_thread_outputs(t: WgradTile, K: int, tid: int):
    """The (tap, channel, filter) of dw, within the block's tile, that
    thread ``tid``'s accumulators hold (the kernel's own mapping: 8 rows x
    8 filters, or on the K = 3 path 9 taps x 8 filters; rows past K*K*Cb
    left out)."""
    if tid >= t.work:
        return []
    FG = t.Fb // 8
    fg, rg = tid % FG, tid // FG
    filters = [h * (t.Fb // 2) + fg * 4 + j for h in (0, 1) for j in range(4)]
    if t.path == PATH_K3:
        rows = [(tap, rg) for tap in range(K * K)]
    elif t.path == PATH_VEC:
        tap, cg = divmod(rg, t.Cb // 8)
        rows = [(tap, h * (t.Cb // 2) + cg * 4 + j)
                for h in (0, 1) for j in range(4)]
    else:
        rows = [divmod(r, t.Cb) for r in range(rg * 8, rg * 8 + 8)
                if r < K * K * t.Cb]
    return [(tap, c, f) for tap, c in rows for f in filters]


@dataclass(frozen=True)
class WgradBf16Tile:
    """One bf16 weight-gradient call's launch geometry on the GPU."""

    H_O: int
    W_O: int
    p: int            # symmetric zero padding
    path: int         # BF16_GEMM or BF16_WINDOW
    depth: int        # K*K*C: dw's rows
    n_m: int          # GEMM: depth tiles of BF16_M; window: channel tiles
    n_f: int          # filter tiles (BF16_N or WIN_F)
    n_tg: int         # window: tap groups of WIN_TAPS (GEMM: 1)
    TH: int           # window: output rows a chunk (GEMM: 0)
    TW: int           # window: output cols a chunk (GEMM: 0)
    rows: int         # window: the chunk's haloed input window
    cols: int
    stages: int       # window: TMA ring stages (GEMM: its 3 cp.async)
    n_chunks: int     # chunks over the batch (GEMM: of BF16_P pixels)
    n_split: int      # contiguous ranges of chunks
    cluster: int      # window: ranges a cluster sums in shared memory
    smem_bytes: int

    @property
    def n_part(self) -> int:
        """The partials summed into dw by the second launch (1: none)."""
        return self.n_split // self.cluster


def _win_smem(rows: int, cols: int, stages: int) -> int:
    """The window path's shared memory: ``stages`` x (the window, rounded
    up to 1024 bytes, the cotangent tile of WIN_PIXELS rows and two
    mbarriers), and 1024 bytes to align the base."""
    win = -(-(rows * cols * 128) // 1024) * 1024
    return stages * (win + WIN_PIXELS * 128 + 16) + 1024


@functools.lru_cache(maxsize=256)
def wgrad_bf16_tile(x_shape: Tuple[int, int, int, int], k: int, f: int, *,
                    stride: int, padding: Optional[int]) -> WgradBf16Tile:
    """The bf16 lane's geometry for x (N,H,W,C) and dw (k,k,C,f).

    The window path where C and f are multiples of 8 (the tensor maps'
    row strides must be 16-byte multiples), else the GEMM path.  Window
    path: a block owns WIN_C channels x WIN_F filters x up to WIN_TAPS
    taps of dw; its chunk is the TH x TW output tile (TH * TW <=
    WIN_PIXELS, the haloed window's rows and cols <= TMA_BOX_MAX) with the
    fewest chunks over the image, then the least window per pixel, then
    the widest; the ring takes the most stages (<= WIN_MAX_STAGES)
    that fit :data:`SMEM_MAX`.  GEMM path: 64 depth rows x 64 filters a
    block, the N*H_O*W_O output pixels in chunks of :data:`BF16_P`.
    Either way the chunks are cut into the fewest contiguous ranges that
    minimise the makespan over the blocks the card holds at once
    (:func:`fewest_ranges`), within :data:`WGRAD_WORKSPACE_MAX` of
    scratch.  On the window path, where the ring holds a block's staged
    sums, the ranges form clusters of :data:`WIN_CLUSTER_CAP` blocks that
    sum theirs in shared memory (the ranges rounded down to a multiple of
    the cluster; the kernel takes up to :data:`WIN_MAX_CLUSTER`), so only
    one partial a cluster reaches device memory.  Raises where no chunk fits."""
    N, H, W, C = (int(v) for v in x_shape)
    S, K, F = int(stride), int(k), int(f)
    if S < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    p = K // 2 if padding is None else int(padding)
    H_O, W_O = _out_hw(H, W, K, S, p)
    if H_O < 1 or W_O < 1:
        raise ValueError(f"empty conv output for input {(H, W)}, k={K}, p={p}")
    depth = K * K * C
    cap = min(65535, WGRAD_WORKSPACE_MAX // (depth * F * 4))
    if C % 8 or F % 8:
        n_m, n_f = -(-depth // BF16_M), -(-F // BF16_N)
        n_chunks = -(-(N * H_O * W_O) // BF16_P)
        n_split = fewest_ranges(n_chunks, n_m * n_f,
                                WGRAD_SMS * BF16_BLOCKS_PER_SM, cap)
        return WgradBf16Tile(
            H_O=H_O, W_O=W_O, p=p, path=BF16_GEMM, depth=depth, n_m=n_m,
            n_f=n_f, n_tg=1, TH=0, TW=0, rows=0, cols=0, stages=3,
            n_chunks=n_chunks, n_split=n_split, cluster=1,
            smem_bytes=BF16_GEMM_SMEM)
    best = None
    for TW in range(1, min(W_O, WIN_PIXELS) + 1):
        for TH in range(1, min(H_O, WIN_PIXELS // TW) + 1):
            rows, cols = (TH - 1) * S + K, (TW - 1) * S + K
            if rows > TMA_BOX_MAX or cols > TMA_BOX_MAX:
                continue
            if _win_smem(rows, cols, 2) > SMEM_MAX:
                continue
            key = (-(-H_O // TH) * -(-W_O // TW), rows * cols / (TH * TW),
                   -TW)
            if best is None or key < best[0]:
                best = (key, TH, TW, rows, cols)
    if best is None:
        raise ValueError(f"no bf16 weight-gradient chunk fits K={K}, S={S} "
                         f"in {SMEM_MAX} bytes of shared memory")
    _, TH, TW, rows, cols = best
    stages = max(st for st in range(2, WIN_MAX_STAGES + 1)
                 if _win_smem(rows, cols, st) <= SMEM_MAX)
    n_c, n_f = -(-C // WIN_C), -(-F // WIN_F)
    n_tg = -(-(K * K) // WIN_TAPS)
    n_chunks = N * -(-H_O // TH) * -(-W_O // TW)
    n_split = fewest_ranges(n_chunks, n_c * n_f * n_tg, WGRAD_SMS, cap)
    ring = stages * (_win_smem(rows, cols, 1) - 1040)
    cluster = 1
    if n_split > 1 and ring >= WIN_STAGE:
        cluster = min(n_split, WIN_CLUSTER_CAP)
        n_split -= n_split % cluster
    return WgradBf16Tile(
        H_O=H_O, W_O=W_O, p=p, path=BF16_WINDOW, depth=depth, n_m=n_c,
        n_f=n_f, n_tg=n_tg, TH=TH, TW=TW, rows=rows, cols=cols,
        stages=stages, n_chunks=n_chunks, n_split=n_split, cluster=cluster,
        smem_bytes=_win_smem(rows, cols, stages))


def wgrad_bf16_ranges(t: WgradBf16Tile):
    """The bf16 kernel's split: ``(k0, k1)`` chunks of each range."""
    return [(t.n_chunks * s // t.n_split, t.n_chunks * (s + 1) // t.n_split)
            for s in range(t.n_split)]


def wgrad_bf16_output_map(t: WgradBf16Tile, K: int, C: int, F: int):
    """Every dw element the bf16 kernel's threads write for one partial
    (a split range, or a cluster's sum of its ranges), as flat index
    tensors ``(row, filter)`` (row = tap * C + channel, dw's (K*K*C) x F
    rows).  Window path in clusters: block (channel tile, filter tile, tap
    group), the (tap, channel) row of the staged sums and its filter.
    Window path: block
    (channel tile,
    filter tile, tap group), consumer warpgroup wg (taps 3 wg .. 3 wg + 2
    of the group), warp wq, lane, accumulator (tap j, column group jj,
    half i, c): channel 16 wq + (lane >> 2) + 8 i, filter 8 jj + 2 (lane
    & 3) + c.  GEMM path: block (depth tile, filter tile), warp (32 x 32
    of the 64 x 64), m16n8 tile (i, nt), lane, accumulator q.  Those
    inside K*K taps, C channels and F filters."""
    if t.path == BF16_WINDOW and t.cluster > 1:
        ct = torch.arange(t.n_m).view(-1, 1, 1, 1, 1)
        ft = torch.arange(t.n_f).view(1, -1, 1, 1, 1)
        tg = torch.arange(t.n_tg).view(1, 1, -1, 1, 1)
        r = torch.arange(WIN_TAPS * WIN_C).view(1, 1, 1, -1, 1)
        f = torch.arange(WIN_F).view(1, 1, 1, 1, -1)
        # rank b sums rows [576 b / cluster, 576 (b + 1) / cluster): the
        # ranks' shares tile the rows, each row once
        tap = tg * WIN_TAPS + r // WIN_C
        ch = ct * WIN_C + r % WIN_C
        fo = ft * WIN_F + f
    elif t.path == BF16_WINDOW:
        sh = (-1,) + (1,) * 8
        ct = torch.arange(t.n_m).view(sh)
        ft = torch.arange(t.n_f).view(1, -1, *(1,) * 7)
        tg = torch.arange(t.n_tg).view(1, 1, -1, *(1,) * 6)
        wg = torch.arange(3).view(*(1,) * 3, -1, *(1,) * 5)
        wq = torch.arange(4).view(*(1,) * 4, -1, *(1,) * 4)
        lane = torch.arange(32).view(*(1,) * 5, -1, 1, 1, 1)
        j = torch.arange(3).view(*(1,) * 6, -1, 1, 1)
        jj = torch.arange(8).view(*(1,) * 7, -1, 1)
        ic = torch.arange(4).view(*(1,) * 8, -1)
        tap = tg * WIN_TAPS + wg * 3 + j
        ch = ct * WIN_C + 16 * wq + lane // 4 + 8 * (ic // 2)
        fo = ft * WIN_F + 8 * jj + 2 * (lane % 4) + ic % 2
    else:
        mt = torch.arange(t.n_m).view(-1, 1, 1, 1, 1, 1, 1)
        ft = torch.arange(t.n_f).view(1, -1, 1, 1, 1, 1, 1)
        warp = torch.arange(4).view(1, 1, -1, 1, 1, 1, 1)
        i = torch.arange(2).view(1, 1, 1, -1, 1, 1, 1)
        nt = torch.arange(4).view(1, 1, 1, 1, -1, 1, 1)
        lane = torch.arange(32).view(1, 1, 1, 1, 1, -1, 1)
        q = torch.arange(4).view(1, 1, 1, 1, 1, 1, -1)
        m = (mt * BF16_M + (warp % 2) * 32 + 16 * i + lane // 4
             + 8 * (q // 2))
        fo = ft * BF16_N + (warp // 2) * 32 + 8 * nt + (lane % 4) * 2 + q % 2
        tap, ch = m // C, m % C
    tap, ch, fo = torch.broadcast_tensors(tap, ch, fo)
    keep = (tap < K * K) & (ch < C) & (fo < F)
    return (tap * C + ch)[keep], fo[keep]


def wgrad_ranges(t: WgradTile, N: int):
    """The kernel's split: ``(i0, i1)`` items of each of the n_split
    ranges of the N * n_th * n_tw (image, output tile) items."""
    items = N * t.n_th * t.n_tw
    return [(items * s // t.n_split, items * (s + 1) // t.n_split)
            for s in range(t.n_split)]


@functools.lru_cache(maxsize=256)
def _launch_args(x_shape: Tuple[int, int, int, int], K: int, F: int, S: int,
                 padding: Optional[int], x_aligned: bool, g_aligned: bool):
    """The geometry and the C function's integer arguments for one shape
    (cached: the wrapper's host time bounds the small shapes)."""
    N, H, W, C = x_shape
    t = wgrad_tile(x_shape, K, F, stride=S, padding=padding)
    vec_x = t.Cb % 4 == 0 and C % 4 == 0 and x_aligned
    vec_g = F % 4 == 0 and g_aligned
    return t, (N, H, W, C, K, F, t.H_O, t.W_O, S, t.p, t.TH, t.TW, t.Cb,
               t.Cbp, t.Fb, t.path, t.threads, t.n_split, int(vec_x),
               int(vec_g), t.smem_bytes)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the weight-gradient library, with its
    ctypes signatures declared; returns it."""
    lib = _build.load(_LIB_NAME, _SOURCES)
    if lib not in _BOUND:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trim_conv2d_wgrad_f32.argtypes = [p] * 4 + [i] * 21 + [p]
        lib.trim_conv2d_wgrad_f32.restype = i
        lib.trim_conv2d_wgrad_bf16.argtypes = [p] * 4 + [i] * 17 + [p]
        lib.trim_conv2d_wgrad_bf16.restype = i
        lib.trim_conv2d_wgrad_bf16_tile.argtypes = [i]
        lib.trim_conv2d_wgrad_bf16_tile.restype = i
        lib.trim_conv2d_wgrad_error_string.argtypes = [i]
        lib.trim_conv2d_wgrad_error_string.restype = ctypes.c_char_p
        for name in ("max_threads", "stages"):
            getattr(lib, f"trim_conv2d_wgrad_{name}").restype = i
        if (lib.trim_conv2d_wgrad_max_threads() != WGRAD_MAX_THREADS
                or lib.trim_conv2d_wgrad_stages() != WGRAD_STAGES
                or [lib.trim_conv2d_wgrad_bf16_tile(j) for j in range(10)]
                != [BF16_M, BF16_N, BF16_P, WIN_C, WIN_F, WIN_TAPS,
                    WIN_MAX_STAGES, WIN_PIXELS, WIN_MAX_CLUSTER,
                    WIN_STAGE]):
            raise RuntimeError("trim_conv2d_wgrad library constants differ "
                               "from the wrapper's")
        _BOUND.add(lib)
    return lib


def _out_hw(H: int, W: int, K: int, S: int, p: int) -> Tuple[int, int]:
    return (H + 2 * p - K) // S + 1, (W + 2 * p - K) // S + 1


def trim_conv2d_wgrad_plain(x: torch.Tensor, g: torch.Tensor, *, K: int,
                            stride: int = 1,
                            padding: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: for every tap,
    ``dw[kh, kw] = einsum('nhwc,nhwf->cf', x_pad[:, kh::S, kw::S][:, :H_O,
    :W_O], g)`` in fp32.  Returns (K,K,C,F) fp32."""
    N, H, W, C = x.shape
    S = int(stride)
    p = K // 2 if padding is None else int(padding)
    H_O, W_O = _out_hw(H, W, K, S, p)
    if tuple(g.shape[1:3]) != (H_O, W_O):
        raise ValueError(f"cotangent {tuple(g.shape)} does not fit the conv "
                         f"output ({H_O}, {W_O})")
    # rows 0 .. (H_O-1)*S + K - 1 of the padded input are read
    back_h = max(0, (H_O - 1) * S + K - H - p)
    back_w = max(0, (W_O - 1) * S + K - W - p)
    xp = F.pad(x.float(), (0, 0, p, back_w, p, back_h))
    gf = g.float()
    taps = []
    for kh in range(K):
        for kw in range(K):
            view = xp[:, kh:kh + (H_O - 1) * S + 1:S,
                      kw:kw + (W_O - 1) * S + 1:S]
            taps.append(torch.einsum("nhwc,nhwf->cf", view, gf))
    return torch.stack(taps).reshape(K, K, C, g.shape[-1])


def trim_conv2d_wgrad(x: torch.Tensor, g: torch.Tensor, *, K: int,
                      stride: int = 1,
                      padding: Optional[int] = None) -> torch.Tensor:
    """dL/dw of the TrIM conv: x (N,H,W,C), g (N,H_O,W_O,F) -> (K,K,C,F)
    fp32.

    A CPU ``x`` runs :func:`trim_conv2d_wgrad_plain`; a CUDA ``x``
    launches the kernel on the current stream, or raises: fp32 x and g on
    the fp32 lane (:func:`wgrad_tile`), bf16 x and g on the bf16 lane
    (:func:`wgrad_bf16_tile`, fp32 sums).  One count in
    :data:`WGRAD_LAUNCHES` a call, and one in its lane's
    :data:`WGRAD_LAUNCHES_BY_LANE`.
    """
    global WGRAD_LAUNCHES
    dev = x.device  # one device object: each ``.device`` builds a new one
    if dev.type == "cpu":
        return trim_conv2d_wgrad_plain(x, g, K=K, stride=stride,
                                       padding=padding)
    if dev.type != "cuda":
        raise ValueError(f"trim_conv2d_wgrad runs on cuda or cpu, not "
                         f"{dev}")
    if x.dim() != 4 or g.dim() != 4 or g.shape[0] != x.shape[0]:
        raise ValueError(f"x must be NHWC and g (N,H_O,W_O,F): "
                         f"{tuple(x.shape)}, {tuple(g.shape)}")
    if x.dtype != g.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16 x and g of "
                         f"one dtype, got {x.dtype}, {g.dtype}")
    if g.device != dev or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("trim_conv2d_wgrad needs contiguous operands on "
                         "one device")
    if x.dtype == torch.bfloat16:
        return _wgrad_bf16(x, g, int(K), int(stride), padding)
    xp, gp = x.data_ptr(), g.data_ptr()
    t, args = _launch_args(tuple(x.shape), int(K), int(g.shape[-1]),
                           int(stride), padding, xp % 16 == 0, gp % 16 == 0)
    if tuple(g.shape[1:3]) != (t.H_O, t.W_O):
        raise ValueError(f"cotangent {tuple(g.shape)} does not fit the conv "
                         f"output ({t.H_O}, {t.W_O})")
    shape = (K, K, x.shape[3], g.shape[3])
    dw = torch.empty(shape, dtype=torch.float32, device=dev)
    ws = (None if t.n_split == 1 else
          torch.empty((t.n_split, *shape), dtype=torch.float32, device=dev))
    lib = load_library()
    wsp = None if ws is None else ws.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.trim_conv2d_wgrad_f32(
            xp, gp, dw.data_ptr(), wsp, *args,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.trim_conv2d_wgrad_error_string(rc).decode()
        raise RuntimeError(f"trim_conv2d_wgrad launch failed: CUDA error "
                           f"{rc} ({msg})")
    WGRAD_LAUNCHES += 1
    WGRAD_LAUNCHES_BY_LANE["f32"] += 1
    return dw


def _wgrad_bf16(x: torch.Tensor, g: torch.Tensor, K: int, S: int,
                padding: Optional[int]) -> torch.Tensor:
    """:func:`trim_conv2d_wgrad`'s bf16 lane on checked CUDA operands."""
    global WGRAD_LAUNCHES
    dev = x.device
    t = wgrad_bf16_tile(tuple(x.shape), K, int(g.shape[-1]), stride=S,
                        padding=padding)
    if tuple(g.shape[1:3]) != (t.H_O, t.W_O):
        raise ValueError(f"cotangent {tuple(g.shape)} does not fit the conv "
                         f"output ({t.H_O}, {t.W_O})")
    N, H, W, C = x.shape
    if t.path == BF16_WINDOW and (x.data_ptr() % 16 or g.data_ptr() % 16):
        raise ValueError("the bf16 window path's tensor maps need x and g "
                         "16-byte aligned")
    shape = (K, K, C, g.shape[3])
    dw = torch.empty(shape, dtype=torch.float32, device=dev)
    ws = (None if t.n_part == 1 else
          torch.empty((t.n_part, *shape), dtype=torch.float32, device=dev))
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.trim_conv2d_wgrad_bf16(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(),
            None if ws is None else ws.data_ptr(), N, H, W, C, K,
            shape[3], t.H_O, t.W_O, S, t.p, t.path, t.TH, t.TW, t.stages,
            t.n_split, t.cluster, t.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.trim_conv2d_wgrad_error_string(rc).decode()
        raise RuntimeError(f"trim_conv2d_wgrad launch failed: CUDA error "
                           f"{rc} ({msg})")
    WGRAD_LAUNCHES += 1
    WGRAD_LAUNCHES_BY_LANE["bf16"] += 1
    return dw


def trim_conv2d_input_grad(g: torch.Tensor, w: torch.Tensor, *,
                           x_hw: Tuple[int, int], stride: int = 1,
                           padding: Optional[int] = None,
                           schedule: Optional[Schedule] = None
                           ) -> torch.Tensor:
    """dL/dx of the TrIM conv: g (N,H_O,W_O,F), w (K,K,C,F) -> (N,H,W,C).

    The forward kernel at stride 1 with the weights flipped and transposed
    to (K,K,F,C).  At stride 1 with p <= K-1 the kernel's own zero fill at
    padding K-1-p gives exactly H x W outputs from the cotangent as it is.
    Otherwise the cotangent is zero-stuffed by the stride, padded with
    K-1-p rows and columns in front and up to H+K-1 in all (cropped in
    front when p > K-1), and the result cropped to H x W; input pixels that
    no output reads get zero.  ``schedule`` overrides the geometry of
    that stride-1 conv (over F channels into C filters), checked as the
    forward's; None plans it from its own shape.
    """
    N, H_O, W_O, Fo = g.shape
    K = w.shape[0]
    H, W = int(x_hw[0]), int(x_hw[1])
    S = int(stride)
    p = K // 2 if padding is None else int(padding)
    w_t = w.flip(0, 1).permute(0, 1, 3, 2).contiguous()      # (K, K, F, C)
    if S == 1 and p <= K - 1 and (H_O, W_O) == (H + 2 * p - K + 1,
                                                W + 2 * p - K + 1):
        return trim_conv2d(g.contiguous(), w_t, stride=1, padding=K - 1 - p,
                           schedule=schedule)
    if S > 1:
        Hd, Wd = (H_O - 1) * S + 1, (W_O - 1) * S + 1
        gd = g.new_zeros((N, Hd, Wd, Fo))
        gd[:, ::S, ::S, :] = g
    else:
        Hd, Wd, gd = H_O, W_O, g
    lo = K - 1 - p
    if lo < 0:                      # p > K-1: crop instead of (negative) pad
        gd = gd[:, -lo:, -lo:, :]
        Hd, Wd = Hd + lo, Wd + lo
    top = max(lo, 0)
    # (C, W, H) pads: H+K-1 rows in all, so the stride-1 sweep emits >= H
    gd = F.pad(gd, (0, 0, top, max(W + K - 1 - top - Wd, 0),
                    top, max(H + K - 1 - top - Hd, 0))).contiguous()
    dx = trim_conv2d(gd, w_t, stride=1, padding=0, schedule=schedule)
    return dx[:, :H, :W].contiguous()


class TrimConv2dFn(torch.autograd.Function):
    """The fused TrIM conv (+ bias, + ReLU) with the TrIM backward.

    ``TrimConv2dFn.apply(x, w, bias, plan)``: ``plan`` carries the static
    schedule (``stride``, ``padding``, ``relu`` and the launch overrides
    ``schedule`` — a ``ConvLayerPlan``).  The forward is kernel 1 with its
    fused epilogue and saves x, w and the output; the dx conv, of another
    shape, is planned from its own (a forward schedule is measured at the
    forward's shape).  The
    backward rebuilds the ReLU mask from the saved output (out > 0, so
    the gradient at exactly 0 is 0), then computes dx through kernel 1
    only when x needs it (never for a network's input), dw through the
    weight-gradient kernel and the bias gradient as the masked
    cotangent's fp32 sum.  Cotangent dtypes follow the primals.  bf16
    primals stay bf16: dx runs kernel 1's bf16 lane on the bf16 cotangent
    and weights, dw kernel 2's bf16 lane (fp32 sums, rounded once to
    w's dtype), as the JAX package's VJP does.  On CPU tensors both
    kernels' plain versions run.
    """

    @staticmethod
    def forward(ctx, x, w, bias, plan):
        out = trim_conv2d(x, w, stride=plan.stride, padding=plan.padding,
                          bias=bias, relu=plan.relu, schedule=plan.schedule)
        ctx.save_for_backward(x, w, out)
        ctx.plan = plan
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        plan = ctx.plan
        gm = g * (out > 0).to(g.dtype) if plan.relu else g
        # one dtype for both kernels: the primals' where they share one
        dt = x.dtype if x.dtype == w.dtype else torch.float32
        gm = gm.to(dt).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = trim_conv2d_input_grad(
                gm, w.to(dt), x_hw=x.shape[1:3], stride=plan.stride,
                padding=plan.padding).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = trim_conv2d_wgrad(x.to(dt).contiguous(), gm, K=w.shape[0],
                                   stride=plan.stride,
                                   padding=plan.padding).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = gm.float().sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db, None
