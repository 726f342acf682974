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
- :func:`wgrad_tile` is the kernel's geometry: output tile, channel and
  filter tile, how the taps spread over the threads, and into how many
  ranges the (image, output tile) reduction is cut to fill the card.
- :func:`trim_conv2d_input_grad` is dL/dx as a forward TrIM conv at
  stride 1 (``kernels.trim_conv2d.trim_conv2d``, kernel 1) on the
  zero-stuffed, padded cotangent and the flipped, transposed weights.
- :class:`TrimConv2dFn` is the fused conv + bias + ReLU with this
  backward (``make_trim_conv2d_vjp`` at line 223).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.trim_conv2d import SMEM_MAX, trim_conv2d

#: Launches of the weight-gradient kernel since the last reset (a plain
#: counter: callers set it to 0 before a run and read it after).
WGRAD_LAUNCHES = 0

#: Threads per block, taps one thread may hold (NT) and filters one block
#: computes (Fb); all three are compiled into the kernel.
WGRAD_THREADS = 256
WGRAD_MAX_TAPS = 16
WGRAD_FILT_TILE = 32
#: Output tile of one reduction item (the forward kernel's default).
WGRAD_TILE_H, WGRAD_TILE_W = 8, 16
#: Blocks the reduction split aims for: two resident blocks on each of
#: the H100's 132 SMs.
WGRAD_TARGET_BLOCKS = 264
#: Most scratch the split partials may take.
WGRAD_WORKSPACE_MAX = 256 * 1024 * 1024

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
    Cb: int           # channels per block
    Fb: int           # filters per block (a multiple of 4)
    n_c: int
    n_f: int
    G: int            # tap groups: group j owns taps j, j+G, ...
    NT: int           # taps per thread
    n_split: int      # ranges the (image, output tile) reduction is cut into
    smem_bytes: int


def _window_bytes(TH: int, TW: int, S: int, K: int, Cb: int, Fb: int) -> int:
    rows, cols = (TH - 1) * S + K, (TW - 1) * S + K
    return 4 * (-(-(Cb * rows * cols) // 4) * 4 + TH * TW * Fb)


def wgrad_tile(x_shape: Tuple[int, int, int, int], k: int, f: int, *,
               stride: int, padding: Optional[int]) -> WgradTile:
    """Geometry for x (N,H,W,C) and dw (k,k,C,f).

    The filter tile is ``min(32, f)`` rounded up to 4.  The channel tile
    is the largest ``Cb <= min(C, 32)`` whose Cb x Fb/4 thread lanes fit
    the block and leave enough lane groups that no thread holds more than
    :data:`WGRAD_MAX_TAPS` taps (K=3 takes Cb 32, K=5 16, K=11 4), with
    the window and cotangent tile inside the shared memory.  The
    reduction is then cut into enough ranges for
    :data:`WGRAD_TARGET_BLOCKS` blocks, never more ranges than items and never more scratch than
    :data:`WGRAD_WORKSPACE_MAX`.
    """
    N, H, W, C = (int(v) for v in x_shape)
    S, K = int(stride), int(k)
    if S < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    p = K // 2 if padding is None else int(padding)
    H_O = (H + 2 * p - K) // S + 1
    W_O = (W + 2 * p - K) // S + 1
    if H_O < 1 or W_O < 1:
        raise ValueError(f"empty conv output for input {(H, W)}, k={K}, p={p}")
    TH, TW = min(WGRAD_TILE_H, H_O), min(WGRAD_TILE_W, W_O)
    Fb = min(WGRAD_FILT_TILE, -(-int(f) // 4) * 4)
    lanes_f = Fb // 4
    for Cb in range(min(C, 32), 0, -1):
        L = Cb * lanes_f
        if L > WGRAD_THREADS:
            continue
        G = WGRAD_THREADS // L
        NT = -(-K * K // G)
        smem = _window_bytes(TH, TW, S, K, Cb, Fb)
        if NT <= WGRAD_MAX_TAPS and smem <= SMEM_MAX:
            break
    else:
        raise ValueError(f"no weight-gradient tile fits K={K}, S={S}, "
                         f"tile {TH}x{TW}")
    n_th, n_tw = -(-H_O // TH), -(-W_O // TW)
    n_c, n_f = -(-C // Cb), -(-int(f) // Fb)
    items = N * n_th * n_tw
    slab = K * K * C * int(f) * 4
    n_split = max(1, min(items, 65535,
                         -(-WGRAD_TARGET_BLOCKS // (n_c * n_f)),
                         WGRAD_WORKSPACE_MAX // slab))
    return WgradTile(H_O=H_O, W_O=W_O, p=p, TH=TH, TW=TW, n_th=n_th,
                     n_tw=n_tw, Cb=Cb, Fb=Fb, n_c=n_c, n_f=n_f, G=G, NT=NT,
                     n_split=n_split, smem_bytes=smem)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the weight-gradient library, with its
    ctypes signatures declared; returns it."""
    lib = _build.load(_LIB_NAME, _SOURCES)
    if lib not in _BOUND:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trim_conv2d_wgrad_f32.argtypes = [p] * 4 + [i] * 18 + [p]
        lib.trim_conv2d_wgrad_f32.restype = i
        lib.trim_conv2d_wgrad_error_string.argtypes = [i]
        lib.trim_conv2d_wgrad_error_string.restype = ctypes.c_char_p
        for name in ("max_taps", "filt_tile", "threads"):
            getattr(lib, f"trim_conv2d_wgrad_{name}").restype = i
        if (lib.trim_conv2d_wgrad_max_taps() != WGRAD_MAX_TAPS
                or lib.trim_conv2d_wgrad_filt_tile() != WGRAD_FILT_TILE
                or lib.trim_conv2d_wgrad_threads() != WGRAD_THREADS):
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
    launches the kernel on the current stream, or raises.
    """
    global WGRAD_LAUNCHES
    if x.device.type == "cpu":
        return trim_conv2d_wgrad_plain(x, g, K=K, stride=stride,
                                       padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"trim_conv2d_wgrad runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dim() != 4 or g.dim() != 4 or g.shape[0] != x.shape[0]:
        raise ValueError(f"x must be NHWC and g (N,H_O,W_O,F): "
                         f"{tuple(x.shape)}, {tuple(g.shape)}")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 x and g, got {x.dtype}, "
                         f"{g.dtype}")
    if g.device != x.device or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("trim_conv2d_wgrad needs contiguous operands on "
                         "one device")
    N, H, W, C = x.shape
    Fo = g.shape[-1]
    t = wgrad_tile(x.shape, K, Fo, stride=stride, padding=padding)
    if tuple(g.shape[1:3]) != (t.H_O, t.W_O):
        raise ValueError(f"cotangent {tuple(g.shape)} does not fit the conv "
                         f"output ({t.H_O}, {t.W_O})")
    dw = torch.empty((K, K, C, Fo), dtype=torch.float32, device=x.device)
    ws = (None if t.n_split == 1 else
          torch.empty((t.n_split, K, K, C, Fo), dtype=torch.float32,
                      device=x.device))
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.trim_conv2d_wgrad_f32(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(),
            None if ws is None else ws.data_ptr(),
            N, H, W, C, K, Fo, t.H_O, t.W_O, int(stride), t.p, t.TH, t.TW,
            t.Cb, t.Fb, t.G, t.NT, t.n_split, t.smem_bytes, stream)
    if rc != 0:
        msg = lib.trim_conv2d_wgrad_error_string(rc).decode()
        raise RuntimeError(f"trim_conv2d_wgrad launch failed: CUDA error "
                           f"{rc} ({msg})")
    WGRAD_LAUNCHES += 1
    return dw


def trim_conv2d_input_grad(g: torch.Tensor, w: torch.Tensor, *,
                           x_hw: Tuple[int, int], stride: int = 1,
                           padding: Optional[int] = None, tile_h: int = 8,
                           tile_w: int = 16, block_c: int = 32,
                           block_f: int = 32) -> torch.Tensor:
    """dL/dx of the TrIM conv: g (N,H_O,W_O,F), w (K,K,C,F) -> (N,H,W,C).

    The cotangent is zero-stuffed by the stride, padded with K-1-p rows
    and columns in front and up to H+K-1 in all (cropped in front when
    p > K-1), and pushed through the forward kernel at stride 1 with the
    weights flipped and transposed to (K,K,F,C).  Input pixels that no
    output reads get zero.  ``block_c``/``block_f`` are the forward conv's
    and swap here.
    """
    N, H_O, W_O, Fo = g.shape
    K = w.shape[0]
    H, W = int(x_hw[0]), int(x_hw[1])
    S = int(stride)
    p = K // 2 if padding is None else int(padding)
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
    w_t = w.flip(0, 1).permute(0, 1, 3, 2).contiguous()      # (K, K, F, C)
    dx = trim_conv2d(gd, w_t, stride=1, padding=0, tile_h=tile_h,
                     tile_w=tile_w, block_c=block_f, block_f=block_c)
    return dx[:, :H, :W].contiguous()


class TrimConv2dFn(torch.autograd.Function):
    """The fused TrIM conv (+ bias, + ReLU) with the TrIM backward.

    ``TrimConv2dFn.apply(x, w, bias, plan)``: ``plan`` carries the static
    schedule (``stride``, ``padding``, ``relu``, ``tile_h``, ``tile_w``,
    ``block_c``, ``block_f`` — a ``ConvLayerPlan``).  The forward is
    kernel 1 with its fused epilogue and saves x, w and the output.  The
    backward rebuilds the ReLU mask from the saved output (out > 0, so
    the gradient at exactly 0 is 0), then computes dx through kernel 1
    only when x needs it (never for a network's input), dw through the
    weight-gradient kernel and the bias gradient as the masked
    cotangent's fp32 sum.  Cotangent dtypes follow the primals.  On CPU
    tensors both kernels' plain versions run.
    """

    @staticmethod
    def forward(ctx, x, w, bias, plan):
        out = trim_conv2d(x, w, stride=plan.stride, padding=plan.padding,
                          bias=bias, relu=plan.relu, tile_h=plan.tile_h,
                          tile_w=plan.tile_w, block_c=plan.block_c,
                          block_f=plan.block_f)
        ctx.save_for_backward(x, w, out)
        ctx.plan = plan
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        plan = ctx.plan
        gm = g * (out > 0).to(g.dtype) if plan.relu else g
        gm = gm.float().contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = trim_conv2d_input_grad(
                gm, w.float(), x_hw=x.shape[1:3], stride=plan.stride,
                padding=plan.padding, tile_h=plan.tile_h, tile_w=plan.tile_w,
                block_c=plan.block_c, block_f=plan.block_f).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = trim_conv2d_wgrad(x.float().contiguous(), gm, K=w.shape[0],
                                   stride=plan.stride,
                                   padding=plan.padding).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = gm.sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db, None
