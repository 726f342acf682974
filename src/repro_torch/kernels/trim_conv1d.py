"""TrIM conv1d on Hopper: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/trim_conv1d.py`` (``_trim_conv1d_kernel`` at line
24, driven by ``trim_conv1d_pallas`` at line 40): the causal depthwise
conv before Mamba's SSD.  The kernel itself is
``repro_torch/csrc/trim_conv1d.cu``; its header says what it keeps out of
device memory and what bounds it.

- :func:`trim_conv1d` is the wrapper: a CUDA tensor launches the kernel
  (or the wrapper raises), a CPU tensor takes :func:`trim_conv1d_plain`.
  Every launch adds one to :data:`LAUNCHES`.  Where autograd records the
  call (an input that needs a gradient, under grad mode), it runs through
  :class:`TrimConv1dFn`: the same forward, and the plain version's VJP
  as the backward.
- :func:`trim_conv1d_plain` is the same function in plain PyTorch
  (``ref.conv1d_causal_ref``): the taps summed in fp32 in order from zero,
  each product and sum rounded on its own, one cast to ``x.dtype``, which
  is how the kernel rounds, so the two agree bit for bit on the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._autograd import needs_grad, plain_vjp

#: Launches of the CUDA kernel since the last reset (a plain counter:
#: callers set it to 0 before a run and read it after).
LAUNCHES = 0

#: Most taps the kernel is compiled for.
MAX_K = 8
#: The kernel's geometry: THREADS a block; a thread owns one 16-byte
#: vector of channels over a run of positions, loaded ROWS[dtype] at a
#: time; the launch bounds keep BLOCKS_PER_SM[K] blocks resident on each
#: of an H100's SMS streaming multiprocessors.
THREADS = 256
ROWS = {torch.bfloat16: 4, torch.float32: 8}
SMS = 132
BLOCKS_PER_SM = {k: 2 if k <= 4 else 1 for k in range(1, MAX_K + 1)}

_LIB_NAME = "trim_conv1d"
_SOURCES = ("trim_conv1d.cu",)
_BOUND: set = set()
_DTYPES = (torch.float32, torch.bfloat16)
#: the loaded library, kept after the first launch (no lookup per call)
_LIB = None


class Plan(NamedTuple):
    """One launch's geometry: ``vec`` channels a thread (16 bytes),
    ``span`` positions a thread, ``runs`` = ceil(L / span), ``dvecs`` =
    ceil(D / vec), ``threads`` = B x runs x dvecs (thread t: channel
    vector t % dvecs, run (t // dvecs) % runs, image t // (dvecs x runs))
    and ``blocks`` of THREADS."""
    vec: int
    span: int
    runs: int
    dvecs: int
    threads: int
    blocks: int


def plan(B: int, L: int, D: int, K: int, dtype: torch.dtype) -> Plan:
    """The launch geometry, from the shape alone: the span (a multiple of
    ROWS[dtype]) is the shortest that keeps the B x ceil(D / vec)
    columns' runs within one wave of BLOCKS_PER_SM[K] x SMS resident
    blocks, so every thread owns about the same number of positions and
    no shape ends on a short tail wave; where the columns alone pass a
    wave, one chunk of ROWS[dtype] positions a thread."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    rows = ROWS[dtype]
    dvecs = -(-D // vec)
    wave = BLOCKS_PER_SM[K] * SMS * THREADS
    cols = B * dvecs
    runs_wanted = wave // cols if cols < wave else L
    span = -(-max(1, -(-L // runs_wanted)) // rows) * rows
    runs = -(-L // span)
    threads = B * runs * dvecs
    return Plan(vec, span, runs, dvecs, threads, -(-threads // THREADS))


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (B, L, D) and w (K, D): "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if not 1 <= w.shape[0] <= MAX_K:
        raise ValueError(f"K = {w.shape[0]} taps; the kernel takes 1..{MAX_K}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or bfloat16, got "
                         f"x={x.dtype}, w={w.dtype}")


def trim_conv1d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch. x (B,L,D), w (K,D) -> (B,L,D)."""
    _check(x, w)
    return ref.conv1d_causal_ref(x, w)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its ctypes
    signatures declared; returns it."""
    lib = _build.load(_LIB_NAME, _SOURCES)
    if lib not in _BOUND:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.trim_conv1d.argtypes = [p, p, p, i, ll, ll, ll, i, ll, ll, ll,
                                    p]
        lib.trim_conv1d.restype = i
        lib.trim_conv1d_error_string.argtypes = [i]
        lib.trim_conv1d_error_string.restype = ctypes.c_char_p
        for fn in ("trim_conv1d_max_k", "trim_conv1d_threads",
                   "trim_conv1d_rows", "trim_conv1d_blocks_per_sm"):
            getattr(lib, fn).restype = i
        lib.trim_conv1d_blocks_per_sm.argtypes = [i]
        lib.trim_conv1d_rows.argtypes = [i]
        got = (lib.trim_conv1d_max_k(), lib.trim_conv1d_threads(),
               {dt: lib.trim_conv1d_rows(int(dt == torch.bfloat16))
                for dt in ROWS},
               {k: lib.trim_conv1d_blocks_per_sm(k) for k in BLOCKS_PER_SM})
        if got != (MAX_K, THREADS, ROWS, BLOCKS_PER_SM):
            raise RuntimeError("trim_conv1d library constants differ from "
                               "the wrapper's")
        _BOUND.add(lib)
    return lib


def _load() -> ctypes.CDLL:
    global _LIB
    _LIB = load_library()
    return _LIB


class TrimConv1dFn(torch.autograd.Function):
    """The conv1d under autograd (the Mamba mixer in training).

    Forward: the wrapper's call (the kernel on a CUDA tensor, counted in
    :data:`LAUNCHES`; the plain version on a CPU one).  Backward: the VJP
    of :func:`trim_conv1d_plain`, recomputed under autograd from the saved
    x and w.  This is no fallback: the Pallas kernel
    (``repro/kernels/trim_conv1d.py:24``) has no backward kernel, and the
    JAX package takes this conv's gradient through its oracle, so there
    is no backward kernel to port.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return _conv1d(x, w)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return plain_vjp(trim_conv1d_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad)


def trim_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv. x (B, L, D), w (K, D) -> (B, L, D) in x's
    dtype (fp32 or bf16; fp32 accumulation).

    ``x`` may be a strided view whose channel stride is 1 (a column slice
    of a wider tensor is read in place); ``w`` must be contiguous.  A CPU
    ``x`` runs :func:`trim_conv1d_plain`; a CUDA ``x`` launches the kernel
    on the current stream, or raises.  A call that autograd records goes
    through :class:`TrimConv1dFn`.
    """
    if needs_grad(x, w):
        return TrimConv1dFn.apply(x, w)
    return _conv1d(x, w)


def _conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The wrapper's forward: the plain version on a CPU ``x``, the
    kernel on a CUDA one."""
    global LAUNCHES
    if x.device.type == "cpu":
        return trim_conv1d_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"trim_conv1d runs on cuda or cpu, not {x.device}")
    _check(x, w)
    B, L, D = x.shape
    K = int(w.shape[0])
    if w.device != x.device or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous tensor on {x.device}")
    if D > 1 and x.stride(2) != 1:
        raise ValueError(f"x's channel stride is {x.stride(2)}: the kernel "
                         "reads channels contiguously")
    if min(x.stride(0), x.stride(1)) < 0:
        raise ValueError(f"negative strides {x.stride()} are not handled")
    out = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = plan(B, L, D, K, x.dtype)
    if p.blocks >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} exceeds the launch grid")
    lib = _LIB or _load()
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), B, L, D, K, x.stride(0),
            x.stride(1), p.span)
    with torch.cuda.device(x.device):
        rc = lib.trim_conv1d(
            *args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.trim_conv1d_error_string(rc).decode()
        raise RuntimeError(f"trim_conv1d launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES += 1
    return out
