"""TrIM matmul on Hopper: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/trim_matmul.py`` (``_matmul_kernel`` at line 27,
driven by ``trim_matmul_pallas`` at line 42): the K = 1 case of TrIM, a
blocked (M, K) @ (K, N) with the K axis's partial sums kept on chip.  The
kernel itself is ``repro_torch/csrc/trim_matmul.cu``; its header says what
it keeps out of device memory and what bounds it.

- :func:`trim_matmul` is the wrapper: a CUDA tensor launches the kernel
  on the path :func:`select_path` names (or the wrapper raises), a CPU
  tensor takes :func:`trim_matmul_plain`.  Every launch adds one to
  :data:`LAUNCHES` and to its path's count in :data:`LAUNCHES_BY_PATH`;
  :func:`check_launch` holds its arguments against the kernel's bounds
  first.
- :func:`trim_matmul_plain` is the same function in plain PyTorch
  (``ref.matmul_ref``): float inputs multiplied in fp32 and rounded once
  to the output type, int8 inputs exactly, to int32.

Paths (:data:`PATHS`), chosen from the dtype, M, the strides and the
pointers' alignment alone: ``stream`` for every lane at M <= 16 (b read
once, K split across blocks by :func:`stream_plan`, the splits summed in
a fixed order); ``wgmma`` for bfloat16 with TMA-aligned operands
(:func:`tma_aligned`); ``mma`` for the other bfloat16 and the int8
operands (``mma.sync`` tiles); ``fma`` for float32 (CUDA-core tiles).

Lanes: float32 (CUDA cores, IEEE, no TF32) and bfloat16 (fp32
accumulation) give ``out_dtype`` (float32 or bfloat16, default
``a.dtype``); int8 gives int32.  The int32 sum cannot wrap: K is at most
:data:`MAX_K_INT8`, so |sum| <= 128 * 128 * K < 2**31.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._autograd import refuse_grad

#: Launches of the CUDA kernel since the last reset (a plain counter:
#: callers set it to 0, or call :func:`reset_launches`, before a run and
#: read it after).
LAUNCHES = 0

#: The kernel's paths, and each one's code in the library.
PATHS = ("wgmma", "stream", "mma", "fma")
_PATH_CODES = {"mma": 0, "fma": 1, "wgmma": 2, "stream": 3}
#: Launches per path since the last :func:`reset_launches`.
LAUNCHES_BY_PATH: Dict[str, int] = dict.fromkeys(PATHS, 0)

#: The mma path's output tile (rows, columns); its grid's rows are at
#: most 65535 tiles.
BLOCK_M = 128
BLOCK_N = 128
#: The fma path's output tile (rows, columns: at most 65535 row tiles and
#: fewer than 2^31 column tiles).
FMA_BLOCK = (128, 128)
#: The wgmma path's output tile.
WGMMA_BLOCK = (128, 256)
#: The stream path: at most STREAM_ROWS rows of a; STREAM_COLS columns of
#: b a block; K cut into tiles of STREAM_K_TILE rows (8 KB of b), whole
#: tiles a split, at most STREAM_MAX_K rows a split; splits for about
#: STREAM_BLOCKS blocks (one wave of four per SM of an H100's 132).
STREAM_ROWS = 16
STREAM_COLS = 128
STREAM_K_TILE = {torch.float32: 16, torch.bfloat16: 32, torch.int8: 64}
STREAM_MAX_K = 256
STREAM_BLOCKS = 4 * 132
#: The largest K of the int8 lane: 128 * 128 * K stays below 2**31, so the
#: int32 accumulator never wraps and the exact plain version agrees.
MAX_K_INT8 = (2 ** 31 - 1) // (128 * 128)

_LIB_NAME = "trim_matmul"
_SOURCES = ("trim_matmul.cu",)
_BOUND: set = set()
#: input dtype -> (lane code, allowed output dtypes); the library's codes
_LANES = {torch.float32: (0, (torch.float32, torch.bfloat16)),
          torch.bfloat16: (1, (torch.float32, torch.bfloat16)),
          torch.int8: (2, (torch.int32,))}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _out_dtype(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """Check the operands; return the output dtype."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a must be (M, K) and b (K, N): {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.dtype not in _LANES or b.dtype != a.dtype:
        raise ValueError(f"a and b must both be float32, bfloat16 or int8, "
                         f"got a={a.dtype}, b={b.dtype}")
    allowed = _LANES[a.dtype][1]
    out = out_dtype or (torch.int32 if a.dtype == torch.int8 else a.dtype)
    if out not in allowed:
        raise ValueError(f"{a.dtype} inputs give {allowed}, not {out}")
    if a.dtype == torch.int8 and a.shape[1] > MAX_K_INT8:
        raise ValueError(f"K = {a.shape[1]} > {MAX_K_INT8}: the int32 sum "
                         "could wrap")
    return out


def trim_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch. a (M,K) @ b (K,N) -> (M,N)."""
    out = _out_dtype(a, b, out_dtype)
    if a.dtype == torch.int8:
        return ref.matmul_ref(a, b)
    return ref.matmul_ref(a.float(), b.float()).to(out)


def reset_launches() -> None:
    """Set :data:`LAUNCHES` and every path's count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_PATH.update(dict.fromkeys(PATHS, 0))


def tma_aligned(t: torch.Tensor) -> bool:
    """Whether the TMA can read ``t`` (2-d) as it lies: a 16-byte aligned
    base, a row stride of whole 16 bytes and at least one row's width
    (any, for one row: a broadcast or overlapping view has neither) and a
    unit column stride (any, for one column)."""
    rows, cols = t.shape
    return (t.data_ptr() % 16 == 0
            and (rows <= 1 or (t.stride(0) * t.element_size() % 16 == 0
                               and t.stride(0) >= cols))
            and (cols <= 1 or t.stride(1) == 1))


def select_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel's path for a (M, K) @ b (K, N), from the dtype, M, the
    strides and the pointers' alignment alone: ``stream`` at M <=
    STREAM_ROWS (every lane), else ``wgmma`` for bfloat16 operands the
    TMA reads as they lie, ``mma`` for the other bfloat16 and for int8,
    ``fma`` for float32."""
    if a.shape[0] <= STREAM_ROWS:
        return "stream"
    if a.dtype == torch.float32:
        return "fma"
    if a.dtype == torch.bfloat16 and tma_aligned(a) and tma_aligned(b):
        return "wgmma"
    return "mma"


def stream_plan(K: int, N: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The stream path's plan: ``(n_split, split_tiles)``, K cut into
    ``n_split`` splits of ``split_tiles`` whole STREAM_K_TILE-row tiles
    (at most STREAM_MAX_K rows; the last split ends at K), so that the
    grid of N / STREAM_COLS column blocks x n_split holds as many blocks
    as one wave of STREAM_BLOCKS allows (more only where a split would
    pass STREAM_MAX_K rows; one split where N alone fills the wave); none
    is empty.  It reads shapes only, so two calls on the same shapes sum
    in the same order."""
    kt = STREAM_K_TILE[dtype]
    tiles = -(-K // kt)
    if tiles == 0:
        return 1, 1
    want = min(tiles, max(1, STREAM_BLOCKS // -(-N // STREAM_COLS)))
    per = min(-(-tiles // want), STREAM_MAX_K // kt)
    return -(-tiles // per), per


def _reach(t: torch.Tensor) -> int:
    """One past the last element of ``t``'s storage that its rows reach."""
    rows, cols = t.shape
    return (t.storage_offset() + (rows - 1) * t.stride(0)
            + (cols - 1) * t.stride(1) + 1)


def check_launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                 path: str, n_split: int = 1, split_tiles: int = 1,
                 ws: Optional[torch.Tensor] = None) -> None:
    """Hold one launch's arguments against the kernel's bounds before it
    is made; raise ``ValueError`` where one falls outside them.  Checked:
    every element the rows of a, b and out reach lies inside its storage;
    out is contiguous (M, N); the path takes the lane (fma fp32, wgmma
    bf16, mma bf16 and int8, stream all three); the grid: at most 65535
    row tiles of BLOCK_M on mma and of FMA_BLOCK[0] on fma (column tiles
    below 2^31), tiles and extents below 2^31 on
    wgmma with TMA-aligned operands (:func:`tma_aligned`); on stream at
    most STREAM_ROWS rows, 1-65535 splits of ``split_tiles`` >= 1 whole K
    tiles of at most STREAM_MAX_K rows that cover K and leave no split
    empty, and with more than one split a workspace (n_split, M, N) of
    the lane's accumulator type."""
    (M, K), N = a.shape, int(b.shape[1])
    big = 2 ** 31
    for name, t in (("a", a), ("b", b), ("out", out)):
        if t.numel() and _reach(t) > t.untyped_storage().nbytes() \
                // t.element_size():
            raise ValueError(f"{name}'s rows reach past its storage")
    if not out.is_contiguous() or tuple(out.shape) != (M, N):
        raise ValueError(f"out must be a contiguous ({M}, {N})")
    lanes = {"fma": (torch.float32,), "wgmma": (torch.bfloat16,),
             "mma": (torch.bfloat16, torch.int8),
             "stream": (torch.float32, torch.bfloat16, torch.int8)}
    if a.dtype not in lanes[path]:
        raise ValueError(f"the {path} path does not take {a.dtype}")
    if path in ("mma", "fma"):
        bm, bn = FMA_BLOCK if path == "fma" else (BLOCK_M, BLOCK_N)
        if -(-M // bm) > 65535 or -(-N // bn) >= big:
            raise ValueError(f"({M}, {N}) exceeds the {path} path's grid")
    elif path == "wgmma":
        tiles = -(-M // WGMMA_BLOCK[0]) * -(-N // WGMMA_BLOCK[1])
        if not (tma_aligned(a) and tma_aligned(b)) or max(M, N, K) >= big \
                or tiles >= big:
            raise ValueError("the wgmma path needs TMA-aligned operands "
                             "and extents below 2^31")
    else:
        span = split_tiles * STREAM_K_TILE[a.dtype]
        acc = torch.int32 if a.dtype == torch.int8 else torch.float32
        if (M > STREAM_ROWS or not 1 <= n_split <= 65535 or split_tiles < 1
                or span > STREAM_MAX_K or n_split * span < K
                or (n_split - 1) * span >= K
                or -(-N // STREAM_COLS) >= big):
            raise ValueError(f"the stream path's plan ({n_split} x "
                             f"{split_tiles} tiles) does not fit M = {M}, "
                             f"K = {K}")
        if n_split > 1 and (ws is None or tuple(ws.shape) != (n_split, M, N)
                            or ws.dtype != acc or not ws.is_contiguous()):
            raise ValueError(f"the stream path's {n_split} splits need a "
                             f"contiguous ({n_split}, {M}, {N}) {acc} "
                             "workspace")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its ctypes
    signatures declared; returns it."""
    lib = _build.load(_LIB_NAME, _SOURCES)
    if lib not in _BOUND:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.trim_matmul.argtypes = [p, p, p, i, i, i, ll, ll, ll, ll, ll,
                                    p, i, i, p]
        lib.trim_matmul.restype = i
        lib.trim_matmul_error_string.argtypes = [i]
        lib.trim_matmul_error_string.restype = ctypes.c_char_p
        consts = ("block_m", "block_n", "fma_block_m", "fma_block_n",
                  "wgmma_block_m", "wgmma_block_n", "stream_rows",
                  "stream_cols", "stream_max_k")
        for fn in consts:
            getattr(lib, f"trim_matmul_{fn}").restype = i
        lib.trim_matmul_stream_k_tile.argtypes = [i]
        lib.trim_matmul_stream_k_tile.restype = i
        got = [getattr(lib, f"trim_matmul_{fn}")() for fn in consts] + [
            lib.trim_matmul_stream_k_tile(_LANES[dt][0])
            for dt in STREAM_K_TILE]
        if got != [BLOCK_M, BLOCK_N, *FMA_BLOCK, *WGMMA_BLOCK, STREAM_ROWS,
                   STREAM_COLS, STREAM_MAX_K, *STREAM_K_TILE.values()]:
            raise RuntimeError("trim_matmul library constants differ from "
                               "the wrapper's")
        _BOUND.add(lib)
    return lib


def trim_matmul(a: torch.Tensor, b: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N): float32/bfloat16 in ``out_dtype``
    (default ``a.dtype``; fp32 accumulation), int8 in int32.

    ``a`` and ``b`` may be views with any non-negative row stride; their
    column stride must be 1.  A CPU ``a`` runs :func:`trim_matmul_plain`;
    a CUDA ``a`` launches the kernel on the current stream on the path
    :func:`select_path` names, or raises.  The kernel has no backward: an
    operand that needs a gradient under grad mode raises on either device.
    """
    if a.device.type == "cpu":
        refuse_grad("trim_matmul", a, b)
        return trim_matmul_plain(a, b, out_dtype)
    _out_dtype(a, b, out_dtype)  # the shapes select_path reads
    return _launch(a, b, out_dtype, select_path(a, b))


def _launch(a: torch.Tensor, b: torch.Tensor,
            out_dtype: Optional[torch.dtype], path: str) -> torch.Tensor:
    """:func:`trim_matmul` on CUDA operands, on the named ``path``: the
    library refuses a path that cannot take the operands and this raises,
    never swapping in another path."""
    global LAUNCHES
    refuse_grad("trim_matmul", a, b)
    if path not in _PATH_CODES:
        raise ValueError(f"path must be one of {PATHS}, not {path!r}")
    if a.device.type != "cuda":
        raise ValueError(f"trim_matmul runs on cuda or cpu, not {a.device}")
    out_dt = _out_dtype(a, b, out_dtype)
    (M, K), N = a.shape, int(b.shape[1])
    if b.device != a.device:
        raise ValueError(f"b must be on {a.device}, not {b.device}")
    for name, t in (("a", a), ("b", b)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}'s column stride is {t.stride(1)}: the "
                             "kernel reads rows contiguously")
        if t.stride(0) < 0:
            raise ValueError(f"{name}'s negative row stride is not handled")
    n_split, split_tiles, ws = 1, 1, None
    if path == "stream":
        n_split, split_tiles = stream_plan(K, N, a.dtype)
        if n_split > 65535:
            raise ValueError(f"K = {K} exceeds the stream path's grid")
    elif path in ("mma", "fma") and -(-M // (
            FMA_BLOCK[0] if path == "fma" else BLOCK_M)) > 65535:
        raise ValueError(f"M = {M} exceeds the launch grid")
    out = torch.empty((M, N), dtype=out_dt, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    if n_split > 1:
        ws = torch.empty((n_split, M, N), device=a.device, dtype=(
            torch.int32 if a.dtype == torch.int8 else torch.float32))
    check_launch(a, b, out, path, n_split, split_tiles, ws)
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.trim_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             _LANES[a.dtype][0], _OUT_CODES[out_dt],
                             _PATH_CODES[path], M, N, K, a.stride(0),
                             b.stride(0), None if ws is None else
                             ws.data_ptr(), n_split, split_tiles, stream)
    if rc != 0:
        msg = lib.trim_matmul_error_string(rc).decode()
        raise RuntimeError(f"trim_matmul launch failed on the {path} path: "
                           f"CUDA error {rc} ({msg})")
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    return out
