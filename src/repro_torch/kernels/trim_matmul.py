"""TrIM matmul on Hopper: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/trim_matmul.py`` (``_matmul_kernel`` at line 27,
driven by ``trim_matmul_pallas`` at line 42): the K = 1 case of TrIM, a
blocked (M, K) @ (K, N) with the K axis's partial sums kept on chip.  The
kernel itself is ``repro_torch/csrc/trim_matmul.cu``; its header says what
it keeps out of device memory and what bounds it.

- :func:`trim_matmul` is the wrapper: a CUDA tensor launches the kernel
  (or the wrapper raises), a CPU tensor takes :func:`trim_matmul_plain`.
  Every launch adds one to :data:`LAUNCHES`.
- :func:`trim_matmul_plain` is the same function in plain PyTorch
  (``ref.matmul_ref``): float inputs multiplied in fp32 and rounded once
  to the output type, int8 inputs exactly, to int32.

Lanes: float32 (CUDA cores, IEEE, no TF32) and bfloat16 (tensor cores,
fp32 accumulation) give ``out_dtype`` (float32 or bfloat16, default
``a.dtype``); int8 gives int32.  The int32 sum cannot wrap: K is at most
:data:`MAX_K_INT8`, so |sum| <= 128 * 128 * K < 2**31.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

#: Launches of the CUDA kernel since the last reset (a plain counter:
#: callers set it to 0 before a run and read it after).
LAUNCHES = 0

#: One block's output tile (rows, columns); the grid's rows are at most
#: 65535 tiles.
BLOCK_M = 128
BLOCK_N = 128
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


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its ctypes
    signatures declared; returns it."""
    lib = _build.load(_LIB_NAME, _SOURCES)
    if lib not in _BOUND:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.trim_matmul.argtypes = [p, p, p, i, i, ll, ll, ll, ll, ll, p]
        lib.trim_matmul.restype = i
        lib.trim_matmul_error_string.argtypes = [i]
        lib.trim_matmul_error_string.restype = ctypes.c_char_p
        for fn in ("trim_matmul_block_m", "trim_matmul_block_n"):
            getattr(lib, fn).restype = i
        if (lib.trim_matmul_block_m(), lib.trim_matmul_block_n()) != (
                BLOCK_M, BLOCK_N):
            raise RuntimeError("trim_matmul library constants differ from "
                               "the wrapper's")
        _BOUND.add(lib)
    return lib


def trim_matmul(a: torch.Tensor, b: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N): float32/bfloat16 in ``out_dtype``
    (default ``a.dtype``; fp32 accumulation), int8 in int32.

    ``a`` and ``b`` may be views with any row stride; their column stride
    must be 1.  A CPU ``a`` runs :func:`trim_matmul_plain`; a CUDA ``a``
    launches the kernel on the current stream, or raises.
    """
    global LAUNCHES
    if a.device.type == "cpu":
        return trim_matmul_plain(a, b, out_dtype)
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
    if -(-M // BLOCK_M) > 65535:
        raise ValueError(f"M = {M} exceeds the launch grid")
    out = torch.empty((M, N), dtype=out_dt, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.trim_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             _LANES[a.dtype][0], _OUT_CODES[out_dt], M, N, K,
                             a.stride(0), b.stride(0), stream)
    if rc != 0:
        msg = lib.trim_matmul_error_string(rc).decode()
        raise RuntimeError(f"trim_matmul launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES += 1
    return out
