"""TrIM-SSD on Hopper: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/trim_ssd.py`` (``_ssd_kernel`` at line 39, driven
by ``trim_ssd_pallas`` at line 82): the Mamba2 chunked SSD scan, forward
only, returning y and no final state.  The kernel itself is
``repro_torch/csrc/trim_ssd.cu``; its header says what bounds each of its
stages and why its fp32 lane runs 3xTF32.

- :func:`trim_ssd` is the wrapper: a CUDA tensor launches the kernel (or
  the wrapper raises), a CPU tensor takes :func:`trim_ssd_plain`.  Every
  call that launches adds one to :data:`LAUNCHES`.
- :func:`trim_ssd_plain` is the same function in plain PyTorch
  (``ref.ssd_ref``, the port's ``nn.mamba.ssd_chunked`` with per-head
  B/C, in fp32), cast to x's dtype.

The kernel is Mamba2's SSD decomposition in chunks of
:data:`KERNEL_CHUNK` rows, four launches on the current stream counted as
one call: C.B^T of each chunk's lower triangle once per (batch, chunk,
group), each chunk's own end state per (batch, chunk, head, P tile, S
tile), the states passed in chunk order, and each chunk's y per (batch,
chunk, head, P tile).  It takes any head dim P and state dim S, as the
Pallas kernel does: P in tiles of :data:`TILE_P`, S in tiles of
:data:`TILE_S` (C.B^T and C.h^T sum over S tile by tile in a fixed
order, so two calls give the same bits).  :func:`plan` says what a call
launches and allocates; :func:`check_launch` refuses, before the launch,
only a call the launch grid cannot hold.  The wrapper allocates the
scratch with ``torch.empty``: the states (B, NC, H, P', S') fp32, P and S
rounded up to whole tiles (NC chunks; 100 MB at mamba2-130m's 4 x 4096
prefill, 1.07 GB at jamba-1.5-large's), the packed C.B^T (B, NC, groups,
:data:`CB_FLOATS`) fp32 and the chunks' decays (B, H, NC).

B/C are per head, (B, L, H, S), as ``trim_ssd_pallas`` takes them; a
stride-0 ``expand`` over H of one group's (B, L, 1, S) is read in place,
and its C.B^T computed once for every head.  Several groups repeated over
the heads (jamba's 8 over 128) are per head here: C.B^T once per head.
Chunking is math-neutral: ``chunk`` is the plain version's, and the kernel
computes the same y in chunks of its own, up to rounding.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._autograd import refuse_grad

#: Launches of the CUDA kernel since the last reset (a plain counter:
#: callers set it to 0 before a run and read it after).
LAUNCHES = 0

#: The kernel's tiles of the head dim and of the state dim, its own chunk,
#: the floats of one chunk's packed C.B^T (its 16-row tiles on and below
#: the diagonal) and the pass stage's blocks per (batch, head) and tile.
TILE_P = 64
TILE_S = 128
KERNEL_CHUNK = 128
CB_FLOATS = 128 * (KERNEL_CHUNK // 16) * (KERNEL_CHUNK // 16 + 1)
PASS_BLOCKS_PER_TILE = TILE_P * TILE_S // 4 // 256

#: CUDA's grid limits: blocks along x, and along y or z.
_GRID_X = 2 ** 31 - 1
_GRID_YZ = 65535

_LIB_NAME = "trim_ssd"
_SOURCES = ("trim_ssd.cu",)
_BOUND: set = set()
_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, dt, A, Bm, Cm, D, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, L, H, P), got {tuple(x.shape)}")
    Bb, L, H, _ = x.shape
    if tuple(dt.shape) != (Bb, L, H) or tuple(A.shape) != (H,) \
            or tuple(D.shape) != (H,):
        raise ValueError(f"dt must be (B, L, H) and A, D (H,): x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)}")
    if Bm.dim() != 4 or tuple(Bm.shape[:3]) != (Bb, L, H) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be (B, L, H, S) (per head; expand "
                         f"one group over H): {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm and Cm must share float32 or bfloat16, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not all(t.is_floating_point() for t in (dt, A, D)):
        raise ValueError("dt, A and D must be floating point")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def trim_ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                   chunk: int = 256) -> torch.Tensor:
    """The kernel's function in plain PyTorch -> y (B, L, H, P) in x's
    dtype."""
    _check(x, dt, A, Bm, Cm, D, chunk)
    return ref.ssd_ref(x, dt, A, Bm, Cm, D, chunk=chunk).to(x.dtype)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its ctypes
    signatures declared; returns it."""
    lib = _build.load(_LIB_NAME, _SOURCES)
    if lib not in _BOUND:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.trim_ssd.argtypes = [p] * 10 + [i, ll, ll, ll] + [i] * 5 \
            + [ll] * 12 + [p]
        lib.trim_ssd.restype = i
        lib.trim_ssd_error_string.argtypes = [i]
        lib.trim_ssd_error_string.restype = ctypes.c_char_p
        consts = ("trim_ssd_tile_p", "trim_ssd_tile_s", "trim_ssd_chunk",
                  "trim_ssd_cb_floats", "trim_ssd_pass_blocks_per_tile")
        for fn in consts:
            getattr(lib, fn).restype = i
        if tuple(getattr(lib, fn)() for fn in consts) != (
                TILE_P, TILE_S, KERNEL_CHUNK, CB_FLOATS,
                PASS_BLOCKS_PER_TILE):
            raise RuntimeError("trim_ssd library constants differ from the "
                               "wrapper's")
        _BOUND.add(lib)
    return lib


class SsdPlan(NamedTuple):
    """What one call launches and allocates, from the shapes alone."""
    chunks: int                 # NC, chunks of KERNEL_CHUNK rows
    p_tiles: int                # tiles of TILE_P head-dim columns
    s_tiles: int                # tiles of TILE_S state columns
    groups: int                 # C.B^T per (batch, chunk): 1 or H
    states: Tuple[int, ...]     # (B, NC, H, P', S'), fp32
    cb: Tuple[int, ...]         # (B, NC, groups, CB_FLOATS), fp32
    grids: Tuple[Tuple[int, int, int], ...]  # cb, state, pass, out


def plan(B: int, L: int, H: int, P: int, S: int,
         shared: bool = False) -> SsdPlan:
    """The kernel's launch plan for x (B, L, H, P) and B/C (B, L, H, S):
    ``shared`` when B/C are one group expanded over the heads (C.B^T once
    for all of them).  The grids are (x, y, z) of the cb, state, pass and
    out stages."""
    nc = -(-L // KERNEL_CHUNK)
    npt, nst = -(-P // TILE_P), -(-S // TILE_S)
    ng = 1 if shared or H == 1 else H
    return SsdPlan(
        chunks=nc, p_tiles=npt, s_tiles=nst, groups=ng,
        states=(B, nc, H, npt * TILE_P, nst * TILE_S),
        cb=(B, nc, ng, CB_FLOATS),
        grids=((ng, nc, B), (H * npt * nst, nc, B),
               (PASS_BLOCKS_PER_TILE * npt * nst, H, B), (H * npt, nc, B)))


def check_launch(p: SsdPlan) -> None:
    """Hold one call's plan against the launch grid before anything is
    allocated; raise ``ValueError`` where the grid cannot hold the call (at
    most 2^31 - 1 blocks along x and 65535 along y and z, a state row S'
    below 2^30 floats)."""
    for name, grid in zip(("cb", "state", "pass", "out"), p.grids):
        if grid[0] > _GRID_X or max(grid[1:]) > _GRID_YZ:
            raise ValueError(f"the launch grid cannot hold this call: the "
                             f"{name} stage needs {grid} blocks (at most "
                             f"{_GRID_X} along x, {_GRID_YZ} along y and z)")
    if p.states[4] >= 2 ** 30:
        raise ValueError(f"the launch grid cannot hold this call: a state "
                         f"row of {p.states[4]} floats (below 2^30)")


def _rows_whole(t: torch.Tensor) -> bool:
    """Whether every (b, l, h) row of ``t`` starts on 16 bytes and its last
    axis is whole 16 bytes (the kernel then copies it with cp.async)."""
    esz = t.element_size()
    return t.data_ptr() % 16 == 0 and t.shape[3] * esz % 16 == 0 and all(
        st * esz % 16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
        if n > 1)


def trim_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """Chunked SSD scan. x (B, L, H, P); dt (B, L, H) (post-softplus);
    A (H,) (negative); Bm/Cm (B, L, H, S); D (H,) -> y (B, L, H, P) in x's
    dtype (fp32 math).

    x, Bm and Cm share float32 or bfloat16; dt, A and D are cast to fp32
    (a copy only where they are not).  x, dt, Bm and Cm may be strided
    views, Bm/Cm with a stride of 0 over H; the last axis of x, Bm and Cm
    must have stride 1.  A CPU ``x`` runs :func:`trim_ssd_plain`; a CUDA
    ``x`` launches the kernel on the current stream, or raises.  The
    kernel has no backward: an input that needs a gradient under grad
    mode raises on either device.
    """
    global LAUNCHES
    refuse_grad("trim_ssd", x, dt, A, Bm, Cm, D)
    if x.device.type == "cpu":
        return trim_ssd_plain(x, dt, A, Bm, Cm, D, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"trim_ssd runs on cuda or cpu, not {x.device}")
    _check(x, dt, A, Bm, Cm, D, chunk)
    Bb, L, H, P = x.shape
    S = int(Bm.shape[3])
    if any(t.device != x.device for t in (dt, A, Bm, Cm, D)):
        raise ValueError(f"every input must be on {x.device}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}'s last stride is {t.stride(3)}: the "
                             "kernel reads it contiguously")
    if min(min(t.stride()) for t in (x, dt, Bm, Cm)) < 0:
        raise ValueError("negative strides are not handled")
    # one group expanded over the heads: C.B^T once for all of them
    p = plan(Bb, L, H, P, S,
             shared=Bm.stride(2) == 0 and Cm.stride(2) == 0)
    check_launch(p)
    dt = dt.float()
    A = A.float().contiguous()
    D = D.float().contiguous()
    y = torch.empty((Bb, L, H, P), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    f32 = dict(dtype=torch.float32, device=x.device)
    states = torch.empty(p.states, **f32)
    cb = torch.empty(p.cb, **f32)
    decay = torch.empty((Bb, H, p.chunks), **f32)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.trim_ssd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), states.data_ptr(),
            cb.data_ptr(), decay.data_ptr(),
            int(x.dtype == torch.bfloat16), Bb, L, H, P, S, p.groups,
            int(_rows_whole(x)), int(_rows_whole(Bm) and _rows_whole(Cm)),
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
            *Cm.stride()[:3], stream)
    if rc != 0:
        msg = lib.trim_ssd_error_string(rc).decode()
        raise RuntimeError(f"trim_ssd launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES += 1
    return y
