"""Flash attention on Hopper: the CUDA kernel's wrapper, its plain version
and the full-softmax oracle.

Port of ``repro/kernels/flash_attention.py`` (``_flash_kernel`` at line 38,
driven by ``flash_attention_pallas`` at line 91), on the model's own
layout: the kernel computes what ``repro/nn/attention.py:75
flash_attention`` computes.  The kernel itself is
``repro_torch/csrc/flash_attention.cu``; its header says what it keeps out
of device memory and what bounds it.

- :func:`flash_attention` is the wrapper: a CUDA tensor launches the
  kernel (or the wrapper raises), a CPU tensor takes
  :func:`flash_attention_plain`.  Every launch adds one to
  :data:`LAUNCHES`.  Where autograd records the call (q, k or v needs a
  gradient, under grad mode), it runs through :class:`FlashAttentionFn`:
  the same forward, and the plain version's VJP as the backward.
- :func:`flash_attention_plain` is ``nn/attention.py:flash_attention``
  line for line: a streaming softmax over ``chunk_k`` keys at a time, with
  the same ``NEG_INF`` masking, the zeroed masked ``p``, the division by
  ``max(l, 1e-20)``, ``q_offset``, a per-row ``kv_length`` and the
  ``block_causal`` sweep.
- :func:`flash_attention_ref` is the full-softmax oracle of the Pallas
  module (``flash_attention.py:135``) on its (B, H, S, D) layout; its
  causal mask is aligned to the end (``k <= q + Sk - Sq``).

- :func:`decode_splits` is the plan for a call of at most
  :data:`SPLIT_ROWS` flattened rows (decode), in either dtype: the keys
  cut into splits of whole :data:`SPLIT_TILE`-key tiles, from B, H, the
  rows, Sk and the lane's grid target (:func:`split_blocks`) alone (never
  ``kv_length``, which lies on the device).
  :func:`flash_attention_split_plain` runs that plan in plain PyTorch:
  :func:`split_partials` per split, then :func:`merge_partials`, the
  log-sum-exp merge of ``repro/nn/decode_attn.py:128-132``.

Layout: q (B, Sq, H, G, D) with H the KV heads and G the q heads that
share each; k, v (B, Sk, H, D); the output is (B, Sq, H, G, D) in q's
dtype.  Key ``c`` is visible to query row ``r`` iff ``c < kv_length[b]``
and, when causal, ``c <= q_offset + r``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._autograd import needs_grad, plain_vjp

NEG_INF = -1e30

#: Launches of the CUDA kernel since the last reset (a plain counter:
#: callers set it to 0 before a run and read it after).
LAUNCHES = 0
#: Launches of the partial entry (:func:`flash_attention_partial`), counted
#: apart from :data:`LAUNCHES`.
PARTIAL_LAUNCHES = 0

#: Head dims the kernel is compiled for (the Pallas kernel blocks only the
#: sequence and takes any; these are the LM configs' and their smoke
#: configs'); the geometry of each lane's blocks: :func:`prefill_tile`
#: (bf16), :func:`f32_tile` (fp32).
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: The bf16 prefill's keys a K/V tile at D = 256 (``kD256Keys`` of the
#: library), the shared memory a block can have on an H100, an SM's (its
#: blocks share it, each taking SM_BLOCK_RESERVED bytes besides its
#: dynamic shared memory: 1 KB CUDA reserves, 16 the split kernels'
#: static flag), the SMs, and the registers of each of an SM's four
#: sub-partitions (a block's warps are spread over them) and of a thread
#: at most.
D256_KEYS = 80
SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
SM_BLOCK_RESERVED = 1024 + 16
SMS = 132
SMSP_REGISTERS = 16384
MAX_THREAD_REGISTERS = 255


class PrefillTile(NamedTuple):
    """The bf16 prefill's block at one head dim (``PfWgTile<D>`` or
    ``PfTile<D>`` of ``csrc/flash_attention.cu``)."""
    rows: int        # flattened rows a block: 64 a consumer warpgroup
    keys: int        # keys a K/V tile
    stages: int      # (K, V) tile pairs in the TMA ring
    warpgroups: int  # consumer warpgroups
    smem_bytes: int  # dynamic shared memory a block
    threads: int     # 128 a warpgroup, with the producer's at D <= 64
    regs: int        # registers ptxas may give each thread


@lru_cache(maxsize=None)
def prefill_tile(D: int) -> PrefillTile:
    """The bf16 prefill's geometry at head dim ``D`` (one of
    :data:`HEAD_DIMS`).  At D <= 64 (``flash_prefill_wg_kernel``, the head
    dim padded to 64): three consumer warpgroups (192 rows) and a producer
    warpgroup, 128-key tiles in a ring of 3 stages, two mbarriers a stage.
    At D = 128 and 256 (``flash_prefill_kernel``, thread 0 and the last
    reader of a stage load the tiles): two warpgroups, 128-key tiles
    (:data:`D256_KEYS` at D = 256) in a ring of 2 stages, two mbarriers and
    two arrival counts a stage.  Shared memory: each consumer warpgroup's
    Q (64 rows), the ring of K and V tiles, the barriers and counts, and
    1024 bytes of alignment.  Registers: a sub-partition's
    :data:`SMSP_REGISTERS` over the block's warps it holds (a quarter), in
    units of 8, at most :data:`MAX_THREAD_REGISTERS`.  The library's values
    are held to these when it is loaded."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel takes {HEAD_DIMS}")
    wg = D <= 64
    dp = max(D, 64)
    wgs = 3 if wg else 2
    keys = D256_KEYS if D == 256 else 128
    stages = 3 if wg else 2
    threads = 128 * (wgs + wg)
    ring = wgs * dp * 128 + stages * 2 * (dp // 64) * keys * 128
    bars = 2 * stages * (8 if wg else 8 + 4)
    return PrefillTile(rows=64 * wgs, keys=keys, stages=stages,
                       warpgroups=wgs, smem_bytes=ring + bars + 1024,
                       threads=threads,
                       regs=min(MAX_THREAD_REGISTERS,
                                SMSP_REGISTERS // (threads // 4) // 8 * 8))


#: Either lane splits the keys of a call of at most SPLIT_ROWS rows
#: (decode) into splits of whole SPLIT_TILE-key tiles over blocks of
#: SPLIT_WARPS warps, enough for the lane's grid target
#: (:func:`split_blocks`): SPLIT_BLOCKS in bf16 (two per SM of an H100's
#: 132).
SPLIT_ROWS = 16
SPLIT_TILE = 64
SPLIT_WARPS = 4
SPLIT_BLOCKS = 2 * SMS


class F32Tile(NamedTuple):
    """The fp32 lane's blocks at one head dim (``F32Tile<D>`` and
    ``F32Split<D>`` of ``csrc/flash_attention.cu``)."""
    rows: int              # prefill: flattened rows a block, 16 a warp
    keys: int              # prefill: keys a K/V tile
    stages: int            # prefill: (K, V) tiles in the cp.async ring
    threads: int           # prefill: threads a block
    smem_bytes: int        # prefill: dynamic shared memory a block
    split_keys: int        # split decode: keys a warp's sub-tile
    split_smem_bytes: int  # split decode: dynamic shared memory a block
    split_per_sm: int      # split decode: blocks an SM holds at once


@lru_cache(maxsize=None)
def f32_tile(D: int) -> F32Tile:
    """The fp32 lane's geometry at head dim ``D`` (one of
    :data:`HEAD_DIMS`), on the head dim padded to 32 columns (dp).  The
    prefill: 8 warps of 16 rows, keys a tile 64 at D <= 64, 32 at 128 and
    16 at 256, a 2-stage ring; shared memory (floats) Q and each stage's K
    in rows of dp + 4, each stage's V in rows of dp, P in rows of keys + 8.
    The split decode: a warp's sub-tile is 32 segments of 32 floats (32 /
    (dp / 32) keys); shared memory q (16 rows of dp), each of 4 warps' P
    (16 x keys) and ring of 2 stages (K: 32 segments; V: keys x dp), or
    the warps' (m, l, acc) rows after the loop, whichever is larger; as
    many blocks an SM as its shared memory holds.  The library's values
    are held to these when it is loaded."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel takes {HEAD_DIMS}")
    dp = max(D, 32)
    rows, stages = 128, 2
    keys = 64 if D <= 64 else 32 if D == 128 else 16
    prefill = rows * (dp + 4) + stages * keys * (2 * dp + 4) \
        + rows * (keys + 8)
    sub = 32 // (dp // 32)
    ring = SPLIT_WARPS * 2 * (32 * 32 + sub * dp)
    split = 4 * max(SPLIT_ROWS * dp + SPLIT_WARPS * SPLIT_ROWS * sub + ring,
                    SPLIT_WARPS * SPLIT_ROWS * (dp + 2))
    return F32Tile(rows=rows, keys=keys, stages=stages, threads=256,
                   smem_bytes=4 * prefill, split_keys=sub,
                   split_smem_bytes=split,
                   split_per_sm=SM_SMEM_BYTES // (split + SM_BLOCK_RESERVED))


_LIB_NAME = "flash_attention"
_SOURCES = ("flash_attention.cu",)
_BOUND: set = set()
#: (device index, stream) -> the split path's int32 arrival counters, one
#: per (b, h); zeroed once, and left at zero by every launch's merging
#: block.  One buffer per stream: two calls in flight on two streams
#: never share a counter.
_COUNTERS: dict = {}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_length: Optional[torch.Tensor]) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, G, D) and k, v (B, Sk, H, D): "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, _, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, heads or head dim")
    if kv_length is not None and tuple(kv_length.shape) != (B,):
        raise ValueError(f"kv_length must be (B,) = ({B},), got "
                         f"{tuple(kv_length.shape)}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool,
                          q_offset: int = 0,
                          kv_length: Optional[torch.Tensor] = None,
                          chunk_k: int = 1024, block_causal: bool = False,
                          ) -> torch.Tensor:
    """Streaming-softmax attention in plain PyTorch (fp32 statistics and
    accumulator, one cast to q's dtype).  q (B, Sq, H, G, D); k/v
    (B, Sk, H, D); ``kv_length`` (B,) int.  Returns (B, Sq, H, G, D)."""
    _check(q, k, v, kv_length)
    B, Sq, H, G, D = q.shape
    Sk = k.shape[1]
    scale = D ** -0.5
    ck = min(chunk_k, Sk)
    nk = -(-Sk // ck)
    pad_k = nk * ck - Sk
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))

    if block_causal and causal and Sq > 1:
        # q-block sweep: block i only scans kv chunks [0, hi_i], skipping
        # the fully masked upper triangle
        outs = []
        for lo in range(0, Sq, ck):
            hi = min(lo + ck, Sq)
            hi_chunk = min(nk, (q_offset + hi + ck - 1) // ck)
            outs.append(flash_attention_plain(
                q[:, lo:hi], k[:, :hi_chunk * ck], v[:, :hi_chunk * ck],
                causal=True, q_offset=q_offset + lo, kv_length=kv_length,
                chunk_k=ck, block_causal=False))
        return torch.cat(outs, dim=1)

    dev = q.device
    qT = q.permute(0, 2, 3, 1, 4).float()                     # (B,H,G,Sq,D)
    kc = k.reshape(B, nk, ck, H, D).permute(1, 0, 3, 2, 4)    # (nk,B,H,ck,D)
    vc = v.reshape(B, nk, ck, H, D).permute(1, 0, 3, 2, 4)
    rows = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, H, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, G, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, G, Sq, D), dtype=torch.float32, device=dev)
    for idx in range(nk):
        s = torch.einsum("bhgqd,bhcd->bhgqc", qT, kc[idx].float()) * scale
        cols = idx * ck + torch.arange(ck, device=dev)
        mask = torch.ones((Sq, ck), dtype=torch.bool, device=dev)
        if causal:
            mask &= cols[None, :] <= rows[:, None]
        mask &= (cols < Sk)[None, :]
        if kv_length is not None:
            mask = mask[None] & (cols[None, None, :]
                                 < kv_length.to(dev)[:, None, None])
            mask = mask[:, None, None]                        # (B,1,1,Sq,ck)
        else:
            mask = mask[None, None, None]                     # (1,1,1,Sq,ck)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhgqc,bhcd->bhgqd", p,
                                                vc[idx].float())
        m = m_new
    out = o / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)             # (B,Sq,H,G,D)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        kv_length: Optional[int] = None) -> torch.Tensor:
    """Full-softmax oracle in fp32 on the Pallas layout: q (B, H, Sq, D),
    k/v (B, H, Sk, D) -> (B, H, Sq, D); a scalar ``kv_length``."""
    _, _, Sq, D = q.shape
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * D ** -0.5
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= (torch.arange(Sq, device=q.device)[:, None]
                                   + (Sk - Sq))
    if kv_length is not None:
        mask &= (k_pos < kv_length)[None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def split_blocks(D: int, bf16: bool, rows: int) -> Tuple[int, bool]:
    """The split decode's grid target at head dim ``D`` and ``rows``
    flattened rows, and whether the grid is to fit it
    (:func:`decode_splits`'s ``blocks`` and ``fit``): in bf16
    SPLIT_BLOCKS, at least; in fp32 what the SMs hold at once at the
    lane's shared memory a block (:func:`f32_tile`; 2 a block above 8
    rows, whose accumulators take the registers of a third), at most, so
    that every block of the grid runs in one wave."""
    if bf16:
        return SPLIT_BLOCKS, False
    per_sm = f32_tile(D).split_per_sm
    return SMS * (min(per_sm, 2) if rows > 8 else per_sm), True


def decode_splits(B: int, H: int, rows: int, Sk: int,
                  blocks: int = SPLIT_BLOCKS,
                  fit: bool = False) -> Tuple[int, int]:
    """The split path's plan: ``(n_split, split_tiles)``, the keys [0, Sk)
    cut into ``n_split`` splits of ``split_tiles`` whole SPLIT_TILE-key
    tiles (the last split ends at Sk); none is empty.  The grid of B x H x
    row tiles x n_split blocks holds at least ``blocks`` or, with ``fit``,
    at most ``blocks`` (at least one split); or one tile a split where
    there are fewer tiles.  The lane's ``blocks`` and ``fit`` are
    :func:`split_blocks`'.  It reads shapes only: ``kv_length`` lies on
    the device, and reading it would wait for the device once per layer
    and step."""
    n_tiles = -(-Sk // SPLIT_TILE)
    if n_tiles == 0:
        return 1, 1
    grid = B * H * max(1, -(-rows // SPLIT_ROWS))
    if fit:
        per = -(-n_tiles // min(n_tiles, max(1, blocks // grid)))
    else:
        per = n_tiles // min(n_tiles, max(1, -(-blocks // grid)))
    return -(-n_tiles // per), per


def split_ranges(B: int, H: int, rows: int, Sk: int,
                 blocks: int = SPLIT_BLOCKS,
                 fit: bool = False) -> List[Tuple[int, int]]:
    """:func:`decode_splits` as key ranges ``[lo, hi)``, in split order."""
    n_split, per = decode_splits(B, H, rows, Sk, blocks, fit)
    span = per * SPLIT_TILE
    return [(i * span, min((i + 1) * span, Sk)) for i in range(n_split)]


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lo: int, hi: int, *, causal: bool, q_offset: int = 0,
                   kv_length: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One split's partial softmax over keys [lo, hi), in fp32: the
    unnormalised output (B, Sq, H, G, D), the row max m and the row sum l
    (B, Sq, H, G), as ``repro/nn/decode_attn.py:_local_flash_decode``
    computes them (masked scores at NEG_INF, masked p at 0).  A split
    with no visible key gives m = NEG_INF, l = 0 and a zero output."""
    _check(q, k, v, kv_length)
    B, Sq, H, G, D = q.shape
    dev = q.device
    kc, vc = k[:, lo:hi].float(), v[:, lo:hi].float()
    cols = lo + torch.arange(kc.shape[1], device=dev)
    if cols.numel() == 0:
        return (torch.zeros(q.shape, dtype=torch.float32, device=dev),
                torch.full((B, Sq, H, G), NEG_INF, device=dev),
                torch.zeros((B, Sq, H, G), device=dev))
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.float(), kc) * D ** -0.5
    mask = torch.ones((B, Sq, cols.numel()), dtype=torch.bool, device=dev)
    if causal:
        rows = q_offset + torch.arange(Sq, device=dev)
        mask &= (cols[None, :] <= rows[:, None])[None]
    if kv_length is not None:
        mask &= (cols[None, :] < kv_length.to(dev)[:, None])[:, None]
    mask = mask[:, :, None, None]                          # (B,Sq,1,1,ck)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    return torch.einsum("bqhgk,bkhd->bqhgd", p, vc), m, p.sum(dim=-1)


def merge_partials(parts: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]]) -> torch.Tensor:
    """The log-sum-exp merge of ``repro/nn/decode_attn.py:128-132`` over
    ``(o, m, l)`` partials, in their order: fp32 (B, Sq, H, G, D)."""
    m_g = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    l_g = torch.zeros_like(m_g)
    o_g = torch.zeros_like(parts[0][0])
    for o, m, l in parts:
        w = torch.exp(m - m_g)
        l_g = l_g + l * w
        o_g = o_g + o * w[..., None]
    return o_g / torch.clamp(l_g, min=1e-20)[..., None]


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool,
                                q_offset: int = 0,
                                kv_length: Optional[torch.Tensor] = None,
                                ) -> torch.Tensor:
    """The split path in plain PyTorch: :func:`split_partials` over each
    range of :func:`split_ranges` (the plan of q's dtype's lane), then
    :func:`merge_partials`; the output in q's dtype."""
    B, Sq, H, G, D = q.shape
    plan = split_blocks(D, q.dtype == torch.bfloat16, Sq * G)
    parts = [split_partials(q, k, v, lo, hi, causal=causal,
                            q_offset=q_offset, kv_length=kv_length)
             for lo, hi in split_ranges(B, H, Sq * G, k.shape[1], *plan)]
    return merge_partials(parts).to(q.dtype)


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split path's arrival counters for ``stream``: at least ``n``
    int32 zeros, allocated once (and again only to grow)."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its ctypes
    signatures declared; returns it."""
    lib = _build.load(_LIB_NAME, _SOURCES)
    if lib not in _BOUND:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention.argtypes = (
            [p, p, p, p, p, i, i, i]          # q k v out kv_length bf16 causal D
            + [ll] * 6                        # B Sq Sk H G q_offset
            + [ll] * 4 + [ll] * 3 + [ll] * 3  # q, k, v strides (b, s, h[, g])
            + [p, p, i, i]                    # scratch counters n_split tiles
            + [ctypes.c_float, p])            # scale, stream
        lib.flash_attention.restype = i
        lib.flash_attention_ml.argtypes = (lib.flash_attention.argtypes
                                           + [p, p])  # m_out l_out
        lib.flash_attention_ml.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        consts = ("flash_attention_split_rows", "flash_attention_split_tile")
        for fn in consts:
            getattr(lib, fn).restype = i
        tiles = {}
        for fn, kind in (("flash_attention_prefill_tile", PrefillTile),
                         ("flash_attention_f32_tile", F32Tile)):
            getattr(lib, fn).argtypes = [i, p]
            getattr(lib, fn).restype = i
            for D in HEAD_DIMS:
                got = (ctypes.c_int * len(kind._fields))()
                if getattr(lib, fn)(D, got) != 0:
                    raise RuntimeError(f"flash_attention library: no "
                                       f"{fn} at D = {D}")
                tiles[kind, D] = kind(*got)
        want = {(kind, D): tile(D) for kind, tile in (
            (PrefillTile, prefill_tile), (F32Tile, f32_tile))
            for D in HEAD_DIMS}
        if tuple(getattr(lib, fn)() for fn in consts) != (
                SPLIT_ROWS, SPLIT_TILE) or tiles != want:
            raise RuntimeError("flash_attention library constants differ "
                               "from the wrapper's")
        _BOUND.add(lib)
    return lib


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd (the dense LM in training).

    Forward: the wrapper's call (the kernel on a CUDA q, counted in
    :data:`LAUNCHES`; the plain version on a CPU one).  Backward: the VJP
    of :func:`flash_attention_plain` with the same options, recomputed
    under autograd from the saved q, k and v.  This is no fallback: the
    Pallas kernel (``repro/kernels/flash_attention.py:38``) is forward
    only, and the JAX package trains attention through its pure-JAX
    ``nn/attention.py:75 flash_attention``, whose gradient this VJP is, so
    there is no backward kernel to port.
    """

    @staticmethod
    def forward(ctx, q, k, v, kv_length, opts):
        ctx.save_for_backward(q, k, v, kv_length)
        ctx.opts = opts
        return _flash(q, k, v, kv_length=kv_length, **opts)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, kv_length = ctx.saved_tensors
        opts = ctx.opts

        def plain(q, k, v):
            return flash_attention_plain(q, k, v, kv_length=kv_length, **opts)

        return (*plain_vjp(plain, (q, k, v), ctx.needs_input_grad[:3], grad),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_length: Optional[torch.Tensor] = None,
                    chunk_k: int = 1024, block_causal: bool = False,
                    ) -> torch.Tensor:
    """Attention of q (B, Sq, H, G, D) over k/v (B, Sk, H, D) -> (B, Sq, H,
    G, D) in q's dtype (fp32 or bf16 in; fp32 softmax and accumulator).

    A CPU ``q`` runs :func:`flash_attention_plain`.  A CUDA ``q`` launches
    the kernel on the current stream, once, or raises: q, k and v in one
    dtype, D in :data:`HEAD_DIMS`, the head dim contiguous, every other
    stride and every base 16-byte aligned (strided views such as a slice
    of a KV cache are read in place; in bf16 no k/v stride is 0 over more
    than one element, since their tiles come in by TMA).  A call of at
    most :data:`SPLIT_ROWS` rows (Sq x G: decode) splits the keys as
    :func:`decode_splits` plans for its lane, its fp32 partials in a
    ``torch.empty`` scratch merged by the launch's last block; others take
    the prefill kernel (bf16: warpgroup MMA; fp32: register-tiled FMAs).
    ``chunk_k`` and ``block_causal`` choose how the plain version walks
    the keys; the kernel walks tiles of its own and always
    skips the tiles that causality or ``kv_length`` mask whole.  A call
    that autograd records goes through :class:`FlashAttentionFn`.
    """
    opts = dict(causal=causal, q_offset=q_offset, chunk_k=chunk_k,
                block_causal=block_causal)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, kv_length, opts)
    return _flash(q, k, v, kv_length=kv_length, **opts)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, q_offset: int = 0,
           kv_length: Optional[torch.Tensor] = None,
           chunk_k: int = 1024, block_causal: bool = False) -> torch.Tensor:
    """The wrapper's forward: the plain version on a CPU ``q``, the
    kernel on a CUDA one."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_length=kv_length,
                                     chunk_k=chunk_k,
                                     block_causal=block_causal)
    out = _launch(q, k, v, causal=causal, q_offset=q_offset,
                  kv_length=kv_length)[0]
    LAUNCHES += 1
    return out


def flash_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_length: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_partial` in plain PyTorch: one
    :func:`split_partials` over every key, the output normalised by its
    row sum and cast to q's dtype, with the fp32 row max and sum."""
    o, m, l = split_partials(q, k, v, 0, k.shape[1], causal=False,
                             kv_length=kv_length)
    return (o / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype), m, l


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            kv_length: Optional[torch.Tensor] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Decode attention over a slice of the keys, with the statistics that
    merge it with other slices: (o (B, Sq, H, G, D) normalised, in q's
    dtype; m, l (B, Sq, H, G) fp32: each row's max score, in natural-log
    units, and its sum of exp(score - m)).  A row with no visible key has
    o = 0, l = 0 and m at -1e30 or below.  Not causal.

    A CPU ``q`` runs :func:`flash_partial_plain`.  A CUDA ``q`` launches
    the kernel once, which writes m and l beside the output, or raises:
    the split decode at most :data:`SPLIT_ROWS` rows (Sq x G), in either
    dtype; in fp32 the prefill kernel above that, with
    :func:`flash_attention`'s other terms.  Counted in
    :data:`PARTIAL_LAUNCHES`."""
    global PARTIAL_LAUNCHES
    if q.device.type == "cpu":
        return flash_partial_plain(q, k, v, kv_length)
    B, Sq, H, G, _ = q.shape
    if q.dtype == torch.bfloat16 and Sq * G > SPLIT_ROWS:
        raise ValueError(f"the partial entry's bf16 lane is the split "
                         f"decode: q {tuple(q.shape)} has more than "
                         f"{SPLIT_ROWS} rows")
    out = _launch(q, k, v, causal=False, q_offset=0, kv_length=kv_length,
                  stats=True)
    PARTIAL_LAUNCHES += 1
    return out


def _grid_x(B: int, Sq: int, H: int, G: int, D: int, bf16: bool) -> int:
    """The launch grid's x extent of a call that is no split decode (the
    grid is x alone): the prefill's blocks, the rows of one (b, h) each,
    :func:`prefill_tile`'s in bf16 and :func:`f32_tile`'s in fp32."""
    rows = prefill_tile(D).rows if bf16 else f32_tile(D).rows
    return -(-Sq * G // rows) * B * H


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, q_offset: int,
            kv_length: Optional[torch.Tensor], stats: bool = False):
    """One launch of the kernel on CUDA tensors: (out,), or (out, m, l)
    with ``stats`` (the split path's merged row statistics)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, kv_length)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"k and v must be on {q.device}")
    B, Sq, H, G, D = q.shape
    Sk = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel takes {HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        strides = t.stride()[:-1]
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(s % vec or s < 0 for s in strides):
            raise ValueError(
                f"{name}'s strides {t.stride()} or base: the kernel needs a "
                f"contiguous head dim and 16-byte aligned rows")
    if kv_length is not None:
        if kv_length.device != q.device:
            raise ValueError(f"kv_length must be on {q.device}")
        kv_length = kv_length.to(torch.int32).contiguous()
    bf16 = q.dtype == torch.bfloat16
    if H > 65535 or B > 65535 \
            or _grid_x(B, Sq, H, G, D, bf16) > 2 ** 31 - 1:
        raise ValueError(f"batch {B} / heads {H} / rows {Sq * G} exceed the "
                         "launch grid")
    if bf16:
        if Sk + prefill_tile(D).keys >= 2 ** 31 \
                or not -2 ** 30 < int(q_offset) < 2 ** 30 - Sq:
            raise ValueError(f"Sk {Sk} / q_offset {q_offset}: the bf16 lane "
                             "indexes keys in 32 bits")
        for name, t in (("k", k), ("v", v)):
            if any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape)):
                raise ValueError(f"{name}'s strides {t.stride()}: the bf16 "
                                 "lane loads k/v tiles by TMA, which needs "
                                 "no zero stride")
    out = torch.empty((B, Sq, H, G, D), dtype=q.dtype, device=q.device)
    ml = [torch.empty((B, Sq, H, G), dtype=torch.float32, device=q.device)
          for _ in range(2 if stats else 0)]
    if out.numel() == 0:
        return (out, *ml)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        n_split, tiles, scratch, counters = 0, 0, None, None
        if Sq * G <= SPLIT_ROWS:
            n_split, tiles = decode_splits(B, H, Sq * G, Sk,
                                           *split_blocks(D, bf16, Sq * G))
            counters = _counters(q.device, stream, B * H).data_ptr()
            if n_split > 1:
                scratch = torch.empty(B * H * n_split * Sq * G * (D + 2),
                                      dtype=torch.float32, device=q.device)
        rc = lib.flash_attention_ml(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_length.data_ptr() if kv_length is not None else None,
            int(bf16), int(causal), D,
            B, Sq, Sk, H, G, int(q_offset),
            *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
            None if scratch is None else scratch.data_ptr(), counters,
            n_split, tiles, D ** -0.5, stream,
            *(t.data_ptr() for t in ml) if stats else (None, None))
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} "
                           f"({msg})")
    return (out, *ml)
