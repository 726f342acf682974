"""The matmul kernel's path choice and stream plan, on the CPU.

``select_path`` picks the CUDA kernel's path from the dtype, M, the
strides and the pointers' alignment alone, so CPU tensors and their views
exercise it: ``stream`` at M <= 16 on every lane, ``wgmma`` for bfloat16
operands the TMA reads as they lie, ``mma`` for the other bfloat16 and
int8, ``fma`` for float32.  ``stream_plan`` cuts K into whole tiles that
cover it exactly.  On a CPU tensor the wrapper still runs its plain
version (no launch is counted), which matches
``trim_matmul_pallas`` in interpret mode.  The library's build key
covers the header it shares with the flash-attention kernel.  The
kernels themselves run in ``tests/test_torch_cuda.py`` (``-m gpu``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.trim_matmul import trim_matmul_pallas
from repro_torch.kernels import _build, ops
from repro_torch.kernels import trim_matmul as mm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}
#: the path of a contiguous (M, K) @ (K, N) past the stream path's rows
WIDE_PATH = {"float32": "fma", "bfloat16": "wgmma", "int8": "mma"}


def _zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64])
def test_select_path_by_dtype_and_rows(dtype, M):
    dt = DTYPES[dtype]
    a, b = _zeros((M, 64), dt), _zeros((64, 32), dt)
    want = "stream" if M <= mm.STREAM_ROWS else WIDE_PATH[dtype]
    assert mm.select_path(a, b) == want


def _views(dt):
    """(name, a, b, TMA-aligned): column slices and storage offsets of
    wider tensors, as a layer's projection views would be."""
    wide_a, wide_b = _zeros((64, 136), dt), _zeros((128, 264), dt)
    flat = _zeros(64 * 128 + 8, dt)
    return [
        ("contiguous", wide_a[:, :128].contiguous(),
         wide_b[:, :256].contiguous(), True),
        # 8 bf16 = 16 bytes in: every row start stays 16-byte aligned
        ("slice+8", wide_a[:, 8:136], wide_b[:, 8:264], True),
        # 3 elements (6 bytes) in: the row starts are not
        ("slice+3", wide_a[:, 3:131], wide_b, False),
        ("b slice+5", wide_a[:, :128], wide_b[:, 5:261], False),
        # a row stride of 130 elements, 260 bytes: not whole 16 bytes
        ("stride 130", _zeros((64, 130), dt)[:, :128], wide_b[:, :256],
         False),
        # the base 2 bytes past an aligned one
        ("offset 1", flat[1:1 + 64 * 128].view(64, 128), wide_b[:, :256],
         False),
        # one row broadcast to 64 (row stride 0), as x.expand(64, K)
        ("broadcast a", wide_a[:1, :128].expand(64, 128), wide_b[:, :256],
         False),
        # rows 8 elements (16 bytes) apart, each 256 long: they overlap
        ("overlapping b", wide_a[:, :128], flat[:128 * 8 + 256].as_strided(
            (128, 256), (8, 1)), False),
    ]


@pytest.mark.parametrize("view", range(8))
def test_select_path_by_alignment(view):
    """bfloat16 past 16 rows takes wgmma only where both operands' bases
    and row strides are 16-byte aligned (the wgmma test's slice 8
    elements in does, the 3-element slice, a broadcast a and a b of
    overlapping rows do not); at 16 rows every
    view streams; float32 and int8 never take wgmma."""
    for dtype, dt in DTYPES.items():
        name, a, b, aligned = _views(dt)[view]
        assert b.shape[0] == a.shape[1] == 128, name
        if dt == torch.bfloat16:
            assert (mm.tma_aligned(a) and mm.tma_aligned(b)) == aligned, name
        want = WIDE_PATH[dtype]
        if dtype == "bfloat16" and not aligned:
            want = "mma"
        assert mm.select_path(a, b) == want, (dtype, name)
        assert mm.select_path(a[:16], b) == "stream", (dtype, name)
        assert mm.select_path(a[:17], b) == want, (dtype, name)


def test_tma_aligned():
    t = _zeros((8, 24), torch.bfloat16)
    assert mm.tma_aligned(t)
    assert not mm.tma_aligned(t[:, 1:])          # base 2 bytes off
    assert not mm.tma_aligned(t.t())             # column stride 24
    assert not mm.tma_aligned(_zeros((8, 12), torch.bfloat16))  # 24 bytes
    # row stride 0 or less than a row: the TMA map needs whole rows apart
    assert not mm.tma_aligned(_zeros((1, 24), torch.bfloat16).expand(8, 24))
    assert not mm.tma_aligned(t.as_strided((8, 24), (8, 1)))
    assert mm.tma_aligned(_zeros((1, 24), torch.bfloat16).expand(1, 24))
    # one row: its stride is never stepped; one column: its stride neither
    assert mm.tma_aligned(_zeros((1, 12), torch.bfloat16))
    assert mm.tma_aligned(_zeros((8, 4), torch.float32)[:, ::4])
    assert not mm.tma_aligned(_zeros((8, 1), torch.float32))  # 4 bytes
    assert mm.tma_aligned(_zeros((8, 16), torch.int8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("KN", [(1, 1), (7, 5), (100, 7), (2048, 8192),
                                (8192, 2048), (2048, 2048), (8192, 8192),
                                (4096, 49155), (mm.MAX_K_INT8, 3)],
                         ids=lambda kn: "K{}-N{}".format(*kn))
def test_stream_plan_covers_k(dtype, KN):
    """Every split is whole tiles of at most STREAM_MAX_K rows, none is
    empty, together they cover K exactly once; the grid holds at most one
    wave of STREAM_BLOCKS blocks unless a split is at its most rows, and
    more than half a wave unless every split is one tile; the plan is a
    function of the shapes alone."""
    K, N = KN
    dt = DTYPES[dtype]
    kt = mm.STREAM_K_TILE[dt]
    n_split, per = mm.stream_plan(K, N, dt)
    assert (n_split, per) == mm.stream_plan(K, N, dt)
    assert 1 <= per and per * kt <= mm.STREAM_MAX_K
    assert n_split * per * kt >= K > (n_split - 1) * per * kt
    assert n_split <= 65535
    tiles = -(-K // kt)
    blocks = -(-N // mm.STREAM_COLS) * n_split
    assert blocks <= mm.STREAM_BLOCKS or per * kt == mm.STREAM_MAX_K
    assert 2 * blocks > mm.STREAM_BLOCKS or n_split == tiles


def test_stream_plan_at_the_decode_shape():
    """granite-3-2b's gate/up at decode, (4, 2048) @ (2048, 8192): 64
    column blocks, K cut 8 ways on every lane: 512 blocks, one wave of 4
    an SM, each reading an eighth of b's rows (256) in whole 8 KB tiles."""
    for dt in DTYPES.values():
        n_split, per = mm.stream_plan(2048, 8192, dt)
        assert n_split == 8 and per * mm.STREAM_K_TILE[dt] == 256
        assert 64 * n_split <= mm.STREAM_BLOCKS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [1, 16, 17])
def test_wrapper_takes_plain_on_cpu(dtype, M):
    """On a CPU tensor the wrapper returns its plain version's result,
    counts no launch on any path, and matches the Pallas
    kernel in interpret mode: int8 exactly, fp32 within 2e-4, bf16 within
    one bf16 ulp."""
    dt = DTYPES[dtype]
    K, N = 40, 24
    rng = np.random.default_rng(M * 100 + len(dtype))
    if dt == torch.int8:
        a = rng.integers(-128, 128, (M, K)).astype(np.int8)
        b = rng.integers(-128, 128, (K, N)).astype(np.int8)
        aj, bj = jnp.asarray(a), jnp.asarray(b)
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
    else:
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = rng.standard_normal((K, N)).astype(np.float32)
        jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
        aj, bj = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
        at = torch.from_numpy(np.array(aj.astype(jnp.float32))).to(dt)
        bt = torch.from_numpy(np.array(bj.astype(jnp.float32))).to(dt)
    want = np.asarray(trim_matmul_pallas(aj, bj, block_m=16, block_n=32,
                                         block_k=16, interpret=True))
    mm.reset_launches()
    plain = mm.trim_matmul_plain(at, bt)
    for got in [mm.trim_matmul(at, bt), ops.trim_matmul(at, bt)]:
        assert torch.equal(got, plain)
    assert mm.LAUNCHES == 0
    assert set(mm.LAUNCHES_BY_PATH.values()) == {0}
    g = plain.float().numpy()
    w = want.astype(np.float32)
    if dt == torch.int8:
        np.testing.assert_array_equal(plain.numpy(), want)
    elif dt == torch.float32:
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
    else:
        mag = np.maximum(np.abs(g), np.abs(w))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
        assert (np.abs(g - w) <= ulp).all()


def test_wrapper_refuses_an_unknown_path():
    """The launcher under the wrapper takes only the kernel's paths, and
    only CUDA operands: on a CPU tensor it raises rather than run the
    plain version (the public wrapper does that)."""
    a, b = torch.zeros((4, 8)), torch.zeros((8, 3))
    with pytest.raises(ValueError, match="path"):
        mm._launch(a, b, None, "tf32")
    for p in mm.PATHS:
        with pytest.raises(ValueError, match="runs on cuda"):
            mm._launch(a, b, None, p)


def test_reset_launches():
    mm.LAUNCHES = 3
    mm.LAUNCHES_BY_PATH["stream"] = 2
    mm.reset_launches()
    assert mm.LAUNCHES == 0
    assert mm.LAUNCHES_BY_PATH == dict.fromkeys(mm.PATHS, 0)


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """A library's build key hashes every ``csrc/*.cuh`` beside its own
    sources, so an edit of the shared header rebuilds the kernels that
    include it, and an unchanged tree keeps its key; the matmul library
    includes ``hopper.cuh``."""
    assert '#include "hopper.cuh"' in (_build.CSRC / "trim_matmul.cu"
                                       ).read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    key = _build.library_path("k", ["k.cu"])
    assert _build.library_path("k", ["k.cu"]) == key
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k", ["k.cu"]) != key


#: ``chip_smoke.py`` phase 3e's ragged shapes and granite-3-2b's decode
#: rows (its gate/up at M = 4, 1 and 16): (M, K, N)
PHASE_3E = [(1, 1, 1), (7, 13, 5), (64, 96, 48), (200, 120, 150),
            (33, 7, 129), (129, 65, 257), (4, 2048, 8192), (1, 2048, 8192),
            (16, 2048, 8192)]


def _launch_args(a, b):
    """The arguments ``trim_matmul._launch`` builds for a (M, K) @ b (K,
    N) on the path ``select_path`` picks: (out, path, n_split,
    split_tiles, workspace)."""
    (M, K), N = a.shape, b.shape[1]
    path = mm.select_path(a, b)
    n_split, tiles = (mm.stream_plan(K, N, a.dtype) if path == "stream"
                      else (1, 1))
    acc = torch.int32 if a.dtype == torch.int8 else torch.float32
    ws = torch.empty((n_split, M, N), dtype=acc) if n_split > 1 else None
    out = torch.empty((M, N), dtype=acc if a.dtype == torch.int8
                      else a.dtype)
    return out, path, n_split, tiles, ws


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", PHASE_3E, ids=str)
def test_launch_arguments_within_the_kernel_bounds(shape, dtype):
    """Every launch phase 3e makes passes the host-side check of its
    arguments against the kernel's tile and grid bounds (and the column
    slice a layer's projection passes, read in place); the check raises
    before a launch where one is outside them."""
    M, K, N = shape
    dt = DTYPES[dtype]
    a, b = _zeros((M, K), dt), _zeros((K, N), dt)
    out, path, n_split, tiles, ws = _launch_args(a, b)
    mm.check_launch(a, b, out, path, n_split, tiles, ws)
    wide = _zeros((M, K + 8), dt)[:, 8:]
    mm.check_launch(wide, b, *_launch_args(wide, b))
    bad = []
    if path == "stream":
        bad += [(a, b, out, path, n_split + 1, tiles, ws),
                (a, b, out, path, max(1, n_split - 1), tiles, ws)
                if n_split > 1 else (a, b, out, path, 1, 0, None)]
        if n_split > 1:
            bad.append((a, b, out, path, n_split, tiles, ws.to(torch.int16)))
    else:
        big = _zeros((mm.STREAM_ROWS + 1, K), dt)
        bad.append((big, b, torch.empty((big.shape[0], N), dtype=out.dtype),
                    "stream", 1, 1, None))
    other = {torch.float32: "wgmma", torch.bfloat16: "fma",
             torch.int8: "fma"}[dt]
    bad.append((a, b, out, other, 1, 1, None))
    bad.append((a, b, out.t() if M > 1 and N > 1 else out[:, :0], path,
                n_split, tiles, ws))
    for args in bad:
        with pytest.raises(ValueError):
            mm.check_launch(*args)


def test_launch_check_refuses_unaligned_wgmma_and_big_grids():
    """The wgmma path refuses operands the TMA cannot read as they lie;
    mma and fma refuse more than 65535 row tiles."""
    a, b = _zeros((64, 128), torch.bfloat16), _zeros((128, 256),
                                                      torch.bfloat16)
    out = torch.empty((64, 256), dtype=torch.bfloat16)
    mm.check_launch(a, b, out, "wgmma")
    with pytest.raises(ValueError, match="TMA"):
        mm.check_launch(_zeros((64, 131), torch.bfloat16)[:, 3:], b, out,
                        "wgmma")
    rows = mm.BLOCK_M * 65535 + 1
    tall = torch.zeros((1, 1)).expand(rows, 1)
    one = torch.zeros((1, 1))
    with pytest.raises(ValueError, match="grid"):
        mm.check_launch(tall, one, torch.empty((rows, 1)), "fma")


@pytest.mark.parametrize("edge", ["rows", "columns"])
@pytest.mark.parametrize("past", [False, True])
def test_launch_check_holds_the_fma_geometry(edge, past):
    """The fma path's grid: at most 65535 row tiles of FMA_BLOCK[0] and
    fewer than 2^31 column tiles of FMA_BLOCK[1]; one row or column past
    either is refused before a launch.  (Broadcast operands, and the
    output on the meta device: nothing is allocated.)"""
    bm, bn = mm.FMA_BLOCK
    M, N = (bm * 65535, 1) if edge == "rows" else (17, bn * (2 ** 31 - 1))
    if past:
        M, N = (M + 1, N) if edge == "rows" else (M, N + 1)
    a = torch.zeros((1, 8)).expand(M, 8)
    b = torch.zeros((8, 1)).expand(8, N)
    out = torch.empty((M, N), device="meta")
    assert mm.select_path(a, b) == "fma"
    if past:
        with pytest.raises(ValueError, match="grid"):
            mm.check_launch(a, b, out, "fma")
    else:
        mm.check_launch(a, b, out, "fma")
