"""The flash kernel's geometry at every head dim the kernel takes, on the
CPU: the bf16 prefill's (``flash_attention.prefill_tile``, held to the
library's ``PfWgTile<D>`` / ``PfTile<D>`` when it loads): shared memory
within an H100 block's, registers within a thread's share of an SM's,
tiles that wgmma and TMA take; the fp32 lane's (``flash_attention.f32_tile``,
held to ``F32Tile<D>`` / ``F32Split<D>``): the prefill's and the split
decode's shared memory, the lane tiles, the split decode's blocks an SM;
and the wrapper's launch-grid check at each head dim's rows.
"""
import pytest

from repro_torch.kernels import flash_attention as fa

DIMS = fa.HEAD_DIMS


@pytest.mark.parametrize("D", DIMS)
def test_prefill_tile_fits_an_h100_block(D):
    """Shared memory within the 227 KB a block can have, and the K/V ring
    of at least two stages."""
    t = fa.prefill_tile(D)
    assert t.smem_bytes <= fa.SMEM_BYTES
    assert t.stages >= 2
    dp = max(D, 64)
    q = t.warpgroups * 64 * dp * 2
    kv = t.stages * 2 * t.keys * dp * 2
    assert q + kv < t.smem_bytes <= q + kv + 1024 + t.stages * 4 * 8


@pytest.mark.parametrize("D", DIMS)
def test_prefill_tile_registers_fit_the_sub_partitions(D):
    """Every warp of the block at ``regs`` registers fits the 16384 of each
    of an SM's four sub-partitions (a quarter of the warps each, rounded
    up), and a thread's fp32 O and S (and, with the overlapped chain at
    D = 256, its bf16 P) leave room for addresses and row state."""
    t = fa.prefill_tile(D)
    warps = t.threads // 32
    assert -(-warps // 4) * 32 * t.regs <= fa.SMSP_REGISTERS
    assert t.regs == fa.MAX_THREAD_REGISTERS or t.regs % 8 == 0
    o, s = max(D, 64) // 2, t.keys // 2
    p = t.keys // 4 if D == 256 else 0
    assert o + s + p + 24 <= t.regs


@pytest.mark.parametrize("D", DIMS)
def test_prefill_tile_shapes_take_wgmma_and_tma(D):
    """64 rows a warpgroup (wgmma's M), keys a multiple of 16 (P V's K
    step) and of 8 (S = Q K^T's N) up to 256 (wgmma's N and a TMA box's
    rows), and the threads of the warpgroups (plus a producer warpgroup at
    D <= 64)."""
    t = fa.prefill_tile(D)
    assert t.rows == 64 * t.warpgroups
    assert t.keys % 16 == 0 and t.keys <= 256
    assert t.threads == 128 * (t.warpgroups + (D <= 64))


def test_prefill_tiles_by_head_dim():
    """The layout chosen per head dim: three consumer warpgroups and a
    producer warpgroup (128 registers a thread) at D <= 64, one block for
    the padded 64 columns; two warpgroups of 255 registers a thread above;
    80-key tiles at D = 256."""
    got = {D: fa.prefill_tile(D) for D in DIMS}
    assert {D: t.rows for D, t in got.items()} == {
        8: 192, 16: 192, 32: 192, 64: 192, 128: 128, 256: 128}
    assert got[256].keys == fa.D256_KEYS == 80
    assert len({got[D] for D in (8, 16, 32, 64)}) == 1
    assert got[64].threads == 512 and got[64].regs == 128
    assert got[128].threads == got[256].threads == 256
    assert got[128].regs == got[256].regs == 255
    with pytest.raises(ValueError, match="head dim"):
        fa.prefill_tile(48)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("Sq,G", [(1, 17), (4096, 1), (4096, 7), (333, 12)])
def test_grid_counts_the_prefill_rows_of_each_head(D, Sq, G):
    """The wrapper's grid check counts the prefill's blocks at the head
    dim's rows of each lane: every (b, h) gets ceil(Sq G / rows) row
    tiles."""
    B, H = 3, 5
    rows = fa.prefill_tile(D).rows
    assert fa._grid_x(B, Sq, H, G, D, True) == -(-Sq * G // rows) * B * H
    rows = fa.f32_tile(D).rows
    assert fa._grid_x(B, Sq, H, G, D, False) == -(-Sq * G // rows) * B * H


@pytest.mark.parametrize("D", DIMS)
def test_f32_tile_fits_an_h100_block_and_sm(D):
    """The fp32 prefill's and split decode's shared memory within a block's
    227 KB; Q, the K/V ring of two stages and P account for the prefill's
    (Q and K rows padded by 4 floats, P rows by 8); the split decode's
    blocks an SM fit its 228 KB, two at least."""
    t = fa.f32_tile(D)
    dp = max(D, 32)
    assert max(t.smem_bytes, t.split_smem_bytes) <= fa.SMEM_BYTES
    assert t.stages >= 2
    assert t.smem_bytes == 4 * (t.rows * (dp + 4) + t.stages * t.keys
                                * (2 * dp + 4) + t.rows * (t.keys + 8))
    assert 2 <= t.split_per_sm
    assert t.split_per_sm * (t.split_smem_bytes + fa.SM_BLOCK_RESERVED) \
        <= fa.SM_SMEM_BYTES


@pytest.mark.parametrize("D", DIMS)
def test_f32_tile_lanes_cover_the_tiles(D):
    """A warp of the prefill owns 16 rows (4 row groups of 4 rows) and each
    of its 8 lane columns kKeys / 8 keys and 4 of every 32 columns; a warp
    of the split decode reads 32 segments of 32 floats, one a lane, in
    whole sub-tiles of the split's 64-key unit."""
    t = fa.f32_tile(D)
    dp = max(D, 32)
    assert t.rows == 16 * (t.threads // 32)
    assert t.keys % 8 == 0 and dp % 32 == 0
    assert t.split_keys * dp == 32 * 32
    assert fa.SPLIT_TILE % t.split_keys == 0


def test_f32_tiles_by_head_dim():
    """The fp32 layout chosen per head dim: 64-key prefill tiles up to
    D = 64, 32 at 128 and 16 at 256 (Q of 128 rows takes 133 KB there);
    three split blocks an SM below D = 256, two at 256."""
    got = {D: fa.f32_tile(D) for D in DIMS}
    assert {D: t.keys for D, t in got.items()} == {
        8: 64, 16: 64, 32: 64, 64: 64, 128: 32, 256: 16}
    assert {D: t.split_per_sm for D, t in got.items()} == {
        8: 3, 16: 3, 32: 3, 64: 3, 128: 3, 256: 2}
    assert len({got[D] for D in (8, 16, 32)}) == 1
    with pytest.raises(ValueError, match="head dim"):
        fa.f32_tile(48)
