"""The port's SSD scan against the JAX package's, on the CPU.

``trim_ssd_plain`` (the CUDA kernel's plain version, which the wrapper
``trim_ssd`` takes for a CPU tensor) and the oracle ``ref.ssd_ref`` are
held against the Pallas kernel ``trim_ssd_pallas`` in interpret mode and
against JAX's ``ssd_ref``, on the same inputs made from a numpy seed in
the ranges of ``tests/test_ssd_kernel.py``: fp32 within 2e-5 on its
``CASES``, 5e-5 across chunkings (chunking is math-neutral), bf16 x/B/C
within 5e-2 of the fp32 oracle -- that file's tolerances.  A plain mirror
of the CUDA kernel's stages (:func:`staged_ssd`) is held to the same two
within 2e-5: the only check of the kernel's decomposition without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.trim_ssd import ssd_ref as jax_ssd_ref
from repro.kernels.trim_ssd import trim_ssd_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import trim_ssd as ks
from repro_torch.kernels.trim_ssd import (KERNEL_CHUNK, TILE_P, TILE_S,
                                         trim_ssd, trim_ssd_plain)
from repro_torch.nn.mamba import ssd_chunked

# (B, L, H, P, S, chunk): tests/test_ssd_kernel.py CASES, then L = 1,
# L ragged against a chunk of 64, and mamba2-130m's P = 64, S = 128
CASES = [
    (2, 37, 3, 8, 16, 8),
    (1, 64, 2, 4, 8, 16),
    (2, 16, 1, 8, 8, 16),
    (1, 128, 2, 16, 32, 32),
    (1, 1, 2, 4, 8, 8),
    (1, 70, 2, 8, 8, 64),
    (1, 40, 2, 64, 128, 16),
]


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """torch's CPU ``exp`` can be off on the first multithreaded call of a
    process (``tools/torch_exp_first_call.py`` shows it: with torch 2.13
    on AVX-512, up to 1e-4 from float64 in 6 fresh processes of 20, never
    with one thread, on a second call or after one call on zeros), which
    the plain version's first call would carry into a 2e-5 comparison
    with JAX.  One call first keeps that library fault out of these
    checks."""
    torch.exp(torch.zeros(1 << 16))


def make_inputs(rng, B, L, H, P, S, groups=None):
    """numpy inputs in tests/test_ssd_kernel.py's ranges; B/C per head, or
    of ``groups`` groups when given."""
    G = H if groups is None else groups
    return (rng.normal(size=(B, L, H, P)).astype(np.float32),
            rng.uniform(1e-3, 0.1, (B, L, H)).astype(np.float32),
            (-rng.uniform(0.3, 2, (H,))).astype(np.float32),
            rng.normal(size=(B, L, G, S)).astype(np.float32),
            rng.normal(size=(B, L, G, S)).astype(np.float32),
            rng.normal(size=(H,)).astype(np.float32))


def torch_args(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ssd_fp32_matches_jax(case):
    B, L, H, P, S, CS = case
    args = make_inputs(np.random.default_rng(sum(case)), B, L, H, P, S)
    jargs = [jnp.asarray(a) for a in args]
    want_pallas = np.asarray(trim_ssd_pallas(*jargs, chunk=CS,
                                             interpret=True))
    want_ref = np.asarray(jax_ssd_ref(*jargs, chunk=CS))
    targs = torch_args(args)
    for got in (trim_ssd_plain(*targs, chunk=CS), trim_ssd(*targs, chunk=CS),
                ref.ssd_ref(*targs, chunk=CS)):
        assert got.dtype == torch.float32 and got.shape == (B, L, H, P)
        for want in (want_pallas, want_ref):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=2e-5)


@settings(max_examples=8, deadline=None)
@given(L=st.integers(2, 60), CS=st.sampled_from([4, 8, 16]),
       seed=st.integers(0, 100))
def test_ssd_chunking_is_math_neutral(L, CS, seed):
    """The port at one chunk against JAX's oracle and Pallas kernel at
    another (the kernel's own chunk differs from the caller's)."""
    args = make_inputs(np.random.default_rng(seed), 1, L, 2, 4, 8)
    jargs = [jnp.asarray(a) for a in args]
    got = trim_ssd_plain(*torch_args(args), chunk=CS).numpy()
    other = max(CS // 2, 2)
    for want in (jax_ssd_ref(*jargs, chunk=other),
                 trim_ssd_pallas(*jargs, chunk=2 * CS, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=5e-5,
                                   atol=5e-5)


def test_ssd_bf16_within_5e_2():
    x, dt, A, Bm, Cm, D = make_inputs(np.random.default_rng(3), 1, 32, 2, 8,
                                      8)
    want = np.asarray(jax_ssd_ref(*[jnp.asarray(a) for a in
                                    (x, dt, A, Bm, Cm, D)], chunk=16))
    bf = lambda a: torch.from_numpy(a).bfloat16()
    got = trim_ssd(bf(x), torch.from_numpy(dt), torch.from_numpy(A), bf(Bm),
                   bf(Cm), torch.from_numpy(D), chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)
    want16 = np.asarray(trim_ssd_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16),
        jnp.asarray(D), chunk=16, interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want16, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("L", [37, 64])
def test_ssd_expanded_group_equals_repeated_heads(L):
    """mamba2-130m's one B/C group, expanded over the heads (stride 0):
    the same y as the repeated copies, and as the mixer's own grouped
    ``ssd_chunked``."""
    B, H, P, S, CS = 2, 4, 8, 16, 16
    x, dt, A, Bm, Cm, D = torch_args(make_inputs(
        np.random.default_rng(L), B, L, H, P, S, groups=1))
    Be, Ce = Bm.expand(B, L, H, S), Cm.expand(B, L, H, S)
    assert Be.stride(2) == 0
    got = trim_ssd(x, dt, A, Be, Ce, D, chunk=CS)
    rep = trim_ssd(x, dt, A, Be.contiguous(), Ce.contiguous(), D, chunk=CS)
    torch.testing.assert_close(got, rep, rtol=1e-6, atol=1e-6)
    grouped, _ = ssd_chunked(x, dt, A, Bm, Cm, D, chunk=CS)
    torch.testing.assert_close(got, grouped, rtol=2e-5, atol=2e-5)
    want = trim_ssd_pallas(*[jnp.asarray(t.numpy()) for t in
                             (x, dt, A, Be.contiguous(), Ce.contiguous(), D)],
                           chunk=CS, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("bad", ["x_dims", "dt_shape", "bc_groups",
                                 "dtype", "chunk"])
def test_ssd_rejects_what_the_kernel_does_not_take(bad):
    x, dt, A, Bm, Cm, D = torch_args(make_inputs(
        np.random.default_rng(0), 1, 8, 2, 4, 8))
    kw = {}
    if bad == "x_dims":
        x = x[0]
    elif bad == "dt_shape":
        dt = dt[:, :4]
    elif bad == "bc_groups":
        Bm, Cm = Bm[:, :, :1], Cm[:, :, :1]
    elif bad == "dtype":
        Bm = Bm.bfloat16()
    else:
        kw["chunk"] = 0
    with pytest.raises(ValueError):
        trim_ssd(x, dt, A, Bm, Cm, D, **kw)


def staged_ssd(x, dt, A, Bm, Cm, D, *, kchunk=KERNEL_CHUNK, rows=16,
               ptile=TILE_P, stile=TILE_S):
    """Test-only mirror, in plain fp32 PyTorch, of the CUDA kernel's stages
    (``csrc/trim_ssd.cu``) in chunks of ``kchunk`` rows, L zero-padded, P
    in tiles of ``ptile`` and S in tiles of ``stile`` (both zero-padded to
    whole tiles, as the kernel's states are):

    cb: C.B^T of each chunk, its ``rows``-row tiles on and below the
        diagonal only, once per (b, chunk, group): once for every head when
        B and C are one group expanded with stride 0 over H; summed over S
        in pieces of half an S tile, in order;
    state: each (P tile, S tile) of each chunk's own end state
        (x o exp(cum_last - cum) dt)^T B;
    pass: the entering states, in chunk order;
    out: y of each ``rows``-row tile and P tile from the columns up to its
        last row, (C.B^T o exp(cum_i - cum_j) o dt_j) x + exp(cum) (C h^T)
        + D x, C h^T summed over the S tiles in order.
    """
    Bb, L, H, P = x.shape
    S = Bm.shape[3]
    T = kchunk
    NC = -(-L // T)
    pad = NC * T - L
    Pp, Sp = -(-P // ptile) * ptile, -(-S // stile) * stile
    if Bm.stride(2) == 0 and Cm.stride(2) == 0:
        Bm, Cm = Bm[:, :, :1], Cm[:, :, :1]  # the one group
    G = Bm.shape[2]

    def chunks(t, width=None):  # (B, L, ...) -> (B, NC, T, ...), zero-padded
        if width is not None:
            t = torch.cat([t, t.new_zeros(t.shape[:-1] + (width - t.shape[-1],))],
                          dim=-1)
        t = torch.cat([t, t.new_zeros((Bb, pad) + t.shape[2:])], dim=1)
        return t.reshape((Bb, NC, T) + t.shape[2:])

    xc = chunks(x.float(), Pp)
    dtc = chunks(dt.float())
    Bc, Cc = chunks(Bm.float(), Sp), chunks(Cm.float(), Sp)
    cum = torch.cumsum(dtc * A, dim=2)                     # (B, NC, T, H)
    cb = torch.zeros(Bb, NC, G, T, T)
    half = stile // 2
    for r0 in range(0, T, rows):
        r1 = r0 + rows
        for s0 in range(0, -(-S // half) * half, half):
            cb[..., r0:r1, :r1] += torch.einsum(
                "bcigs,bcjgs->bcgij", Cc[:, :, r0:r1, :, s0:s0 + half],
                Bc[:, :, :r1, :, s0:s0 + half])
    head = lambda t, dim: t if G == H else t.expand(
        *t.shape[:dim], H, *t.shape[dim + 1:])
    w = torch.exp(cum[:, :, -1:] - cum) * dtc
    dbx = torch.zeros(Bb, NC, H, Pp, Sp)
    Bh = head(Bc, 3)
    for p0 in range(0, Pp, ptile):
        for s0 in range(0, Sp, stile):
            dbx[..., p0:p0 + ptile, s0:s0 + stile] = torch.einsum(
                "bcthp,bcths->bchps", xc[..., p0:p0 + ptile] * w[..., None],
                Bh[..., s0:s0 + stile])
    h = torch.zeros(Bb, H, Pp, Sp)
    entering = []
    for c in range(NC):
        entering.append(h)
        h = torch.exp(cum[:, c, -1])[..., None, None] * h + dbx[:, c]
    entering = torch.stack(entering, dim=1)              # (B, NC, H, P', S')
    Ch = head(Cc, 3)
    y = torch.empty_like(xc)
    for r0 in range(0, T, rows):
        r1 = r0 + rows
        ci, cj = cum[:, :, r0:r1], cum[:, :, :r1]
        decay = torch.exp(ci[:, :, :, None] - cj[:, :, None])  # b c i j h
        mask = torch.arange(r0, r1)[:, None] >= torch.arange(r1)[None]
        scores = head(cb[..., r0:r1, :r1].permute(0, 1, 3, 4, 2), 4) \
            * torch.where(mask[..., None], decay, 0.0) \
            * dtc[:, :, None, :r1]
        for p0 in range(0, Pp, ptile):
            pc = slice(p0, p0 + ptile)
            ch = torch.zeros(Bb, NC, r1 - r0, H, ptile)
            for s0 in range(0, Sp, stile):
                ch += torch.einsum(
                    "bcihs,bchps->bcihp", Ch[:, :, r0:r1, :, s0:s0 + stile],
                    entering[..., pc, s0:s0 + stile])
            y[:, :, r0:r1, :, pc] = (
                torch.einsum("bcijh,bcjhp->bcihp", scores, xc[:, :, :r1, :, pc])
                + torch.exp(ci)[..., None] * ch
                + D[:, None] * xc[:, :, r0:r1, :, pc])
    return y.reshape(Bb, NC * T, H, Pp)[:, :L, :, :P]


# (B, L, H, P, S, chunk): the CASES, then mamba2-130m's P = 64, S = 128 over
# three kernel chunks with a ragged tail (300 = 2 x 128 + 44)
STAGED_CASES = CASES + [(1, 300, 2, 64, 128, 64)]


@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "group"])
@pytest.mark.parametrize("case", STAGED_CASES, ids=str)
def test_ssd_kernel_stages_match_jax(case, shared):
    """The kernel's stages, mirrored in plain PyTorch at its chunk of 128
    and 16-row tiles, against the Pallas kernel (interpret mode) and JAX's
    oracle on the same inputs, fp32 within 2e-5; B/C per head, or one
    group expanded over the heads with stride 0 (C.B^T taken once)."""
    B, L, H, P, S, CS = case
    rng = np.random.default_rng(sum(case) + shared)
    args = make_inputs(rng, B, L, H, P, S, groups=1 if shared else None)
    x, dt, A, Bm, Cm, D = args
    if shared:
        Bm, Cm = (np.repeat(t, H, axis=2) for t in (Bm, Cm))
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)]
    targs = torch_args(args)
    if shared:
        targs[3], targs[4] = (t.expand(B, L, H, S) for t in targs[3:5])
        assert targs[3].stride(2) == 0 or H == 1
    got = staged_ssd(*targs).numpy()
    for want in (trim_ssd_pallas(*jargs, chunk=CS, interpret=True),
                 jax_ssd_ref(*jargs, chunk=CS)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("kchunk,rows", [(128, 64), (64, 16), (256, 64)])
def test_ssd_kernel_stages_are_chunk_neutral(kchunk, rows):
    """The staged mirror at other chunks and tile heights (64-row sub-tiles
    of the (T, T) block among them) gives JAX's oracle at mamba2-130m's
    widths, one group expanded over three heads, fp32 within 2e-5."""
    B, L, H, P, S = 2, 300, 3, 64, 128
    args = make_inputs(np.random.default_rng(kchunk + rows), B, L, H, P, S,
                       groups=1)
    x, dt, A, Bm, Cm, D = args
    want = jax_ssd_ref(*[jnp.asarray(a) for a in (
        x, dt, A, np.repeat(Bm, H, 2), np.repeat(Cm, H, 2), D)], chunk=64)
    t = torch_args(args)
    t[3], t[4] = t[3].expand(B, L, H, S), t[4].expand(B, L, H, S)
    got = staged_ssd(*t, kchunk=kchunk, rows=rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# (P, S): head and state dims past one of the kernel's tiles (P tiles of
# TILE_P, S tiles of TILE_S), ragged and whole
WIDE_DIMS = [(96, 192), (96, 256), (128, 192), (128, 256)]


@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "group"])
@pytest.mark.parametrize("dims", WIDE_DIMS, ids=str)
def test_ssd_every_head_and_state_dim_matches_jax(dims, shared):
    """Head dims 96 and 128 and state dims 192 and 256 (the Pallas kernel
    takes whole P and S a block): the plain version, the CPU wrapper and
    the staged mirror (two kernel chunks, a ragged tail, P and S in the
    kernel's tiles) against ``trim_ssd_pallas`` in interpret mode and
    JAX's oracle, at a chunk of 64 that does not divide L, fp32 within
    2e-5."""
    P, S = dims
    B, L, H, CS = 1, 150, 2, 64
    args = make_inputs(np.random.default_rng(P + S + shared), B, L, H, P, S,
                       groups=1 if shared else None)
    x, dt, A, Bm, Cm, D = args
    if shared:
        Bm, Cm = (np.repeat(t, H, axis=2) for t in (Bm, Cm))
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)]
    wants = (np.asarray(trim_ssd_pallas(*jargs, chunk=CS, interpret=True)),
             np.asarray(jax_ssd_ref(*jargs, chunk=CS)))
    targs = torch_args(args)
    if shared:
        targs[3], targs[4] = (t.expand(B, L, H, S) for t in targs[3:5])
    gots = (trim_ssd_plain(*targs, chunk=CS), trim_ssd(*targs, chunk=CS),
            staged_ssd(*targs))
    for got in gots:
        assert got.shape == (B, L, H, P) and got.dtype == torch.float32
        for want in wants:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize("ptile,stile", [(32, 64), (16, 256)])
def test_ssd_kernel_stages_are_tile_neutral(ptile, stile):
    """The staged mirror at other P and S tiles (ragged against P = 96 and
    S = 192) gives JAX's oracle: tiling P and S changes only the order of
    the S sums, fp32 within 2e-5."""
    B, L, H, P, S = 1, 70, 2, 96, 192
    args = make_inputs(np.random.default_rng(ptile), B, L, H, P, S)
    want = jax_ssd_ref(*[jnp.asarray(a) for a in args], chunk=32)
    got = staged_ssd(*torch_args(args), kchunk=64, ptile=ptile, stile=stile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arch,want", [
    # one B/C group expanded over 24 heads of 64: one P and one S tile
    ("mamba2-130m", dict(
        chunks=32, p_tiles=1, s_tiles=1, groups=1,
        states=(4, 32, 24, 64, 128), cb=(4, 32, 1, ks.CB_FLOATS),
        grids=((1, 32, 4), (24, 32, 4), (8, 24, 4), (24, 32, 4)))),
    # 8 groups repeated over 128 heads of 128: per head, two P tiles
    ("jamba-1.5-large-398b", dict(
        chunks=32, p_tiles=2, s_tiles=1, groups=128,
        states=(4, 32, 128, 128, 128), cb=(4, 32, 128, ks.CB_FLOATS),
        grids=((128, 32, 4), (256, 32, 4), (16, 128, 4), (256, 32, 4)))),
])
def test_ssd_plan_at_the_models_widths(arch, want):
    """The wrapper's launch plan at each Mamba2 mixer's full width (its
    config's heads, head dim and state at a 4 x 4096 prefill): tiles,
    C.B^T groups, the states' shape (1.07 GB at jamba's) and the four
    stages' grids, which the launch grid holds."""
    from repro_torch.configs import get_config
    from repro_torch.nn.models import build_model

    d = build_model(get_config(arch)).spec.dims
    p = ks.plan(4, 4096, d.n_heads, d.headdim, d.d_state,
                shared=d.n_groups == 1)
    assert p._asdict() == want
    ks.check_launch(p)
    if arch.startswith("jamba"):
        assert 4 * np.prod(p.states) == 2 ** 30


def test_ssd_check_launch_refuses_only_what_the_grid_cannot_hold():
    """Any P and S the grid holds pass (P = 1, S = 1, P = 4096, S = 2^20);
    past 65535 heads (the pass stage's y) or blocks along x past 2^31 - 1
    the check raises, saying the launch grid cannot hold the call, before
    anything is allocated; the scratch it sizes is padded to whole tiles."""
    for dims in ((1, 1), (4096, 128), (64, 2 ** 20), (1, 1000)):
        ks.check_launch(ks.plan(2, 300, 3, *dims))
    for shape in ((1, 8, 65536, 1, 1), (1, 8, 65535, 2 ** 14, 2 ** 15),
                  (65536, 8, 1, 1, 1), (1, 128 * 65536, 1, 1, 1),
                  (1, 8, 1, 1, 2 ** 30)):
        with pytest.raises(ValueError, match="launch grid cannot hold"):
            ks.check_launch(ks.plan(*shape))
    p = ks.plan(1, 130, 2, 96, 192)
    ks.check_launch(p)
    assert p.states == (1, 2, 2, 2 * ks.TILE_P, 2 * ks.TILE_S)
    assert p.cb == (1, 2, 2, ks.CB_FLOATS)
