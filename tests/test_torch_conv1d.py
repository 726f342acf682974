"""The port's causal depthwise conv1d against the JAX package's, on the CPU.

``trim_conv1d_plain`` (the CUDA kernel's plain version) and
``ops.trim_conv1d`` (both substrates) are held against the Pallas kernel
``trim_conv1d_pallas`` in interpret mode and against the oracle
``ref.conv1d_causal_ref``, on the same inputs made from a numpy seed.
fp32 within rtol = atol = 1e-5 (the tolerance of the JAX package's own
conv1d tests); bf16 within one bf16 ulp of the JAX oracle (one rounding
to bf16 after fp32 sums that may round differently).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.trim_conv1d import trim_conv1d_pallas
from repro_torch.engine import ExecutionPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.trim_conv1d import trim_conv1d, trim_conv1d_plain

# (B, L, D, K, tile_l): L < K-1, L == 1, ragged tiles, D = 160 (the smoke
# model's conv channels), K from 1 to 6
CASES = [
    (1, 1, 8, 4, 8),
    (2, 2, 5, 4, 8),
    (1, 3, 12, 6, 8),
    (3, 17, 1, 3, 8),
    (2, 33, 40, 4, 16),
    (1, 64, 24, 1, 16),
    (2, 70, 33, 6, 32),
    (1, 41, 160, 4, 16),
    (3, 48, 160, 2, 32),
    (1, 9, 7, 5, 8),
]


def case_id(case):
    return "B{}-L{}-D{}-K{}-t{}".format(*case)


def make_inputs(case):
    B, L, D, K, _ = case
    rng = np.random.default_rng(zlib.crc32(case_id(case).encode()))
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    w = (rng.standard_normal((K, D)) * K ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_conv1d_fp32_matches_jax(case):
    x, w = make_inputs(case)
    tile_l = case[4]
    want_pallas = np.asarray(trim_conv1d_pallas(
        jnp.asarray(x), jnp.asarray(w), tile_l=tile_l, block_d=128,
        interpret=True))
    want_ref = np.asarray(jax_ref.conv1d_causal_ref(jnp.asarray(x),
                                                    jnp.asarray(w)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for got in (trim_conv1d_plain(xt, wt),
                ops.trim_conv1d(xt, wt),
                ops.trim_conv1d(xt, wt, policy=ExecutionPolicy("kernel")),
                ops.trim_conv1d(xt, wt, policy=ExecutionPolicy("oracle"))):
        assert got.dtype == torch.float32 and got.shape == x.shape
        for want in (want_pallas, want_ref):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("case", CASES[::2], ids=case_id)
def test_conv1d_bf16_within_one_ulp_of_jax(case):
    x, w = make_inputs(case)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jax_ref.conv1d_causal_ref(xb, wb)).astype(np.float32)
    bits = lambda a: np.asarray(a).view(np.uint16).view(np.int16)
    xt = torch.from_numpy(bits(xb).copy()).view(torch.bfloat16)
    wt = torch.from_numpy(bits(wb).copy()).view(torch.bfloat16)
    got = trim_conv1d(xt, wt)
    assert got.dtype == torch.bfloat16
    got = _bf16_bits_to_f32(got.view(torch.int16).numpy().view(np.uint16))
    # one bf16 ulp of the larger magnitude (7 stored mantissa bits)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    # and the plain version is the same function in bf16
    np.testing.assert_array_equal(
        trim_conv1d_plain(xt, wt).float().numpy(), got)


def test_conv1d_reads_a_column_slice_in_place():
    """The path's input is a column slice of in_proj's output (a row
    stride wider than D): the same result as on a contiguous copy."""
    rng = np.random.default_rng(7)
    wide = rng.standard_normal((2, 19, 50)).astype(np.float32)
    w = rng.standard_normal((4, 30)).astype(np.float32)
    view = torch.from_numpy(wide)[..., 12:42]
    assert not view.is_contiguous() and view.stride() == (19 * 50, 50, 1)
    want = np.asarray(trim_conv1d_pallas(
        jnp.asarray(wide[..., 12:42]), jnp.asarray(w), tile_l=8,
        interpret=True))
    got = ops.trim_conv1d(view, torch.from_numpy(w),
                          policy=ExecutionPolicy("kernel"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        got, trim_conv1d_plain(view.contiguous(), torch.from_numpy(w)),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["K9", "dtype", "shape"])
def test_conv1d_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((1, 4, 8))
    w = {"K9": torch.zeros((9, 8)), "dtype": torch.zeros((2, 8),
         dtype=torch.float64), "shape": torch.zeros((2, 7))}[bad]
    with pytest.raises(ValueError):
        trim_conv1d(x, w)


# (B, L, D, K, dtype): the kernel's three path shapes (mamba2-130m's xBC at
# full width, at the training batch and on one of two ranks), the 2**31
# element card test's, and ragged ones (L < ROWS, L < K - 1, D cut inside a
# 16-byte vector, one channel, L not a multiple of ROWS)
PLAN_SHAPES = [
    (4, 4096, 1792, 4, "bfloat16"), (4, 1024, 1792, 4, "bfloat16"),
    (4, 4096, 896, 4, "bfloat16"), (4, 4096, 1792, 4, "float32"),
    (1, 2 ** 31 // 128 + 300, 128, 4, "bfloat16"),
    (1, 1, 8, 4, "float32"), (2, 2, 5, 4, "bfloat16"), (3, 17, 1, 3, "float32"),
    (2, 70, 33, 6, "bfloat16"), (1, 41, 160, 8, "float32"),
    (2, 300, 130, 8, "bfloat16"), (64, 9, 20000, 2, "bfloat16"),
]


def _chunks(l0, l1, rows):
    """The positions the kernel's loops visit in a run [l0, l1): whole
    chunks of ``rows``, then the rest a row at a time."""
    seen, l = [], l0
    while l + rows <= l1:
        seen += range(l, l + rows)
        l += rows
    return seen + list(range(l, l1))


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_conv1d_plan_covers_every_output_once(shape):
    """The kernel's grid plan: thread t owns channel vector t % dvecs of
    run (t // dvecs) % runs of image t // (dvecs * runs), so the threads
    are a bijection onto (image, run, vector); the runs cut [0, L) and
    the vectors [0, D) with no gap or overlap; the blocks hold every
    thread; and the chunk loops visit each position of a run once.  At
    the path shapes the grid is one wave of resident blocks."""
    from repro_torch.kernels import trim_conv1d as k1
    B, L, D, K, dt = shape
    rows = k1.ROWS[getattr(torch, dt)]
    p = k1.plan(B, L, D, K, getattr(torch, dt))
    assert p.vec == (8 if dt == "bfloat16" else 4)
    assert p.span % rows == 0 and p.runs == -(-L // p.span)
    assert p.dvecs == -(-D // p.vec) and p.threads == B * p.runs * p.dvecs
    assert (p.blocks - 1) * k1.THREADS < p.threads <= p.blocks * k1.THREADS
    t = np.arange(p.threads, dtype=np.int64)
    dv, run, b = t % p.dvecs, (t // p.dvecs) % p.runs, t // (p.dvecs * p.runs)
    assert b.max() == B - 1
    key = (b * p.runs + run) * p.dvecs + dv
    assert np.array_equal(np.sort(key), t)          # each (b, run, dv) once
    starts = np.arange(p.runs) * p.span
    ends = np.minimum(starts + p.span, L)
    assert starts[0] == 0 and ends[-1] == L and (starts[1:] == ends[:-1]).all()
    assert (ends > starts).all()
    d0 = np.arange(p.dvecs) * p.vec
    assert (np.minimum(d0 + p.vec, D)[:-1] == d0[1:]).all() and d0[-1] < D
    for l0, l1 in {(int(starts[0]), int(ends[0])),
                   (int(starts[-1]), int(ends[-1]))}:
        assert _chunks(l0, l1, rows) == list(range(l0, l1))
    if B * p.dvecs < k1.BLOCKS_PER_SM[K] * k1.SMS * k1.THREADS:
        assert p.blocks <= k1.BLOCKS_PER_SM[K] * k1.SMS
    else:
        assert p.span == rows


def _emulate(x: np.ndarray, w: np.ndarray, p, rows: int) -> np.ndarray:
    """The kernel's loops in numpy float32 (each product and sum rounded
    on its own, taps in order from 0): per thread the K-1 rows before its
    run (zeros before 0), then its run's positions, the window slid on."""
    B, L, D = x.shape
    K = w.shape[0]
    out = np.zeros_like(x)
    for t in range(p.threads):
        dv, run, b = t % p.dvecs, (t // p.dvecs) % p.runs, \
            t // (p.dvecs * p.runs)
        d = slice(dv * p.vec, min(D, dv * p.vec + p.vec))
        l0, l1 = run * p.span, min(L, run * p.span + p.span)
        win = [x[b, l, d] if l >= 0 else np.zeros_like(x[b, 0, d])
               for l in range(l0 - K + 1, l0)]
        for l in _chunks(l0, l1, rows):
            win.append(x[b, l, d])
            acc = np.zeros_like(win[0])
            for k in range(K):
                acc = np.float32(acc + np.float32(win[k] * w[k, d]))
            out[b, l, d] = acc
            win.pop(0)
    return out


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_conv1d_kernel_loops_match_plain(case):
    """A numpy emulation of the CUDA kernel's threads, runs and sliding
    window over the wrapper's plan gives the plain version's fp32 bits."""
    from repro_torch.kernels import trim_conv1d as k1
    x, w = make_inputs(case)
    B, L, D, K, _ = case
    got = _emulate(x, w, k1.plan(B, L, D, K, torch.float32),
                   k1.ROWS[torch.float32])
    want = trim_conv1d_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got, want.numpy())
