"""The port's matmul against the JAX package's, on the CPU.

``ops.trim_matmul`` (every substrate; on a CPU tensor the kernel's
wrapper takes its plain version ``trim_matmul_plain``) is held against
the Pallas kernel ``trim_matmul_pallas`` in interpret mode and against the
oracle ``ref.matmul_ref``, on the same inputs made from a numpy seed:
fp32 within rtol = atol = 2e-4 (the JAX package's own matmul tolerance,
``tests/test_kernels.py``), int8 exactly with an int32 result, bf16 within
one bf16 ulp (one rounding after fp32 sums that may round differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jax_ref
from repro.kernels.trim_matmul import trim_matmul_pallas
from repro_torch.engine import ExecutionPolicy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.trim_matmul import (MAX_K_INT8, trim_matmul,
                                             trim_matmul_plain)

POLICIES = (None, ExecutionPolicy("auto"), ExecutionPolicy("kernel"),
            ExecutionPolicy("oracle"))


@settings(max_examples=15, deadline=None)
@given(M=st.integers(1, 200), K=st.integers(1, 120), N=st.integers(1, 150),
       bm=st.sampled_from([16, 32, 64]), bk=st.sampled_from([16, 64]))
def test_matmul_fp32_matches_jax(M, K, N, bm, bk):
    rng = np.random.default_rng(M + K * 7 + N * 13)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    want_pallas = np.asarray(trim_matmul_pallas(
        jnp.asarray(a), jnp.asarray(b), block_m=bm, block_n=32, block_k=bk,
        interpret=True))
    want_ref = np.asarray(jax_ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for got in [trim_matmul_plain(at, bt), trim_matmul(at, bt)] + [
            ops.trim_matmul(at, bt, policy=p) for p in POLICIES]:
        assert got.dtype == torch.float32 and got.shape == (M, N)
        for want in (want_pallas, want_ref):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize("shape", [(64, 96, 48), (1, 130, 7), (33, 257, 65)])
def test_matmul_int8_exact(shape):
    M, K, N = shape
    rng = np.random.default_rng(M * K * N)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    want_pallas = np.asarray(trim_matmul_pallas(
        jnp.asarray(a), jnp.asarray(b), block_m=32, block_n=32, block_k=32,
        interpret=True))
    want_ref = np.asarray(jax_ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(want_pallas, want_ref)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for got in [trim_matmul_plain(at, bt), trim_matmul(at, bt)] + [
            ops.trim_matmul(at, bt, policy=p) for p in POLICIES]:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want_ref)


def test_matmul_int8_oracle_is_exact_at_the_largest_sum():
    """All -128 operands at the largest K the int8 lane takes: the sum
    128 * 128 * K is exact in int32 (no wrap, no rounding)."""
    K = MAX_K_INT8
    a = torch.full((2, K), -128, dtype=torch.int8)
    b = torch.full((K, 3), -128, dtype=torch.int8)
    got = trim_matmul_plain(a, b)
    assert got.dtype == torch.int32
    assert int(got.min()) == int(got.max()) == 128 * 128 * K < 2 ** 31
    # the oracle on its own wraps as an int32 accumulator does
    b1 = torch.full((K + 1, 1), -128, dtype=torch.int8)
    a1 = torch.full((1, K + 1), -128, dtype=torch.int8)
    assert int(ref.matmul_ref(a1, b1)) == 128 * 128 * (K + 1) - 2 ** 32


def _bf16(x: np.ndarray):
    """The same bf16 values for jax and torch (jax rounds the fp32)."""
    xj = jnp.asarray(x, jnp.bfloat16)
    bits = np.asarray(xj).view(np.uint16).view(np.int16).copy()
    return xj, torch.from_numpy(bits).view(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 64, 40), (37, 50, 21), (128, 96, 130)])
def test_matmul_bf16_within_one_ulp_of_jax(shape):
    M, K, N = shape
    rng = np.random.default_rng(sum(shape))
    aj, at = _bf16(rng.standard_normal((M, K)).astype(np.float32))
    bj, bt = _bf16(rng.standard_normal((K, N)).astype(np.float32))
    want = np.asarray(jax_ref.matmul_ref(aj, bj)).astype(np.float32)
    want_pallas = np.asarray(trim_matmul_pallas(
        aj, bj, block_m=32, block_n=32, block_k=32,
        interpret=True)).astype(np.float32)
    for got in (trim_matmul_plain(at, bt), ops.trim_matmul(at, bt)):
        assert got.dtype == torch.bfloat16
        g = got.float().numpy()
        mag = np.maximum(np.abs(g), np.abs(want))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
        for w in (want, want_pallas):
            assert (np.abs(g - w) <= ulp).all(), np.abs(g - w).max()
    # out_dtype: the fp32 sums themselves, within fp32 rounding of jax's
    got32 = trim_matmul_plain(at, bt, out_dtype=torch.float32)
    want32 = np.asarray(jax_ref.matmul_ref(aj.astype(jnp.float32),
                                           bj.astype(jnp.float32)))
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-5, atol=1e-5)


def test_matmul_reads_a_column_slice():
    rng = np.random.default_rng(5)
    wide = rng.standard_normal((9, 40)).astype(np.float32)
    b = rng.standard_normal((30, 11)).astype(np.float32)
    view = torch.from_numpy(wide)[:, 7:37]
    assert not view.is_contiguous()
    want = np.asarray(trim_matmul_pallas(jnp.asarray(wide[:, 7:37]),
                                         jnp.asarray(b), interpret=True))
    got = ops.trim_matmul(view, torch.from_numpy(b),
                          policy=ExecutionPolicy("kernel"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", ["shape", "dtype", "mixed", "int8_out",
                                 "wrap"])
def test_matmul_rejects_what_the_kernel_does_not_take(bad):
    a, b, kw = torch.zeros((4, 8)), torch.zeros((8, 3)), {}
    if bad == "shape":
        b = torch.zeros((7, 3))
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "int8_out":
        a, b, kw = a.to(torch.int8), b.to(torch.int8), dict(
            out_dtype=torch.float32)
    else:
        a = torch.zeros((1, MAX_K_INT8 + 1), dtype=torch.int8)
        b = torch.zeros((MAX_K_INT8 + 1, 1), dtype=torch.int8)
    with pytest.raises(ValueError):
        trim_matmul(a, b, **kw)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("bad", ["dtype", "mixed", "wrap"])
def test_matmul_every_substrate_refuses_alike(bad, policy):
    """The oracle substrate runs the kernel's plain version, so it refuses
    what the kernel refuses: float64, mixed dtypes, and an int8 K whose
    int32 sum could wrap."""
    a, b = torch.zeros((4, 8)), torch.zeros((8, 3))
    if bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    else:
        a = torch.zeros((1, MAX_K_INT8 + 1), dtype=torch.int8)
        b = torch.zeros((MAX_K_INT8 + 1, 1), dtype=torch.int8)
    with pytest.raises(ValueError):
        ops.trim_matmul(a, b, policy=policy)
