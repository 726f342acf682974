"""The port's SSD scan against the JAX package's, on the CPU.

``trim_ssd_plain`` (the CUDA kernel's plain version, which the wrapper
``trim_ssd`` takes for a CPU tensor) and the oracle ``ref.ssd_ref`` are
held against the Pallas kernel ``trim_ssd_pallas`` in interpret mode and
against JAX's ``ssd_ref``, on the same inputs made from a numpy seed in
the ranges of ``tests/test_ssd_kernel.py``: fp32 within 2e-5 on its
``CASES``, 5e-5 across chunkings (chunking is math-neutral), bf16 x/B/C
within 5e-2 of the fp32 oracle -- that file's tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.trim_ssd import ssd_ref as jax_ssd_ref
from repro.kernels.trim_ssd import trim_ssd_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.trim_ssd import trim_ssd, trim_ssd_plain
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
