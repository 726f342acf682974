"""The port's int64 requant is bit-identical to the JAX package's
int32-only ``requant_mult_shift`` and its int64 oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import requant as jrq
from repro_torch.kernels import requant as trq

I32 = np.iinfo(np.int32)


def _accs(rng, n=256):
    edge = np.array([I32.min, I32.min + 1, -(1 << 24), -65536, -65535, -1,
                     0, 1, 255, 65535, 65536, 1 << 24, I32.max - 1, I32.max],
                    np.int64)
    rand = rng.integers(I32.min, I32.max, n, dtype=np.int64, endpoint=True)
    small = rng.integers(-(1 << 20), 1 << 20, n, dtype=np.int64)
    return np.concatenate([edge, rand, small]).astype(np.int32)


@pytest.mark.parametrize("shifts", [range(1, 17), range(17, 32)],
                         ids=["s<=16", "s>=17"])
def test_requant_matches_jax_and_int64_oracle(shifts):
    rng = np.random.default_rng(len(shifts))
    acc = _accs(rng)[:, None, None]
    m = np.concatenate([[1, 2, 16384, 32767],
                        rng.integers(1, 32768, 12)]).astype(np.int32)
    s = np.asarray(list(shifts), np.int32)
    m_b, s_b = m[None, :, None], s[None, None, :]
    got = trq.requant_mult_shift(torch.from_numpy(acc), torch.from_numpy(m_b),
                                 torch.from_numpy(s_b)).numpy()
    want = np.asarray(jrq.requant_mult_shift(jnp.asarray(acc),
                                             jnp.asarray(m_b),
                                             jnp.asarray(s_b)))
    oracle = jrq.requant_ref_int64(acc, m_b, s_b)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


def test_requant_per_channel_broadcast():
    rng = np.random.default_rng(3)
    F = 7
    acc = rng.integers(-(1 << 26), 1 << 26, (2, 3, 4, F)).astype(np.int32)
    m = rng.integers(1, 32768, F).astype(np.int32)
    s = rng.integers(1, 32, F).astype(np.int32)
    got = trq.requant_mult_shift(torch.from_numpy(acc), torch.from_numpy(m),
                                 torch.from_numpy(s)).numpy()
    want = np.asarray(jrq.requant_mult_shift(jnp.asarray(acc), m, s))
    np.testing.assert_array_equal(got, want)
    # scalar pair broadcasts the same way
    got1 = trq.requant_mult_shift(torch.from_numpy(acc), 12345, 20).numpy()
    np.testing.assert_array_equal(
        got1, jrq.requant_ref_int64(acc, 12345, 20))


def test_scale_to_mult_shift_equal_in_both_packages():
    rng = np.random.default_rng(5)
    scales = np.concatenate([2.0 ** rng.uniform(-45, 10, 500),
                             [1e-30, 2.0 ** -31, 1.0, 255.0, 0.99999]])
    for sc in (scales, 0.0123, 255.0):
        tm, ts = trq.scale_to_mult_shift(sc)
        jm, js = jrq.scale_to_mult_shift(sc)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ts, js)
        assert tm.dtype == jm.dtype and ts.dtype == js.dtype
