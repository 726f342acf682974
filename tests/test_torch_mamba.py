"""The port's Mamba2 mixer against the JAX package's, on the CPU.

The SSD pieces (``_segsum``, ``ssd_chunked`` with a ragged last chunk,
with and without an initial state, one and two B/C groups, and
``ssd_decode_step``) within rtol = atol = 1e-5; the whole mixer in its
train, prefill (output and cache) and decode modes on JAX's
``init_mamba`` weights (carried by ``from_jax_params``) within 1e-4.
Inputs come from a numpy seed; fp32 throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import mamba as jm
from repro_torch.nn import mamba as tm
from repro_torch.weights import from_jax_params, to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
MIXER_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_segsum_matches_jax():
    x = np.random.default_rng(0).uniform(-1.0, 0.0, (2, 3, 17)).astype(
        np.float32)
    got = tm._segsum(_t(x)).numpy()
    want = np.asarray(jm._segsum(jnp.asarray(x)))
    assert (got[..., 0, 1:] == tm.NEG_INF).all()
    np.testing.assert_allclose(got, want, **TOL)


def _ssd_inputs(B, L, H, P, G, S, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bm, Cm = f(B, L, H, P), f(B, L, G, S) * 0.5, f(B, L, G, S) * 0.5
    dt = rng.uniform(1e-3, 0.2, (B, L, H)).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32) * 0.5
    D = rng.uniform(0.5, 1.5, H).astype(np.float32)
    h0 = f(B, H, P, S) * 0.1
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.parametrize("L,chunk,G,with_h0", [
    (37, 16, 1, False), (37, 16, 1, True), (40, 8, 2, True),
    (5, 32, 1, False), (64, 32, 2, False)])
def test_ssd_chunked_matches_jax(L, chunk, G, with_h0):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(2, L, 4, 8, G, 6, seed=L + G)
    h0 = h0 if with_h0 else None
    y, h = tm.ssd_chunked(*(map(_t, (x, dt, A, Bm, Cm, D))), chunk=chunk,
                          h0=None if h0 is None else _t(h0))
    yj, hj = jm.ssd_chunked(*(map(jnp.asarray, (x, dt, A, Bm, Cm, D))),
                            chunk=chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_jax(G):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(3, 1, 4, 8, G, 6, seed=11 + G)
    args = (h0, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)
    y, h = tm.ssd_decode_step(*map(_t, args))
    yj, hj = jm.ssd_decode_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **TOL)


def _dims(jax_side: bool):
    mod = jm if jax_side else tm
    return mod.mamba_dims(32, expand=2, headdim=16, d_state=8, n_groups=1,
                          d_conv=4, chunk=8)


@pytest.fixture(scope="module")
def mixer_params():
    pj = jm.init_mamba(jax.random.PRNGKey(3), _dims(True), jnp.float32)
    return pj, from_jax_params(pj, "cpu")


@pytest.mark.parametrize("L", [1, 2, 13, 20])
def test_mixer_train_and_prefill_match_jax(mixer_params, L):
    pj, pt = mixer_params
    u = np.random.default_rng(L).standard_normal((2, L, 32)).astype(
        np.float32)
    out, none = tm.mamba_mixer(pt, _t(u), _dims(False), mode="train")
    outj, _ = jm.mamba_mixer(pj, jnp.asarray(u), _dims(True), mode="train")
    assert none is None
    np.testing.assert_allclose(out.numpy(), np.asarray(outj), **MIXER_TOL)

    cache = tm.init_mamba_cache(2, _dims(False), torch.float32)
    cj = jm.init_mamba_cache(2, _dims(True), jnp.float32)
    out, nc = tm.mamba_mixer(pt, _t(u), _dims(False), mode="prefill",
                             cache=cache)
    outj, ncj = jm.mamba_mixer(pj, jnp.asarray(u), _dims(True),
                               mode="prefill", cache=cj)
    np.testing.assert_allclose(out.numpy(), np.asarray(outj), **MIXER_TOL)
    assert isinstance(nc, tm.MambaCache)
    for a, b in zip(to_numpy(nc), ncj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), **MIXER_TOL)


def test_mixer_decode_matches_jax(mixer_params):
    """Prefill 9 tokens on JAX, then 4 decode steps from the same cache
    on both sides (each fed JAX's state)."""
    pj, pt = mixer_params
    rng = np.random.default_rng(5)
    u = rng.standard_normal((2, 13, 32)).astype(np.float32)
    _, cj = jm.mamba_mixer(pj, jnp.asarray(u[:, :9]), _dims(True),
                           mode="prefill",
                           cache=jm.init_mamba_cache(2, _dims(True)))
    for i in range(9, 13):
        step = u[:, i:i + 1]
        out, nc = tm.mamba_mixer(pt, _t(step), _dims(False), mode="decode",
                                 cache=tm.MambaCache(*map(_t, cj)))
        outj, cj = jm.mamba_mixer(pj, jnp.asarray(step), _dims(True),
                                  mode="decode", cache=cj)
        np.testing.assert_allclose(out.numpy(), np.asarray(outj),
                                   **MIXER_TOL)
        for a, b in zip(to_numpy(nc), cj):
            np.testing.assert_allclose(a, np.asarray(b), **MIXER_TOL)
