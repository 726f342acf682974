"""The port's MoE (``repro_torch/nn/moe.py``) against the JAX package's
(``repro/nn/moe.py``), on the CPU in fp32, with JAX's parameters carried
by ``from_jax_params``:

- both dispatch arms against JAX's ``moe`` at ``tests/test_layers.py``'s
  (k, cf) grid (k 1-3, cf 0.5, 1, 1.25, 4; two seeds): output within
  rtol 1e-4 / atol 1e-5 (its gather-vs-einsum tolerance), the aux loss
  within rtol 1e-6;
- the gather arm equal to the einsum arm on the port alone (JAX's
  ``test_moe_gather_equals_einsum``), and the slots both drop counted
  alike (``moe.DROPPED``);
- ``shared_expert`` and ``dense_residual`` against JAX;
- gradients through both arms: finite, nonzero, and each leaf within a
  relative norm error of 1e-4 of ``jax.grad``'s;
- the parameter tree's paths and shapes equal to ``init_moe``'s, and the
  combine bit-equal over calls (no atomic float sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.moe import init_moe as jax_init_moe
from repro.nn.moe import moe as jax_moe
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.nn import moe as tmoe
from repro_torch.weights import from_jax_params

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
KS = [1, 2, 3]
CFS = [0.5, 1.0, 1.25, 4.0]


def _inputs(seed, d=16, ff=32, E=4, B=2, S=12, **kw):
    key = jax.random.PRNGKey(seed)
    p = jax_init_moe(key, d, ff, E, **kw)
    x = np.array(jax.random.normal(jax.random.fold_in(key, 1), (B, S, d)))
    return p, x


def _rel(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_matches_jax(impl, k, cf, seed):
    p_j, x = _inputs(seed)
    want, aux_j = jax_moe(p_j, jnp.asarray(x), top_k=k, capacity_factor=cf,
                          impl=impl)
    got, aux = tmoe.moe(from_jax_params(p_j, "cpu"), torch.from_numpy(x),
                        top_k=k, capacity_factor=cf, impl=impl)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("k", KS)
def test_moe_gather_equals_einsum(k, cf):
    """The sort/gather dispatch and the GShard one-hot reference route and
    drop alike: the same output, the same slots dropped."""
    p_j, x = _inputs(k * 10 + int(cf * 4))
    p, xt = from_jax_params(p_j, "cpu"), torch.from_numpy(x)
    out, dropped = {}, {}
    for impl in ("einsum", "gather"):
        tmoe.DROPPED = []
        try:
            out[impl], _ = tmoe.moe(p, xt, top_k=k, capacity_factor=cf,
                                    impl=impl)
            dropped[impl] = [int(t) for t in tmoe.DROPPED]
        finally:
            tmoe.DROPPED = None
    np.testing.assert_allclose(out["gather"].numpy(), out["einsum"].numpy(),
                               **OUT_TOL)
    assert dropped["gather"] == dropped["einsum"] and len(dropped["gather"]) \
        == 1
    cap = max(1, int(12 * k * cf / 4))
    assert 0 <= dropped["gather"][0] <= 2 * 12 * k
    if cap * 4 >= 12 * k and cf >= 4.0:
        assert dropped["gather"][0] == 0


@pytest.mark.parametrize("variant", ["shared_expert", "dense_residual"])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_variants_match_jax(impl, variant):
    kw = ({"shared_expert": True} if variant == "shared_expert"
          else {"dense_residual": True, "dense_ff": 24})
    p_j, x = _inputs(5, mlp_kind="swiglu", **kw)
    want, aux_j = jax_moe(p_j, jnp.asarray(x), top_k=2, impl=impl)
    p = from_jax_params(p_j, "cpu")
    assert variant.replace("dense_residual", "dense_mlp") in p
    got, aux = tmoe.moe(p, torch.from_numpy(x), top_k=2, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu"])
def test_moe_mlp_kinds_match_jax(mlp_kind):
    p_j, x = _inputs(11, mlp_kind=mlp_kind, shared_expert=True)
    want, _ = jax_moe(p_j, jnp.asarray(x), top_k=2, mlp_kind=mlp_kind,
                      impl="gather")
    got, _ = tmoe.moe(from_jax_params(p_j, "cpu"), torch.from_numpy(x),
                      top_k=2, mlp_kind=mlp_kind, impl="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_gradients_flow_both_impls(impl):
    """JAX's ``test_moe_gradients_flow_both_impls`` on the port, and each
    leaf's gradient against ``jax.grad``'s."""
    key = jax.random.PRNGKey(0)
    p_j = jax_init_moe(key, 8, 16, 4, shared_expert=True)
    x = np.array(jax.random.normal(key, (2, 8, 8)))
    g_j = jax.grad(lambda pp: jax_moe(pp, jnp.asarray(x), top_k=2,
                                      impl=impl)[0].sum())(p_j)
    p = from_jax_params(p_j, "cpu")
    live = [t.requires_grad_(True) for t in tree_leaves(p)]
    out, _ = tmoe.moe(p, torch.from_numpy(x), top_k=2, impl=impl)
    grads = torch.autograd.grad(out.sum(), live)
    total = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(total) and total > 0
    for (path, gj), g in zip(tree_leaves_with_path(g_j), grads):
        assert _rel(g.numpy(), np.asarray(gj)) <= 1e-4, path


def test_init_moe_tree_matches_jax():
    p_j = jax_init_moe(jax.random.PRNGKey(0), 16, 24, 4, shared_expert=True,
                       dense_residual=True, dense_ff=40,
                       dtype=jnp.bfloat16)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), 16, 24, 4,
                      shared_expert=True, dense_residual=True, dense_ff=40,
                      dtype=torch.bfloat16)
    assert [(q, tuple(t.shape), str(t.dtype)) for q, t in
            tree_leaves_with_path(p)] == \
        [(q, tuple(a.shape), "torch.bfloat16") for q, a in
         tree_leaves_with_path(p_j)]
    w = p["experts"]["w_down"].float()
    assert 0.5 < float(w.std()) * 24 ** 0.5 < 1.5   # std ff ** -0.5
    meta = tmoe.init_moe(torch.Generator().manual_seed(0), 16, 24, 4,
                         device="meta")
    assert meta["experts"]["w_gate"].device.type == "meta"


@pytest.mark.parametrize("k", [1, 2])
def test_gather_combine_same_bits_over_calls(k):
    """The combine puts rows back by a collision-free scatter and sums the
    rounds in order: two calls give the same bits."""
    p_j, x = _inputs(3, B=3, S=16)
    p, xt = from_jax_params(p_j, "cpu"), torch.from_numpy(x)
    a, _ = tmoe.moe(p, xt, top_k=k, impl="gather")
    b, _ = tmoe.moe(p, xt, top_k=k, impl="gather")
    assert torch.equal(a, b)


def test_unknown_impl_raises():
    p_j, x = _inputs(0)
    with pytest.raises(ValueError, match="einsum or gather"):
        tmoe.moe(from_jax_params(p_j, "cpu"), torch.from_numpy(x), top_k=1,
                 impl="dense")
