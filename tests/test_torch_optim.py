"""The port's AdamW and schedules against the JAX package's, on the CPU.

A small param tree with ``conv/i/{kernel,bias}`` and ``fc/i/{kernel,
bias}`` paths (so weight decay skips the biases by path) and gradients
large enough that clipping is active.  fp32 both sides, within rtol 1e-6
(the same operations in the same order; ``b ** step`` and the square
roots may round differently by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import schedules as jax_sched
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, global_norm,
                               warmup_cosine, warmup_linear)
from repro_torch.weights import from_jax_params, to_numpy

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"conv": [((3, 3, 2, 4), (4,)), ((3, 3, 4, 4), (4,))],
          "fc": [((16, 5), (5,))]}


def _tree(rng, scale=1.0):
    return {part: [{"kernel": (rng.standard_normal(k) * scale)
                    .astype(np.float32),
                    "bias": (rng.standard_normal(b) * scale)
                    .astype(np.float32)} for k, b in layers]
            for part, layers in SHAPES.items()}


def _close(got, want):
    leaves_g = jax.tree_util.tree_leaves(to_numpy(got))
    leaves_w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                                want))
    assert len(leaves_g) == len(leaves_w)
    for a, e in zip(leaves_g, leaves_w):
        np.testing.assert_allclose(a, e, **TOL)


def test_paths_match_jax_path_strings():
    tree = _tree(np.random.default_rng(0))
    want = [jax_adamw._path_str(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(tree)]
    assert [p for p, _ in tree_leaves_with_path(tree)] == want
    assert "conv/0/bias" in want and "fc/0/kernel" in want


def test_global_norm_and_clip_match_jax():
    tree = _tree(np.random.default_rng(1), scale=3.0)
    t = from_jax_params(tree, device="cpu")
    np.testing.assert_allclose(float(global_norm(t)),
                               float(jax_adamw.global_norm(tree)), **TOL)
    clipped, norm = clip_by_global_norm(t, 1.0)
    jclipped, jnorm = jax_adamw.clip_by_global_norm(tree, 1.0)
    assert float(norm) > 1.0          # clipping is active
    np.testing.assert_allclose(float(norm), float(jnorm), **TOL)
    _close(clipped, jclipped)


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_steps_match_jax(weight_decay):
    """Three consecutive updates from the same state, each with fresh
    gradients and the warmup-cosine lr of its step."""
    rng = np.random.default_rng(2)
    cfg = AdamWConfig(weight_decay=weight_decay)
    jcfg = jax_adamw.AdamWConfig(weight_decay=weight_decay)
    jparams = _tree(rng)
    jopt = jax_adamw.adamw_init(jparams)
    params = from_jax_params(jparams, device="cpu")
    opt = adamw_init(params)
    assert opt["step"].dtype == torch.int32 and opt["step"].dim() == 0
    for step in range(3):
        grads = _tree(rng, scale=4.0)
        lr = warmup_cosine(opt["step"], peak_lr=1e-2, warmup_steps=2,
                           total_steps=10)
        jlr = jax_sched.warmup_cosine(jopt["step"], peak_lr=1e-2,
                                      warmup_steps=2, total_steps=10)
        np.testing.assert_allclose(float(lr), float(jlr), **TOL)
        params, opt, mets = adamw_update(
            from_jax_params(grads, device="cpu"), opt, params, lr, cfg)
        jparams, jopt, jmets = jax_adamw.adamw_update(grads, jopt, jparams,
                                                      jlr, jcfg)
        assert int(opt["step"]) == int(jopt["step"]) == step + 1
        _close(params, jparams)
        _close(opt["m"], jopt["m"])
        _close(opt["v"], jopt["v"])
        for k in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(float(mets[k]), float(jmets[k]), **TOL)
        assert float(mets["grad_norm"]) > cfg.clip_norm


def test_biases_are_not_decayed():
    """With zero gradients only the decayed leaves move: the kernels, by
    path; every ``bias`` path stays put."""
    params = from_jax_params(_tree(np.random.default_rng(3)), device="cpu")
    zeros = {part: [{k: torch.zeros_like(v) for k, v in layer.items()}
                    for layer in layers] for part, layers in params.items()}
    new, _, _ = adamw_update(zeros, adamw_init(params), params, 0.5)
    for (path, a), (_, b) in zip(tree_leaves_with_path(new),
                                 tree_leaves_with_path(params)):
        assert torch.equal(a, b) == path.endswith("bias"), path


@pytest.mark.parametrize("fn", ["warmup_cosine", "warmup_linear"])
def test_schedules_match_jax(fn):
    port, ref = {"warmup_cosine": (warmup_cosine, jax_sched.warmup_cosine),
                 "warmup_linear": (warmup_linear, jax_sched.warmup_linear)}[fn]
    kw = dict(peak_lr=3e-4, warmup_steps=7, total_steps=40)
    for step in (0, 1, 6, 7, 8, 20, 39, 40, 55):
        want = float(ref(jnp.asarray(step, jnp.int32), **kw))
        np.testing.assert_allclose(
            float(port(torch.tensor(step, dtype=torch.int32), **kw)), want,
            **TOL)
        np.testing.assert_allclose(float(port(step, **kw)), want, **TOL)
