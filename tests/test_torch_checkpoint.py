"""The port's checkpoints (``repro_torch/checkpoint/manager.py``) against
the JAX package's (``repro/checkpoint/manager.py``), on the CPU.

The two write the same format: a manifest of each leaf's path, file,
shape and dtype, one ``.npy`` a leaf named by its path's hash, bf16 as
its uint16 bits, and ``COMMITTED`` last.  So a checkpoint written by
either package restores in the other, bit for bit (bf16 included), and
the port writes the very bytes the JAX package writes for the same tree.
Also: torn checkpoints are skipped, ``keep_last`` retention, the async
writer's snapshot, restore onto the template's dtype, and the refusals
of a missing leaf or a wrong shape.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jax_ckpt
from repro.configs import get_smoke as jax_get_smoke
from repro.distributed import make_train_state as jax_make_train_state
from repro.nn.models import build_model as jax_build_model
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.distributed import make_train_state
from repro_torch.nn.models import build_model
from repro_torch.weights import from_jax_params, to_numpy


def _tree(seed=0):
    """A small state-like tree: fp32, bf16, int32 and 0-dim leaves under
    dicts and a list."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "emb": torch.randn(5, 2, generator=g).to(
                           torch.bfloat16),
                       "layers": [{"b": torch.randn(4, generator=g)},
                                  {"b": torch.randn(4, generator=g)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3)}}


def _bits(t: torch.Tensor) -> np.ndarray:
    return to_numpy(t)


def _assert_trees_equal(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=p)


def _jax_tree(tree):
    """The same tree as the JAX package holds it (bf16 as ml_dtypes)."""
    def one(t):
        a = to_numpy(t)
        return a.view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else a
    return jax.tree_util.tree_map(jnp.asarray, _map(one, tree))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def test_round_trip_is_bit_exact(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path / "c"))
    template = _tree(seed=1)
    _assert_trees_equal(restore_pytree(template, str(tmp_path / "c")), tree)
    names = sorted(os.listdir(tmp_path / "c"))
    assert "COMMITTED" in names and "manifest.json" in names
    assert len([n for n in names if n.startswith("leaf_")]) == 6


def test_the_port_writes_what_the_jax_package_writes(tmp_path):
    """Same manifest and the same .npy bytes, leaf for leaf."""
    tree = _tree()
    save_pytree(tree, str(tmp_path / "port"))
    jax_ckpt.save_pytree(_jax_tree(tree), str(tmp_path / "jax"))
    for name in sorted(os.listdir(tmp_path / "jax")):
        a = (tmp_path / "port" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        if name == "manifest.json":
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_jax_reads_the_ports_checkpoint(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path / "c"))
    got = jax_ckpt.restore_pytree(_jax_tree(_tree(seed=2)),
                                  str(tmp_path / "c"))
    for (p, a), (_, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(tree)):
        a = np.asarray(a)
        if b.dtype == torch.bfloat16:
            assert a.dtype == ml_dtypes.bfloat16, p
            a = a.view(np.uint16)
        np.testing.assert_array_equal(a, _bits(b), err_msg=p)


def test_the_port_reads_the_jax_packages_checkpoint(tmp_path):
    tree = _tree()
    jax_ckpt.save_pytree(_jax_tree(tree), str(tmp_path / "c"))
    _assert_trees_equal(restore_pytree(_tree(seed=3), str(tmp_path / "c")),
                        tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lm_train_state_crosses_both_ways(tmp_path, writer):
    """granite-3-2b's smoke train state in bf16 (bf16 params, fp32 AdamW
    moments, the int32 count): written by one package, restored by the
    other into a state from another seed."""
    arch = "granite-3-2b"
    model_j = jax_build_model(jax_get_smoke(arch, dtype=jnp.bfloat16))
    state_j = jax_make_train_state(model_j, jax.random.PRNGKey(0))
    model = build_model(get_smoke(arch, dtype=torch.bfloat16))
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, state_j),
                            "cpu")
    d = str(tmp_path / "c")
    if writer == "jax":
        jax_ckpt.save_pytree(state_j, d)
        got = restore_pytree(make_train_state(model, 1, "cpu"), d)
        _assert_trees_equal(got, state)
    else:
        save_pytree(state, d)
        other = jax_make_train_state(model_j, jax.random.PRNGKey(1))
        got = jax_ckpt.restore_pytree(other, d)
        _assert_trees_equal(from_jax_params(
            jax.tree_util.tree_map(np.asarray, got), "cpu"), state)


def test_torn_checkpoints_are_skipped(tmp_path):
    base = str(tmp_path)
    mgr = CheckpointManager(base, keep_last=5)
    mgr.save(_tree(0), 2)
    mgr.wait()
    # a torn step 4: files written, no COMMITTED marker
    save_pytree(_tree(1), os.path.join(base, "step_4"))
    os.remove(os.path.join(base, "step_4", "COMMITTED"))
    os.makedirs(os.path.join(base, "step_6"))        # an empty one
    assert latest_step(base) == 2
    step, got = mgr.restore_latest(_tree(9))
    assert step == 2
    _assert_trees_equal(got, _tree(0))
    assert latest_step(str(tmp_path / "none")) is None
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        "template") == (None, "template")


def test_keep_last_and_the_async_snapshot(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = _tree()
    for step in (1, 2, 3, 4):
        mgr.save(tree, step)
        # the snapshot was taken at save(): a later in-place change is
        # not in the checkpoint
        tree["params"]["w"].add_(1.0)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    got = restore_pytree(_tree(5), str(tmp_path / "step_4"))
    want = _tree()
    for _ in range(3):                  # the three updates before step 4
        want["params"]["w"].add_(1.0)
    _assert_trees_equal(got, want)


def test_restore_takes_the_templates_dtype_and_refuses_mismatches(tmp_path):
    tree = _tree()
    d = str(tmp_path / "c")
    save_pytree(tree, d)
    template = _tree()
    template["params"]["emb"] = template["params"]["emb"].float()
    got = restore_pytree(template, d)
    assert got["params"]["emb"].dtype == torch.float32
    assert torch.equal(got["params"]["emb"], tree["params"]["emb"].float())
    bad = _tree()
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="params/w"):
        restore_pytree(bad, d)
    extra = _tree()
    extra["params"]["new"] = torch.zeros(1)
    with pytest.raises(KeyError, match="params/new"):
        restore_pytree(extra, d)
