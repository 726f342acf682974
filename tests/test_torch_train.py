"""The port's training path against the JAX package's, on the CPU.

Three steps of the port's ``make_train_step`` against the JAX
``make_train_step`` (jitted, no mesh) on vgg16-smoke, from the JAX init
carried across by ``from_jax_params``, on the same seeded batches: losses
per step and params after the last step within rtol = atol = 1e-4.  On
the port's kernel substrate every conv gradient runs through
``TrimConv2dFn`` (the kernels' plain versions on the CPU); the oracle
substrate runs plain autograd.  Also: gradient accumulation, the
non-finite step skip, the loop and its resume from a checkpoint, and the
launcher (both arms, ``--ckpt-dir`` resume on the CPU, the refusals of
the distributed flags).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import CNN_SMOKES as JAX_SMOKES
from repro.data.pipeline import SyntheticImageDataset as JaxDataset
from repro.distributed import StepConfig as JaxStepConfig
from repro.distributed import make_train_state as jax_make_train_state
from repro.distributed import make_train_step as jax_make_train_step
from repro.distributed.trainer import StragglerMonitor as JaxMonitor
from repro.engine import plan_model as jax_plan_model
from repro_torch.configs import CNN_SMOKES
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import SyntheticImageDataset
from repro_torch.distributed import (StepConfig, StragglerMonitor,
                                     TrainLoopConfig, make_train_state,
                                     make_train_step, train_loop)
from repro_torch.engine import ExecutionPolicy, plan_model
from repro_torch.weights import from_jax_params, to_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
CFG = CNN_SMOKES["vgg16"]
STEPS = 3


def _dataset(cls, batch=4, seed=0):
    return cls(hw=CFG.input_hw, channels=CFG.layers[0].M,
               n_classes=CFG.n_classes, global_batch=batch, seed=seed)


def _scfg(cls, accum=1):
    return cls(peak_lr=1e-3, warmup_steps=5, total_steps=STEPS, accum=accum)


_JAX_RUNS = {}


def _jax_run(accum):
    """(initial state, losses, final state) of the JAX step, as numpy."""
    if accum not in _JAX_RUNS:
        model = jax_plan_model(JAX_SMOKES["vgg16"])
        state = jax_make_train_state(model, jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.asarray, state)
        step = jax.jit(jax_make_train_step(model, _scfg(JaxStepConfig,
                                                        accum)))
        ds = _dataset(JaxDataset)
        losses = []
        for i in range(STEPS):
            state, mets = step(state, ds.batch_at(i))
            losses.append(float(mets["loss"]))
        _JAX_RUNS[accum] = (init, losses,
                            jax.tree_util.tree_map(np.asarray, state))
    return _JAX_RUNS[accum]


def _port_run(accum, substrate):
    init, _, _ = _jax_run(accum)
    plan = plan_model(CFG, ExecutionPolicy(substrate))
    state = from_jax_params(init, device="cpu")
    step = make_train_step(plan, _scfg(StepConfig, accum))
    ds = _dataset(SyntheticImageDataset)
    losses = []
    for i in range(STEPS):
        state, mets = step(state, ds.batch_at(i))
        losses.append(float(mets["loss"]))
    return losses, state


def _assert_state_close(got, want):
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, e in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == e.shape and a.dtype == e.dtype
        np.testing.assert_allclose(a, e, **TOL)


def test_dataset_matches_jax_bit_for_bit():
    for seed, batch in ((0, 4), (3, 5)):
        port, ref = _dataset(SyntheticImageDataset, batch, seed), \
            _dataset(JaxDataset, batch, seed)
        for step in (0, 1, 7):
            a, b = port.batch_at(step), ref.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("substrate", ["kernel", "oracle"])
def test_train_steps_match_jax(substrate):
    _, want_losses, want_state = _jax_run(1)
    losses, state = _port_run(1, substrate)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    _assert_state_close(state, want_state)


def test_grad_accumulation_matches_jax():
    _, want_losses, want_state = _jax_run(2)
    losses, state = _port_run(2, "kernel")
    np.testing.assert_allclose(losses, want_losses, **TOL)
    _assert_state_close(state, want_state)


def test_nonfinite_batch_leaves_state_unchanged():
    plan = plan_model(CFG, ExecutionPolicy("kernel"))
    state = make_train_state(plan, 0, "cpu")
    before = to_numpy(state)
    batch = _dataset(SyntheticImageDataset).batch_at(0)
    batch["images"][0, 0, 0, 0] = np.nan
    new, mets = make_train_step(plan, _scfg(StepConfig))(state, batch)
    assert float(mets["skipped"]) == 1.0
    assert not np.isfinite(float(mets["loss"]))
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(new)),
                    jax.tree_util.tree_leaves(before)):
        np.testing.assert_array_equal(a, b)
    # the step is pure: the state it was given is untouched too
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(state)),
                    jax.tree_util.tree_leaves(before)):
        np.testing.assert_array_equal(a, b)


def test_train_state_round_trips_through_numpy():
    init, _, _ = _jax_run(1)
    state = from_jax_params(init, device="cpu")
    assert state["opt"]["step"].dim() == 0
    assert state["opt"]["step"].dtype == torch.int32
    back = to_numpy(state)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(init)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_loop_and_straggler_monitor():
    plan = plan_model(CFG, ExecutionPolicy("kernel"))
    out = train_loop(make_train_step(plan, _scfg(StepConfig)),
                     make_train_state(plan, 0, "cpu"),
                     _dataset(SyntheticImageDataset),
                     TrainLoopConfig(total_steps=STEPS), log_fn=lambda _: None)
    hist = out["history"]
    assert [h["step"] for h in hist] == list(range(STEPS))
    for h in hist:
        assert {"loss", "lr", "ce", "acc", "grad_norm", "param_norm",
                "skipped", "dt_s"} <= h.keys()
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
    # the monitor flags the same steps as the JAX package's
    dts = [0.1, 0.11, 0.1, 0.09, 0.1, 0.1, 0.5, 0.1, 0.1, 0.3, 0.1]
    port, ref = StragglerMonitor(), JaxMonitor()
    assert [port.observe(i, d) for i, d in enumerate(dts)] == \
        [ref.observe(i, d) for i, d in enumerate(dts)]
    assert port.flagged == ref.flagged and any(port.flagged)


def test_unported_options_raise():
    """``compress_grads`` without a mesh is the plain step, as in the JAX
    package (the int8 reduction is a mesh's): the same state and metrics
    bit for bit; a mesh that is not a ``DeviceMesh`` is refused (the mesh
    arm itself: ``tests/test_torch_distributed.py``)."""
    plan = plan_model(CFG, ExecutionPolicy())
    state = make_train_state(plan, 0, "cpu")
    batch = _dataset(SyntheticImageDataset).batch_at(0)
    s1, m1 = make_train_step(plan, _scfg(StepConfig))(state, batch)
    s2, m2 = make_train_step(plan, dataclasses.replace(
        _scfg(StepConfig), compress_grads=True))(state, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(tree_leaves(s1), tree_leaves(s2)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(plan, StepConfig(), mesh=object())


def test_loop_resumes_from_its_checkpoint(tmp_path):
    """vgg16-smoke: a run saves at step 2; a run from another init
    resumes there and takes the uninterrupted run's steps 2 and 3 (losses
    within rtol 1e-6, the JAX package's resume tolerance)."""
    plan = plan_model(CFG, ExecutionPolicy("kernel"))
    step = make_train_step(plan, _scfg(StepConfig))
    ds = _dataset(SyntheticImageDataset)
    quiet = dict(log_fn=lambda _: None)
    full = train_loop(step, make_train_state(plan, 0, "cpu"), ds,
                      TrainLoopConfig(total_steps=4), **quiet)
    d = str(tmp_path / "ckpt")
    first = train_loop(step, make_train_state(plan, 0, "cpu"), ds,
                       TrainLoopConfig(total_steps=2, ckpt_every=2,
                                       ckpt_dir=d), **quiet)
    assert first["resumed_from"] is None
    resumed = train_loop(step, make_train_state(plan, 1, "cpu"), ds,
                         TrainLoopConfig(total_steps=4, ckpt_dir=d), **quiet)
    assert resumed["resumed_from"] == 2
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    np.testing.assert_allclose([h["loss"] for h in resumed["history"]],
                               [h["loss"] for h in full["history"][2:]],
                               rtol=1e-6)


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)


def test_launcher_trains_on_cpu_and_refuses_a_missing_card(tmp_path):
    smoke = ("--arch", "vgg16", "--smoke", "--steps", "3", "--batch", "4")
    proc = _launch(*smoke, "--device", "cpu", "--int8")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[train] vgg16-smoke on cpu" in proc.stdout
    assert "int8 datapath" in proc.stdout
    # the LM arm, and --ckpt-dir resume on both arms
    lm = ("--arch", "granite-3-2b", "--smoke", "--batch", "4", "--seq", "16",
          "--device", "cpu")
    proc = _launch(*lm, "--steps", "3", "--int8")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[train] granite-3-2b-smoke on cpu: steps 0-2" in proc.stdout
    assert "--int8 ignored: LM arch" in proc.stdout
    for args in (lm, smoke[:-4] + ("--batch", "4", "--device", "cpu")):
        ckpt = ("--ckpt-dir", str(tmp_path / args[1]), "--ckpt-every", "2")
        proc = _launch(*args, "--steps", "2", *ckpt)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert sorted(os.listdir(tmp_path / args[1])) == ["step_2"]
        proc = _launch(*args, "--steps", "3", *ckpt)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "[train] resumed from step 2" in proc.stdout
        assert "on cpu: steps 2-2" in proc.stdout
        assert sorted(os.listdir(tmp_path / args[1])) == ["step_2", "step_3"]
    # the mesh arm alone, at world 1: --compress-grads trains on a (1, 1)
    # gloo mesh; --tp 2 needs a world of 2 or more (torchrun's: the
    # distributed tests) and is refused, as is the encdec arm
    proc = _launch(*smoke, "--device", "cpu", "--compress-grads")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "int8 gradients" in proc.stdout
    for bad, why in ((smoke + ("--device", "cpu", "--tp", "2"),
                      "does not divide the world size 1"),
                     (lm + ("--tp", "2"), "does not divide the world size 1"),
                     (("--arch", "seamless-m4t-large-v2", "--smoke",
                       "--device", "cpu"), "not ported")):
        proc = _launch(*bad)
        assert proc.returncode == 2 and why in proc.stderr
    if torch.cuda.is_available():
        return                      # a card is present: cuda is usable
    proc = _launch(*smoke)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
