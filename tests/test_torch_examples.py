"""The port's examples (``examples/torch/``) on the CPU.

Each runs as a script with ``--device cpu`` in a subprocess of its own,
exits 0 and prints its lines (serve_lm on its ``--smoke`` config, the
trainers with fewer steps than their defaults; ``train_lm`` twice, the
second run resuming from the first's checkpoint); asked for the card where there is none, each exits non-zero
with a message.  Their functions are held against the JAX package:
quickstart's paper numbers against ``repro.core.trim``, serve_lm's greedy
continuation on the JAX model's params (``repro_torch.weights``) against
the JAX model's own, train_cnn's first loss on the JAX params within 1e-5
of ``repro``'s plan loss, and its loss falls.
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """torch's CPU ``exp`` can be off on the first multithreaded call of a
    process (torch 2.13 on AVX-512; ``tools/torch_exp_first_call.py``); one
    call first keeps that library fault out of the comparisons with JAX."""
    torch.exp(torch.zeros(1 << 16))


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, *args: str, timeout: int = 120):
    # two threads a child: the test workers already share the cores
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"),
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


# (example, its arguments past --device cpu, lines its output must hold)
RUNS = [
    ("quickstart", [], ["=== 1. TrIM dataflow", "fifo_ok=True",
                        "bit-exact=True", "=== 2. TrIM conv kernel (cpu)",
                        "train step: loss=", "greedy decode:",
                        "(int5, exactly 5/8)"]),
    ("serve_lm", ["--smoke"], [
        "[serve] mamba2-130m-smoke on cpu: prefill 4x32",
        "[serve] kernel launches in the prefill: conv1d 0, flash 0",
        "[serve] continuation[0]:"]),
    ("train_cnn", ["--steps", "8"], ["step   0  loss", "step   7  loss",
                                     "kernel launches in training: conv 0",
                                     "int8 TrIM datapath: output (16,",
                                     "float/int8 agreement: cosine"]),
]


@pytest.mark.parametrize("name,args,lines", RUNS, ids=[r[0] for r in RUNS])
def test_example_runs_on_the_cpu(name, args, lines):
    proc = _run(name, "--device", "cpu", *args)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for line in lines:
        assert line in proc.stdout, (line, proc.stdout)


def test_train_lm_runs_and_resumes_on_the_cpu(tmp_path):
    args = ("--device", "cpu", "--batch", "4", "--seq", "32", "--ckpt-dir",
            str(tmp_path))
    first = _run("train_lm", "--steps", "3", *args)
    assert first.returncode == 0, first.stdout + first.stderr
    assert "[train_lm] mamba2-15m-demo:" in first.stdout
    assert "over 3 steps; conv1d kernel launches 0" in first.stdout
    again = _run("train_lm", "--steps", "5", *args)
    assert again.returncode == 0, again.stdout + again.stderr
    assert "[trainer] resumed from step 3" in again.stdout
    assert "over 2 steps (resumed from 3)" in again.stdout


@pytest.mark.parametrize("name", ["quickstart", "serve_lm", "train_cnn",
                                  "train_lm"])
def test_example_asked_for_the_card_without_one_exits_nonzero(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = _run(name)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr


def test_quickstart_paper_numbers_equal_jax():
    from repro.core.trim.engine import TrimEngine, reference_conv_layer
    from repro.core.trim.model import (PAPER_ENGINE, VGG16_LAYERS,
                                       network_gops, trim_memory_accesses)
    from repro.core.trim.slice_sim import padding_overhead, simulate_slice

    qs = _example("quickstart")
    got = qs.demo_trim_dataflow()
    rng = np.random.default_rng(0)
    r = simulate_slice(rng.integers(0, 256, (12, 12)).astype(np.int64),
                       rng.integers(-8, 8, (3, 3)))
    xs = rng.integers(0, 256, (8, 14, 14), dtype=np.uint8)
    ws = rng.integers(-128, 128, (4, 8, 3, 3)).astype(np.int8)
    out, trace = TrimEngine().run_layer(xs, ws)
    assert got == {
        "fetches": r.external_fetches, "fifo_ok": r.fifo_order_ok,
        "overhead": padding_overhead(224, 224, 3),
        "bit_exact": bool((out == reference_conv_layer(xs, ws)).all()),
        "steps": trace.steps, "psum_accesses": trace.psum_buffer_accesses,
        "peak_gops": PAPER_ENGINE.peak_gops,
        "vgg16_gops": network_gops(VGG16_LAYERS)}
    int5 = qs.demo_int5()
    l = VGG16_LAYERS[0]
    want = (trim_memory_accesses(l, PAPER_ENGINE).weight_reads,
            trim_memory_accesses(l, PAPER_ENGINE, weight_bits=5).weight_reads)
    assert int5["weight_reads"] == want
    assert int5["ratio"] == 5 / 8
    assert int5["max_err"] <= 7 and int5["packed_bytes"] == 720


def test_quickstart_kernel_and_lm_parts_on_the_cpu():
    qs = _example("quickstart")
    k = qs.demo_kernel(CPU)
    assert k["shape"] == (1, 16, 16, 16) and k["max_err"] < 1e-5
    assert k["launches"] == 0          # the plain version on a CPU tensor
    lm = qs.demo_lm(CPU)
    assert np.isfinite(lm["loss"]) and len(lm["greedy"]) == 5


@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-3-2b"])
def test_serve_lm_greedy_continuation_equals_jax(arch):
    from repro.configs import get_smoke as jax_smoke
    from repro.nn.models import build_model as jax_build
    from repro_torch.configs import get_smoke
    from repro_torch.nn.models import build_model
    from repro_torch.weights import from_jax_params

    B, S, gen = 2, 8, 6
    cfg_j = jax_smoke(arch).with_overrides(dtype=jnp.float32)
    model_j = jax_build(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(3).integers(0, cfg_j.vocab, (B, S))
    cache = model_j.init_cache(B, S + gen, dtype=jnp.float32)
    logits, cache = model_j.prefill(params_j, jnp.asarray(prompts, jnp.int32),
                                    cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, cache = model_j.decode_step(params_j, tok, cache,
                                            jnp.int32(S + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], 1)

    sl = _example("serve_lm")
    model = build_model(get_smoke(arch).with_overrides(dtype=torch.float32))
    got, _, _, finite, launches = sl.generate(
        model, from_jax_params(params_j, "cpu"), prompts, gen, CPU)
    assert finite and launches == {"conv1d": 0, "flash": 0}
    np.testing.assert_array_equal(got, want)


def test_train_cnn_first_loss_equals_jax_and_falls():
    from repro.configs import CNN_SMOKES as JAX_CNN_SMOKES
    from repro.data import SyntheticImageDataset as JaxImages
    from repro.engine import ExecutionPolicy as JaxPolicy
    from repro.engine import plan_model as jax_plan_model
    from repro_torch.configs import CNN_SMOKES
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.engine import ExecutionPolicy, plan_model
    from repro_torch.weights import from_jax_params

    cfg_j = JAX_CNN_SMOKES["vgg16"]
    plan_j = jax_plan_model(cfg_j, JaxPolicy())
    params_j = plan_j.init(jax.random.PRNGKey(0))
    kw = dict(hw=cfg_j.input_hw, channels=cfg_j.layers[0].M,
              n_classes=cfg_j.n_classes, global_batch=16)
    b = JaxImages(**kw).batch_at(0)
    want, _ = plan_j.loss(params_j, {"images": jnp.asarray(b["images"]),
                                     "labels": jnp.asarray(b["labels"])})

    tc = _example("train_cnn")
    plan = plan_model(CNN_SMOKES["vgg16"], ExecutionPolicy())
    params, losses = tc.train(plan, from_jax_params(params_j, "cpu"),
                              SyntheticImageDataset(**kw), 6, 3e-3, CPU,
                              log=lambda *a: None)
    assert abs(losses[0] - float(want)) <= 1e-5, (losses[0], float(want))
    assert losses[-1] < losses[0]
    feat, cos = tc.int8_agreement(plan, params,
                                  SyntheticImageDataset(**kw).batch_at(0)[
                                      "images"], CPU)
    assert feat.dtype == torch.int32 and 0.0 < cos <= 1.0 + 1e-9
