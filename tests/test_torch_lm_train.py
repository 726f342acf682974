"""The port's LM training path against the JAX package's, on the CPU.

On the smoke configs of mamba2-130m, granite-3-2b, starcoder2-3b,
gemma-7b, mistral-large-123b (an untied ``lm_head``: the chunked arm
reads it transposed), arctic-480b and llama4-maverick-400b-a17b (the
MoE aux loss in the loss, weight 0.01) and jamba-1.5-large-398b in fp32,
with the JAX weights and train state carried across by
``from_jax_params``:

- both CE arms (``nn/losses.py``) against ``repro.nn.losses``, value and
  gradient, within rtol = 1e-5 / atol = 1e-6 (fp32 reductions in another
  order);
- ``CausalLM.loss`` and each leaf's gradient against
  ``jax.value_and_grad`` of the JAX model, on both ``ce_impl`` arms: the
  loss within rtol 1e-5, each leaf's gradient within a relative norm error
  of 1e-4 (``REL_GRAD``: fp32 sums over 2 layers in another order);
- one ``make_train_step`` from a carried JAX train state against JAX's
  jitted step: params and AdamW moments within rtol = atol = 1e-4 (the
  CNN step's tolerance, ``tests/test_torch_train.py``), the count equal;
- both LM datasets bit-equal to the JAX package's;
- the port's versions of ``tests/test_system.py``'s
  ``test_training_learns_structure`` and ``test_resume_is_exact`` (losses
  of the resumed run within rtol 1e-6 of the uninterrupted run's);
- the conv1d's and the attention's ``autograd.Function``s: on the CPU the
  forward is the plain version, and the gradient equals plain autograd's
  bit for bit; ``CausalLM.loss`` runs through them where the kernel
  substrate is on; the SSD and matmul wrappers refuse a caller that needs
  a gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data.pipeline import FileTokenDataset as JaxFileDataset
from repro.data.pipeline import SyntheticLMDataset as JaxLMDataset
from repro.distributed import StepConfig as JaxStepConfig
from repro.distributed import make_train_state as jax_make_train_state
from repro.distributed import make_train_step as jax_make_train_step
from repro.nn import losses as jax_losses
from repro.nn.models import build_model as jax_build_model
from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.data import FileTokenDataset, SyntheticLMDataset
from repro_torch.distributed import (StepConfig, TrainLoopConfig,
                                     make_train_state, make_train_step,
                                     train_loop)
from repro_torch.engine import ExecutionPolicy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import trim_conv1d as c1
from repro_torch.kernels import trim_matmul, trim_ssd
from repro_torch.nn import losses
from repro_torch.nn.models import build_model
from repro_torch.weights import from_jax_params, to_numpy

ARCHS = ["mamba2-130m", "granite-3-2b", "starcoder2-3b", "gemma-7b",
         "mistral-large-123b", "arctic-480b", "llama4-maverick-400b-a17b",
         "jamba-1.5-large-398b"]
XENT_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
REL_GRAD = 1e-4
STATE_TOL = dict(rtol=1e-4, atol=1e-4)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# -- the two CE arms --------------------------------------------------------

def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 40)).astype(np.float32) * 3
    logits[..., 33:] = -1e30                   # padded vocab entries
    targets = rng.integers(0, 33, (2, 7)).astype(np.int32)
    want, gwant = jax.value_and_grad(jax_losses.softmax_xent)(
        jnp.asarray(logits), jnp.asarray(targets))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = losses.softmax_xent(lt, torch.from_numpy(targets))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **XENT_TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gwant),
                               **XENT_TOL)


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["tied", "transposed"])
def test_chunked_xent_matches_jax(transpose):
    """Vocab 50 padded to 64, in chunks of 16: a chunk with pad columns
    and targets in every chunk; value and the gradients of x and the
    readout."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    table = rng.standard_normal((64, 12)).astype(np.float32) * 0.3
    readout = table.T.copy() if transpose else table
    targets = rng.integers(0, 50, (2, 9)).astype(np.int32)

    def jax_loss(x, r):
        return jax_losses.chunked_softmax_xent(
            x, r, jnp.asarray(targets), 50, chunk=16,
            transpose_readout=transpose)

    want, (gx_w, gr_w) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(readout))
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(readout).requires_grad_(True)
    got = losses.chunked_softmax_xent(xt, rt, torch.from_numpy(targets), 50,
                                      chunk=16, transpose_readout=transpose)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **XENT_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_w), **XENT_TOL)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(gr_w), **XENT_TOL)
    # and the port's two arms agree with each other
    logits = torch.from_numpy(x) @ torch.from_numpy(table).T
    logits[..., 50:] = -1e30
    with torch.no_grad():
        padded = losses.softmax_xent(logits, torch.from_numpy(targets))
        chunked = losses.chunked_softmax_xent(
            torch.from_numpy(x), torch.from_numpy(readout),
            torch.from_numpy(targets), 50, chunk=16,
            transpose_readout=transpose)
    np.testing.assert_allclose(float(chunked), float(padded), **XENT_TOL)


# -- CausalLM.loss against jax.value_and_grad --------------------------------

_JAX = {}


def _jax_smoke(arch, ce_impl="padded"):
    """(JAX model, JAX params as numpy, port model) on one smoke config."""
    key = (arch, ce_impl)
    if key not in _JAX:
        cfg_j = jax_get_smoke(arch).with_overrides(ce_impl=ce_impl)
        model_j = jax_build_model(cfg_j)
        params_j = model_j.init(jax.random.PRNGKey(0))
        model = build_model(get_smoke(arch).with_overrides(ce_impl=ce_impl),
                            policy=ExecutionPolicy("kernel"))
        _JAX[key] = (model_j, params_j, model)
    return _JAX[key]


@pytest.mark.parametrize("ce_impl", ["padded", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, ce_impl):
    model_j, params_j, model = _jax_smoke(arch, ce_impl)
    toks = _tokens(2, 19, model.cfg.vocab, 7)
    (want, mets_j), grads_j = jax.value_and_grad(model_j.loss, has_aux=True)(
        params_j, {"tokens": jnp.asarray(toks)})
    params = from_jax_params(params_j, "cpu")
    live = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, mets = model.loss(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    assert set(mets) == set(mets_j) == {"ce", "moe_aux", "ppl"}
    for k in mets:
        np.testing.assert_allclose(float(mets[k].detach()), float(mets_j[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    want_g = tree_leaves_with_path(grads_j)
    assert [p for p, _ in want_g] == [p for p, _ in
                                      tree_leaves_with_path(params)]
    for (path, gj), g in zip(want_g, grads):
        assert _rel(g.numpy(), np.asarray(gj)) <= REL_GRAD, path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_from_a_jax_state_matches_jax(arch):
    """One AdamW step from the same carried train state on the same
    batch: the new params, both moments and the count."""
    model_j, _, model = _jax_smoke(arch)
    scfg = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    state_j = jax_make_train_state(model_j, jax.random.PRNGKey(3))
    init = jax.tree_util.tree_map(np.asarray, state_j)
    batch = JaxLMDataset(vocab=model.cfg.vocab, seq_len=17,
                         global_batch=4).batch_at(0)
    new_j, mets_j = jax.jit(jax_make_train_step(
        model_j, JaxStepConfig(**scfg)))(state_j, batch)
    state = from_jax_params(init, "cpu")
    new, mets = make_train_step(model, StepConfig(**scfg))(state, batch)
    for k in ("loss", "grad_norm", "param_norm", "lr"):
        np.testing.assert_allclose(float(mets[k]), float(mets_j[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(mets["skipped"]) == 0.0
    assert int(new["opt"]["step"]) == int(new_j["opt"]["step"]) == 1
    got = tree_leaves_with_path(to_numpy(new))
    want = tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, new_j))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, err_msg=path, **STATE_TOL)


# -- data ------------------------------------------------------------------

def test_synthetic_lm_dataset_matches_jax_bit_for_bit():
    for kw in (dict(vocab=515, seq_len=17, global_batch=4),
               dict(vocab=64, seq_len=33, global_batch=6, seed=5, period=3,
                    noise=0.2),
               dict(vocab=1000, seq_len=9, global_batch=4, n_hosts=2,
                    host_id=1)):
        port, ref = SyntheticLMDataset(**kw), JaxLMDataset(**kw)
        for step in (0, 1, 11):
            a, b = port.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
def test_file_token_dataset_matches_jax_bit_for_bit(tmp_path, dtype):
    path = str(tmp_path / "tokens.npy")
    np.save(path, np.random.default_rng(2).integers(
        0, 50000, 1000).astype(dtype))
    for kw in (dict(seq_len=33, global_batch=4),
               dict(seq_len=17, global_batch=6, stride=5, n_hosts=2,
                    host_id=1)):
        port = FileTokenDataset(path=path, **kw)
        ref = JaxFileDataset(path=path, **kw)
        for step in (0, 3, 40):
            a, b = port.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


# -- tests/test_system.py, on the port ---------------------------------------

def test_training_learns_structure():
    """``tests/test_system.py:19`` on the port: starcoder2-3b's smoke at
    vocab 64, 80 steps on the synthetic copy stream; the loss must drop by
    more than 0.5 nats."""
    cfg = get_smoke("starcoder2-3b").with_overrides(vocab=64,
                                                    vocab_pad_to=64)
    model = build_model(cfg)
    step = make_train_step(model, StepConfig(peak_lr=3e-3, warmup_steps=10,
                                             total_steps=80))
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=33, global_batch=16)
    out = train_loop(step, make_train_state(model, 0, "cpu"), ds,
                     TrainLoopConfig(total_steps=80, log_every=1000),
                     log_fn=lambda _: None)
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert first > last + 0.5, (first, last)


def test_resume_is_exact(tmp_path):
    """``tests/test_system.py:35`` on the port: checkpoints at steps 3
    and 6, then a run from a different init resumes at 6 and reproduces
    the uninterrupted run's losses."""
    model = build_model(get_smoke("granite-3-2b"))
    step = make_train_step(model, StepConfig(peak_lr=1e-3, warmup_steps=2,
                                             total_steps=20))
    ds = SyntheticLMDataset(vocab=model.cfg.vocab, seq_len=17,
                            global_batch=4)
    quiet = dict(log_fn=lambda _: None)
    uninterrupted = train_loop(step, make_train_state(model, 0, "cpu"), ds,
                               TrainLoopConfig(total_steps=10,
                                               log_every=1000), **quiet)
    d = str(tmp_path / "ckpt")
    train_loop(step, make_train_state(model, 0, "cpu"), ds,
               TrainLoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=d,
                               log_every=1000), **quiet)
    resumed = train_loop(step, make_train_state(model, 1, "cpu"), ds,
                         TrainLoopConfig(total_steps=10, ckpt_every=100,
                                         ckpt_dir=d, log_every=1000), **quiet)
    assert resumed["resumed_from"] == 6
    assert [h["step"] for h in resumed["history"]] == [6, 7, 8, 9]
    ref_tail = [h["loss"] for h in uninterrupted["history"][6:]]
    res_tail = [h["loss"] for h in resumed["history"]]
    np.testing.assert_allclose(res_tail, ref_tail, rtol=1e-6)
    for a, b in zip(tree_leaves(to_numpy(resumed["state"])),
                    tree_leaves(to_numpy(uninterrupted["state"]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# -- the kernels under autograd -----------------------------------------------

def _grads(fn, *inputs):
    live = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*live)
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(out.dtype)
    return out, torch.autograd.grad(out, live, cot)


def test_conv1d_function_equals_plain_autograd():
    rng = np.random.default_rng(5)
    proj = torch.from_numpy(rng.standard_normal((2, 13, 40)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 24)).astype(np.float32))
    x = proj[..., 8:32]                    # a column view, as the mixer's
    out, got = _grads(c1.trim_conv1d, x, w)
    ref_out, want = _grads(c1.trim_conv1d_plain, x, w)
    assert out.grad_fn.name() == "TrimConv1dFnBackward"
    assert torch.equal(out, ref_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["causal", "kv_length", "block_causal"])
def test_flash_function_equals_plain_autograd(case):
    rng = np.random.default_rng(6)
    B, S, H, G, D = 2, 24, 2, 3, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, G, D), (B, S, H, D), (B, S, H, D)))
    kw = dict(causal=True, chunk_k=8)
    if case == "kv_length":
        kw = dict(causal=False, kv_length=torch.tensor([24, 5]), chunk_k=16)
    elif case == "block_causal":
        kw["block_causal"] = True
    out, got = _grads(lambda *t: fa.flash_attention(*t, **kw), q, k, v)
    ref_out, want = _grads(lambda *t: fa.flash_attention_plain(*t, **kw),
                           q, k, v)
    assert out.grad_fn.name() == "FlashAttentionFnBackward"
    assert torch.equal(out, ref_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,fn", [("mamba2-130m", "conv1d"),
                                     ("granite-3-2b", "flash")])
def test_loss_runs_the_kernels_through_their_functions(arch, fn,
                                                       monkeypatch):
    """In training, the model's kernel calls go through the Functions (one
    a layer), and not on the oracle substrate."""
    calls = []
    cls = c1.TrimConv1dFn if fn == "conv1d" else fa.FlashAttentionFn
    apply = cls.apply
    monkeypatch.setattr(cls, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    toks = torch.from_numpy(_tokens(2, 9, 512, 8))
    for substrate, want in (("kernel", 2), ("oracle", 0)):
        calls.clear()
        model = build_model(get_smoke(arch),
                            policy=ExecutionPolicy(substrate))
        state = make_train_state(model, 0, "cpu")
        make_train_step(model, StepConfig())(state, {"tokens": toks})
        assert len(calls) == want, substrate


def test_ssd_and_matmul_refuse_a_gradient():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    with pytest.raises(RuntimeError, match="no backward"):
        trim_matmul.trim_matmul(a.requires_grad_(True), b)
    with torch.no_grad():
        assert trim_matmul.trim_matmul(a, b).shape == (4, 3)
    Bb, L, H, P, S = 1, 8, 2, 4, 4
    x = torch.randn(Bb, L, H, P)
    dt = torch.rand(Bb, L, H)
    A = -torch.rand(H)
    Bm, Cm = torch.randn(Bb, L, H, S), torch.randn(Bb, L, H, S)
    D = torch.randn(H, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        trim_ssd.trim_ssd(x, dt, A, Bm, Cm, D, chunk=4)
    assert trim_ssd.trim_ssd(x, dt, A, Bm, Cm, D.detach(),
                             chunk=4).shape == x.shape
