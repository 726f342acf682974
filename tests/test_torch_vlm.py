"""The port's vision-language LM (the vlm family, llava-next-34b) against
the JAX package's, on the CPU.

The vision frontend is a stub in both packages: ``extra_embeds`` (B,
S_img, d_model), precomputed patch embeddings, are prepended to the
text's embeddings.  On the smoke config in fp32 (2 layers, d_model 64, 8
q / 2 kv heads of 8, 8 patch embeddings, an untied ``lm_head``, the
decode cache under ``kv_seq``), with JAX's weights carried by
``from_jax_params`` and the inputs made from a seed with numpy:

- ``forward`` with ``extra_embeds``: logits (B, 8 + S, vocab) within
  1e-4 of JAX's;
- ``loss`` on the text positions only, on both ``ce_impl`` arms, and each
  leaf's gradient (relative norm error 1e-4) against
  ``jax.value_and_grad``; the loss moves with the patch embeddings (they
  reach the text through attention) but takes no CE at their positions;
- the prefill with ``extra_embeds`` (logits and the whole cache), then
  three decode steps fed JAX's greedy tokens, within 3e-4
  (``tests/test_arch_smokes.py``'s vlm serve tolerance), and the port's
  own prefill + decode against its forward;
- ``make_prefill_step`` routes ``extra_embeds`` and ``lengths`` (counted
  from the first patch position) as JAX's prefill takes them;
- a ``make_train_step`` step on a batch with ``extra_embeds``: finite
  loss, every leaf moved;
- the launcher's prefill key names the patch count: two lengths, two
  executables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.nn.models import build_model as jax_build_model
from repro_torch.configs import get_smoke
from repro_torch.core.tree import (tree_leaves, tree_leaves_with_path,
                                   tree_unflatten)
from repro_torch.distributed import (StepConfig, make_decode_step,
                                     make_prefill_step, make_train_state,
                                     make_train_step)
from repro_torch.launch.serve import prefill_executable
from repro_torch.nn.models import CausalLM, build_model
from repro_torch.serve import ServeEngine
from repro_torch.weights import from_jax_params, to_numpy

ARCH = "llava-next-34b"
TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=3e-4, atol=3e-4)
REL_GRAD = 1e-4


@pytest.fixture(scope="module", params=["padded", "chunked"])
def smoke(request):
    model_j = jax_build_model(jax_get_smoke(ARCH).with_overrides(
        ce_impl=request.param))
    params_j = model_j.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(ARCH).with_overrides(
        ce_impl=request.param))
    assert isinstance(model, CausalLM) and model.cfg.family == "vlm"
    return model_j, params_j, model, from_jax_params(params_j, "cpu")


def _extra(B, cfg, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_forward_with_extra_embeds_matches_jax(smoke):
    model_j, params_j, model, params = smoke
    cfg = model.cfg
    extra, toks = _extra(2, cfg, 1), _tokens(2, 13, cfg.vocab, 2)
    want, aux_j = model_j.forward(params_j, jnp.asarray(toks),
                                  jnp.asarray(extra))
    got, aux = model.forward(params, torch.from_numpy(toks).long(),
                             torch.from_numpy(extra))
    assert got.shape == (2, cfg.frontend_tokens + 13, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), **TOL)


def test_loss_on_text_positions_matches_jax(smoke):
    model_j, params_j, model, params = smoke
    cfg = model.cfg
    extra, toks = _extra(2, cfg, 3), _tokens(2, 11, cfg.vocab, 4)
    (want, mets_j), grads_j = jax.value_and_grad(model_j.loss, has_aux=True)(
        params_j, {"tokens": jnp.asarray(toks),
                   "extra_embeds": jnp.asarray(extra)})
    live = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    batch = {"tokens": torch.from_numpy(toks).long(),
             "extra_embeds": torch.from_numpy(extra)}
    loss, mets = model.loss(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    for k in mets:
        np.testing.assert_allclose(float(mets[k].detach()), float(mets_j[k]),
                                   rtol=1e-4, atol=1e-7)
    for (path, gj), g in zip(tree_leaves_with_path(grads_j), grads):
        gj = np.asarray(gj)
        err = np.linalg.norm(g.numpy() - gj) / max(np.linalg.norm(gj), 1e-30)
        assert err <= REL_GRAD, path
    # the CE is over the 10 text targets: the forward's logits at the
    # last 10 positions of the text prefix give the same loss
    logits, _ = model.forward(params, batch["tokens"][:, :-1],
                              batch["extra_embeds"])
    logp = torch.log_softmax(logits[:, cfg.frontend_tokens:], -1)
    ce = -logp.gather(-1, batch["tokens"][:, 1:, None]).mean()
    np.testing.assert_allclose(float(ce.detach()), float(mets["ce"].detach()),
                               rtol=1e-5)
    other, _ = model.loss(params, dict(batch, extra_embeds=batch[
        "extra_embeds"] + 1.0))
    assert abs(float(other) - float(loss.detach())) > 1e-6


def test_prefill_and_decode_match_jax(smoke):
    model_j, params_j, model, params = smoke
    cfg = model.cfg
    B, S, n = 2, 9, cfg.frontend_tokens
    extra, toks = _extra(B, cfg, 5), _tokens(B, S, cfg.vocab, 6)
    cache_j = model_j.init_cache(B, n + S + 4, dtype=jnp.float32)
    cache = model.init_cache(B, n + S + 4, dtype=torch.float32, device="cpu")
    assert set(cache["slot0"]) == {"kv_seq"}
    logits_j, cache_j = model_j.prefill(params_j, jnp.asarray(toks), cache_j,
                                        extra_embeds=jnp.asarray(extra))
    logits, cache = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks),
                 "extra_embeds": torch.from_numpy(extra)}, cache)
    decode = make_decode_step(model)
    for i in range(4):
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                                   **SERVE_TOL)
        for (p, a), (_, b) in zip(tree_leaves_with_path(to_numpy(cache)),
                                  tree_leaves_with_path(cache_j)):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=p,
                                       **SERVE_TOL)
        if i == 3:
            break
        tok = jnp.argmax(logits_j, -1).astype(jnp.int32)
        logits_j, cache_j = model_j.decode_step(params_j, tok, cache_j,
                                                jnp.int32(n + S + i))
        logits, cache = decode(params, torch.from_numpy(np.array(tok)),
                               cache, n + S + i)


def test_own_prefill_then_decode_equals_forward(smoke):
    _, _, model, params = smoke
    cfg = model.cfg
    B, S, n = 2, 12, cfg.frontend_tokens
    extra = torch.from_numpy(_extra(B, cfg, 7))
    toks = torch.from_numpy(_tokens(B, S, cfg.vocab, 8)).long()
    full, _ = model.forward(params, toks, extra)
    cache = model.init_cache(B, n + S + 4, dtype=torch.float32, device="cpu")
    pre, cache = model.prefill(params, toks[:, :S - 1], cache,
                               extra_embeds=extra)
    torch.testing.assert_close(pre, full[:, n + S - 2], **SERVE_TOL)
    dec, _ = model.decode_step(params, toks[:, S - 1], cache, n + S - 1)
    torch.testing.assert_close(dec, full[:, n + S - 1], **SERVE_TOL)


def test_prefill_step_routes_extra_embeds_and_lengths(smoke):
    model_j, params_j, model, params = smoke
    cfg = model.cfg
    B, S, n = 3, 6, cfg.frontend_tokens
    extra, toks = _extra(B, cfg, 9), _tokens(B, S, cfg.vocab, 10)
    lengths = np.array([n + S, n + 2, 3], np.int32)
    want, _ = model_j.prefill(params_j, jnp.asarray(toks),
                              model_j.init_cache(B, n + S,
                                                 dtype=jnp.float32),
                              extra_embeds=jnp.asarray(extra),
                              lengths=jnp.asarray(lengths))
    got, _ = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks),
                 "extra_embeds": torch.from_numpy(extra),
                 "lengths": torch.from_numpy(lengths)},
        model.init_cache(B, n + S, torch.float32, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SERVE_TOL)
    # without extra_embeds the step is the text-only prefill
    text, _ = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks)},
        model.init_cache(B, S, torch.float32, "cpu"))
    text_j, _ = model_j.prefill(params_j, jnp.asarray(toks),
                                model_j.init_cache(B, S, dtype=jnp.float32))
    np.testing.assert_allclose(text.numpy(), np.asarray(text_j), **SERVE_TOL)


def test_train_step_moves_every_leaf():
    model = build_model(get_smoke(ARCH))
    cfg = model.cfg
    state = make_train_state(model, 0, "cpu")
    before = [t.clone() for t in tree_leaves(state["params"])]
    batch = {"extra_embeds": _extra(4, cfg, 11),
             "tokens": _tokens(4, 9, cfg.vocab, 12)}
    new, mets = make_train_step(model, StepConfig(peak_lr=1e-3,
                                                  warmup_steps=1))(state,
                                                                   batch)
    assert bool(torch.isfinite(mets["loss"]))
    assert bool(torch.isfinite(mets["grad_norm"]))
    assert float(mets["skipped"]) == 0.0
    paths = [p for p, _ in tree_leaves_with_path(new["params"])]
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(new["params"]), before)]
    assert all(moved), [p for p, m in zip(paths, moved) if not m]


def test_prefill_key_names_the_patch_count():
    model = build_model(get_smoke(ARCH))
    cfg = model.cfg
    params = model.init(0, "cpu")
    eng = ServeEngine(name="lm-vlm", buckets=(2,), device="cpu")
    toks = torch.from_numpy(_tokens(2, 5, cfg.vocab, 13))
    for n in (cfg.frontend_tokens, 3):
        batch = {"tokens": toks,
                 "extra_embeds": torch.from_numpy(_extra(2, cfg, 14)[:, :n])}
        prefill_executable(eng, model, params, batch,
                           model.init_cache(2, n + 5, torch.float32, "cpu"))
    prefill_executable(eng, model, params, {"tokens": toks},
                       model.init_cache(2, 5, torch.float32, "cpu"))
    keys = [str(k) for k in eng.compile_counts]
    assert len(keys) == 3 and set(eng.compile_counts.values()) == {1}
    assert sum("img" in k for k in keys) == 2
