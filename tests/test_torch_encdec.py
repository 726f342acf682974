"""The port's encoder-decoder LM (the encdec family, seamless-m4t-large-v2)
against the JAX package's, on the CPU.

On the smoke config in fp32 (2 + 2 layers, d_model 64, 4 heads of 16,
layernorm, the gelu MLP, vocab 518), with JAX's weights carried by
``from_jax_params`` and the inputs made from a seed with numpy:

- ``make_cross_kv`` and the cross-attention layer of the first decoder
  layer against JAX's, within ``LAYER_TOL`` (the attention tests'
  tolerance); the cross call's output does not depend on the rope angles
  the stack hands the self-attention;
- the non-causal encoder stack (``run_stack`` in "encoder" mode) against
  JAX's within 1e-4, and unlike the causal stack: a later frame moves an
  earlier frame's output;
- ``EncDecLM.encode``, ``forward`` and ``loss`` (and each leaf's
  gradient, relative norm error 1e-4) against JAX's within 1e-4;
- the prefill's logits and its caches (the self-KV and the cross-KV),
  then three decode steps fed JAX's greedy tokens, against JAX's within
  2e-4 (``tests/test_arch_smokes.py``'s encdec serve tolerance); the
  prefill writes the cross-KV into the cache given, in place, and decode
  never writes it;
- the port's own prefill + decode against its forward within 2e-4;
- ``make_prefill_step`` routes ``src_embeds`` to ``EncDecLM.prefill``;
- a ``make_train_step`` step: finite loss, every leaf moved;
- the param tree and the cache tree (``cross_kv`` a (k, v) tuple) cross
  from JAX with the same paths, and back bit for bit;
- the serve launcher's functions (``prefill_executable``,
  ``decode_executable``, ``run_decode``) on JAX's weights and the JAX
  launcher's encdec inputs give JAX's greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.nn import attention as jattn
from repro.nn import blocks as jblocks
from repro.nn.models import build_model as jax_build_model
from repro_torch.configs import get_smoke
from repro_torch.core.tree import (tree_leaves, tree_leaves_with_path,
                                   tree_map, tree_unflatten)
from repro_torch.distributed import (StepConfig, make_decode_step,
                                     make_prefill_step, make_train_state,
                                     make_train_step)
from repro_torch.launch.serve import (decode_executable, prefill_executable,
                                      run_decode)
from repro_torch.nn import attention as tattn
from repro_torch.nn import blocks as tblocks
from repro_torch.nn.layers import rope_angles
from repro_torch.nn.models import EncDecLM, build_model
from repro_torch.serve import ServeEngine
from repro_torch.weights import from_jax_params, to_numpy

ARCH = "seamless-m4t-large-v2"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
REL_GRAD = 1e-4


@pytest.fixture(scope="module")
def smoke():
    model_j = jax_build_model(jax_get_smoke(ARCH))
    params_j = model_j.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(ARCH))
    assert isinstance(model, EncDecLM)
    return model_j, params_j, model, from_jax_params(params_j, "cpu")


def _src(B, S, d, seed):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _period(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def test_cross_kv_and_cross_attention_match_jax(smoke):
    model_j, params_j, model, params = smoke
    spec = model.dec_spec
    lay, lay_j = spec.layout, model_j.dec_spec.layout
    p_j = _period(params_j["decoder"]["slot0"], 0)
    p = tree_map(lambda t: t[0], params["decoder"]["slot0"]["cross"])
    enc, x = _src(2, 13, 64, 1), _src(2, 6, 64, 2)
    ckv_j = jattn.make_cross_kv(p_j["cross"], jnp.asarray(enc), lay_j)
    ckv = tattn.make_cross_kv(p, torch.from_numpy(enc), lay)
    for a, b in zip(ckv, ckv_j):
        assert a.shape == (2, 13, lay.kv_eff, lay.head_dim)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LAYER_TOL)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    want, _ = jattn.attention(p_j["cross"], jnp.asarray(x), lay_j,
                              positions=jnp.asarray(pos), mode="train",
                              causal=False, cross_kv=ckv_j,
                              chunk_k=spec.chunk_k)
    outs = []
    for shift in (0, 5):   # rope angles that must not reach the cross call
        got, none = tattn.attention(
            p, torch.from_numpy(x), lay,
            positions=torch.from_numpy(pos.copy()) + shift, mode="train",
            causal=False, cross_kv=ckv, chunk_k=spec.chunk_k,
            rope=rope_angles(torch.from_numpy(pos.copy()) + shift,
                             lay.head_dim, spec.rope_theta))
        assert none is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
        outs.append(got)
    assert torch.equal(outs[0], outs[1])


def test_encoder_stack_is_non_causal_and_matches_jax(smoke):
    model_j, params_j, model, params = smoke
    assert not model.enc_spec.causal and model.dec_spec.causal
    assert all(s.cross_attn for s in model.dec_spec.slots)
    assert not any(s.cross_attn for s in model.enc_spec.slots)
    x = _src(2, 11, 64, 3)
    want, _, _ = jblocks.run_stack(params_j["encoder"], jnp.asarray(x),
                                   model_j.enc_spec, mode="encoder")
    got, none, _ = tblocks.run_stack(params["encoder"], torch.from_numpy(x),
                                     model.enc_spec, mode="encoder")
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the last frame reaches the first frame's output
    x2 = x.copy()
    x2[:, -1] += 1.0
    got2, _, _ = tblocks.run_stack(params["encoder"], torch.from_numpy(x2),
                                   model.enc_spec, mode="encoder")
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-6


def test_encode_forward_and_loss_match_jax(smoke):
    model_j, params_j, model, params = smoke
    src, toks = _src(2, 9, 64, 4), _tokens(2, 12, model.cfg.vocab, 5)
    enc_j = model_j.encode(params_j, jnp.asarray(src))
    enc = model.encode(params, torch.from_numpy(src))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), **TOL)
    want = model_j.forward(params_j, jnp.asarray(src), jnp.asarray(toks))
    got = model.forward(params, torch.from_numpy(src),
                        torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 12,
                                                        model.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    batch_j = {"src_embeds": jnp.asarray(src), "tokens": jnp.asarray(toks)}
    (loss_j, mets_j), grads_j = jax.value_and_grad(
        model_j.loss, has_aux=True)(params_j, batch_j)
    live = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    loss, mets = model.loss(tree_unflatten(params, live),
                            {"src_embeds": torch.from_numpy(src),
                             "tokens": torch.from_numpy(toks).long()})
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    assert set(mets) == set(mets_j) == {"ce", "ppl"}
    for k in mets:
        np.testing.assert_allclose(float(mets[k].detach()), float(mets_j[k]),
                                   **TOL)
    want_g = tree_leaves_with_path(grads_j)
    assert [p for p, _ in want_g] == [p for p, _ in
                                      tree_leaves_with_path(params)]
    for (path, gj), g in zip(want_g, grads):
        gj = np.asarray(gj)
        err = np.linalg.norm(g.numpy() - gj) / max(np.linalg.norm(gj), 1e-30)
        assert err <= REL_GRAD, path


def test_prefill_and_decode_match_jax(smoke):
    """A 7-token target prompt over a 10-frame source, then three decode
    steps fed JAX's greedy tokens: logits and every cache leaf at each
    step.  The prefill writes the cross-KV into the cache's own tensors;
    decode leaves it as the prefill wrote it."""
    model_j, params_j, model, params = smoke
    B, S, S_src = 2, 7, 10
    src, toks = _src(B, S_src, 64, 6), _tokens(B, S, model.cfg.vocab, 7)
    cache_j = model_j.init_cache(B, S + 4, cross_len=S_src,
                                 dtype=jnp.float32)
    cache = model.init_cache(B, S + 4, cross_len=S_src,
                             dtype=torch.float32, device="cpu")
    given = cache["slot0"]["cross_kv"]
    logits_j, cache_j = model_j.prefill(params_j, jnp.asarray(src),
                                        jnp.asarray(toks), cache_j)
    logits, cache = model.prefill(params, torch.from_numpy(src),
                                  torch.from_numpy(toks).long(), cache)
    assert cache["slot0"]["cross_kv"] is given
    written = [t.clone() for t in given]
    assert float(written[0].abs().max()) > 0
    for i in range(4):
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                                   **SERVE_TOL)
        got = tree_leaves_with_path(to_numpy(cache))
        want = tree_leaves_with_path(cache_j)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=p,
                                       **SERVE_TOL)
        if i == 3:
            break
        tok = jnp.argmax(logits_j, -1).astype(jnp.int32)
        logits_j, cache_j = model_j.decode_step(params_j, tok, cache_j,
                                                jnp.int32(S + i))
        logits, cache = model.decode_step(
            params, torch.from_numpy(np.array(tok)).long(), cache, S + i)
    for a, b in zip(cache["slot0"]["cross_kv"], written):
        assert torch.equal(a, b)


def test_own_prefill_then_decode_equals_forward(smoke):
    _, _, model, params = smoke
    B, S = 2, 12
    src = torch.from_numpy(_src(B, 8, 64, 8))
    toks = torch.from_numpy(_tokens(B, S, model.cfg.vocab, 9)).long()
    full = model.forward(params, src, toks)
    cache = model.init_cache(B, S + 4, cross_len=8, dtype=torch.float32,
                             device="cpu")
    pre, cache = model.prefill(params, src, toks[:, :S - 1], cache)
    torch.testing.assert_close(pre, full[:, S - 2], **SERVE_TOL)
    dec, cache2 = model.decode_step(params, toks[:, S - 1], cache, S - 1)
    assert cache2 is cache
    torch.testing.assert_close(dec, full[:, S - 1], **SERVE_TOL)
    # a tensor position gives the int position's logits bit for bit
    cache3 = model.init_cache(B, S + 4, cross_len=8, dtype=torch.float32,
                              device="cpu")
    _, cache3 = model.prefill(params, src, toks[:, :S - 1], cache3)
    dec_t, _ = model.decode_step(params, toks[:, S - 1], cache3,
                                 torch.tensor(S - 1))
    assert torch.equal(dec_t, dec)


def test_prefill_step_routes_the_source(smoke):
    _, _, model, params = smoke
    src = torch.from_numpy(_src(2, 5, 64, 10))
    bos = torch.zeros((2, 1), dtype=torch.long)

    def cache():
        return model.init_cache(2, 4, cross_len=5, dtype=torch.float32,
                                device="cpu")

    want, _ = model.prefill(params, src, bos, cache())
    got, c = make_prefill_step(model)(params, {"src_embeds": src,
                                               "tokens": bos}, cache())
    assert torch.equal(got, want)
    assert float(c["slot0"]["cross_kv"][1].abs().max()) > 0
    logits, _ = make_decode_step(model)(params, got.argmax(-1), c, 1)
    assert logits.shape == (2, model.cfg.vocab)


def test_train_step_moves_every_leaf():
    model = build_model(get_smoke(ARCH))
    state = make_train_state(model, 0, "cpu")
    before = [t.clone() for t in tree_leaves(state["params"])]
    batch = {"src_embeds": _src(4, 6, 64, 11),
             "tokens": _tokens(4, 9, model.cfg.vocab, 12)}
    new, mets = make_train_step(model, StepConfig(peak_lr=1e-3,
                                                  warmup_steps=1))(state,
                                                                   batch)
    assert bool(torch.isfinite(mets["loss"]))
    assert bool(torch.isfinite(mets["grad_norm"]))
    assert float(mets["skipped"]) == 0.0
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(new["params"]), before)]
    paths = [p for p, _ in tree_leaves_with_path(new["params"])]
    # the padded vocab rows of the tied table get no gradient but still
    # decay: every leaf moves
    assert all(moved), [p for p, m in zip(paths, moved) if not m]


def test_trees_cross_from_jax_with_the_same_paths(smoke):
    model_j, params_j, model, params = smoke
    assert [p for p, _ in tree_leaves_with_path(model.init(0, "meta"))] == \
        [p for p, _ in tree_leaves_with_path(params)]
    names = {p.split("/")[0] for p, _ in tree_leaves_with_path(params)}
    assert names == {"embed", "encoder", "enc_norm", "decoder",
                     "final_norm"}
    slot = {p.split("/")[1] for p, _ in
            tree_leaves_with_path(params["decoder"])}
    assert {"cross", "norm_cross", "attn", "norm_mixer"} <= slot
    cache_j = model_j.init_cache(2, 5, cross_len=3, dtype=jnp.bfloat16)
    cache = model.init_cache(2, 5, cross_len=3, device="cpu")
    got = [(p, tuple(t.shape), t.dtype) for p, t in
           tree_leaves_with_path(cache)]
    want = [(p, tuple(a.shape), torch.bfloat16) for p, a in
            tree_leaves_with_path(cache_j)]
    assert got == want
    assert isinstance(cache["slot0"]["cross_kv"], tuple)
    assert got[0][0] == "slot0/cross_kv/0"
    rnd = jax.tree_util.tree_map(
        lambda a: jax.random.normal(jax.random.PRNGKey(a.size), a.shape,
                                    a.dtype), cache_j)
    back = to_numpy(from_jax_params(rnd, "cpu"))
    for (p, a), (_, b) in zip(tree_leaves_with_path(back),
                              tree_leaves_with_path(rnd)):
        np.testing.assert_array_equal(a, np.asarray(b).view(np.uint16),
                                      err_msg=p)


def test_serve_launcher_functions_give_jax_tokens(smoke):
    """The JAX launcher's encdec arm (a ``default_rng(0)`` source of
    ``prompt_len`` frames after the prompts are drawn, a bos of zeros,
    decode from position 1) on JAX's weights, and the port's launcher
    functions on the same weights and inputs: the same greedy tokens."""
    model_j, params_j, model, params = smoke
    B, P, gen = 2, 12, 5
    rng = np.random.default_rng(0)
    rng.integers(0, model.cfg.vocab, (B, P))
    src = rng.normal(size=(B, P, model.cfg.d_model))
    cache_j = model_j.init_cache(B, P + gen, cross_len=P, dtype=jnp.float32)
    logits_j, cache_j = model_j.prefill(
        params_j, jnp.asarray(src, jnp.float32), jnp.zeros((B, 1), jnp.int32),
        cache_j)
    want = [jnp.argmax(logits_j, -1).astype(jnp.int32)]
    for i in range(gen - 1):
        logits_j, cache_j = model_j.decode_step(params_j, want[-1], cache_j,
                                                jnp.int32(1 + i))
        want.append(jnp.argmax(logits_j, -1).astype(jnp.int32))

    eng = ServeEngine(name="lm-encdec", buckets=(B,), device="cpu")
    batch = {"src_embeds": torch.as_tensor(src, dtype=torch.float32),
             "tokens": torch.zeros((B, 1), dtype=torch.long)}
    cache = model.init_cache(B, P + gen, cross_len=P, dtype=torch.float32,
                             device="cpu")
    prefill = prefill_executable(eng, model, params, batch, cache)
    logits, cache = prefill(params, batch, cache)
    tok = logits.argmax(-1)
    decode = decode_executable(eng, model, params, tok, cache, 1)
    toks, _, _, finite = run_decode(decode, params, tok, cache, 1, gen - 1,
                                    torch.device("cpu"))
    assert finite
    got = torch.stack([tok] + toks, 1).numpy()
    np.testing.assert_array_equal(got, np.stack([np.asarray(t)
                                                 for t in want], 1))
    # the prefill's key names the source length: another length, another
    # executable
    short = {"src_embeds": batch["src_embeds"][:, :7],
             "tokens": batch["tokens"]}
    prefill_executable(eng, model, params, short, model.init_cache(
        B, P + gen, cross_len=7, dtype=torch.float32, device="cpu"))
    keys = [k for k in eng.compile_counts if "prefill" in str(k)]
    assert len(keys) == 2 and set(eng.compile_counts.values()) == {1}
