"""The port's LM serving path against the JAX package's, on the CPU, for
each architecture it serves: mamba2-130m (the ssm family), granite-3-2b,
starcoder2-3b (layernorm, the tanh-gelu MLP, G = 4 on its smoke config
and 12 at full width), gemma-7b (geglu, head dim 256 at full width, the
embedding scaled by sqrt(d_model)) and mistral-large-123b (an untied
``lm_head``, the sequence-sharded decode cache) of the dense family,
arctic-480b (MoE top-2 with a dense residual) and
llama4-maverick-400b-a17b (dense and MoE top-1 layers interleaved, a
shared expert) of the moe family, jamba-1.5-large-398b (Mamba and
attention slots, MoE on the odd layers) of the hybrid family, and
llava-next-34b of the vlm family (here text-only: ``extra_embeds`` are
held in ``tests/test_torch_vlm.py``).  Every test but the family and
feature checks runs once per architecture; the config, the full-width
tree and the launcher tests also for seamless-m4t-large-v2, the encdec
family (the rest of it in ``tests/test_torch_encdec.py``).

- The full config's fields, parameter count and active parameter count
  equal JAX's, and the full-width parameter tree (init on the ``meta``
  device, never materialized: arctic-480b is 480 B) has JAX's paths,
  shapes and dtypes (``jax.eval_shape``) and the count of
  ``FULL_PARAMS``.
- On the smoke config in fp32, with JAX's weights carried by
  ``from_jax_params``: forward logits within rtol = atol = 1e-4; prefill
  logits and cache, then 8 teacher-forced decode steps fed JAX's tokens,
  within 3e-4 (the JAX package's own serve-consistency tolerance,
  ``tests/test_arch_smokes.py``); the port's own prefill + decode equal
  its forward within 3e-4 (at ``capacity_factor`` 16, as JAX's test: an
  S-token and a 1-token call drop different tokens).
- bfloat16 weights cross bit for bit, both ways.
- ``init_stack`` (each stacked leaf allocated once, filled period by
  period) gives the old stack-of-periods init's params bit for bit.
- The launcher runs on the CPU when asked to and refuses without a card.
- ``build_model`` builds every family and every feature the JAX package
  has on one device, each held against JAX's forward; it refuses ``tp !=
  1``; and builds a config whatever its name.

The KV caches are written in place (``nn/attention.py``): the prefill +
decode test checks that the cache returned is the one given.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.nn.models import build_model as jax_build_model
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.tree import (tree_leaves, tree_leaves_with_path,
                                   tree_map)
from repro_torch.distributed import make_decode_step, make_prefill_step
from repro_torch.nn.blocks import _init_slot, init_stack
from repro_torch.nn.models import CausalLM, EncDecLM, build_model
from repro_torch.weights import from_jax_params, to_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ["mamba2-130m", "granite-3-2b", "starcoder2-3b", "gemma-7b",
         "mistral-large-123b", "arctic-480b", "llama4-maverick-400b-a17b",
         "jamba-1.5-large-398b", "llava-next-34b"]
#: the encdec arch: an EncDecLM, whose forward and serving take a source
ENCDEC = "seamless-m4t-large-v2"
ALL_ARCHS = ARCHS + [ENCDEC]


def _attn(d, n_q, n_kv, hd):
    return d * (n_q + 2 * n_kv) * hd + n_q * hd * d


def _mamba(d, d_in, gs, h, K):
    """in_proj, conv1d, A_log / dt_bias / D, the gated norm, out_proj."""
    return d * (2 * d_in + 2 * gs + h) + K * (d_in + 2 * gs) + 3 * h + d_in \
        + d_in * d



#: the full-width parameter count: embedding (padded vocab) + layers + the
#: final norm
FULL_PARAMS = {
    "mamba2-130m": 50304 * 768 + 24 * (768 * 3352 + 4 * 1792 + 3 * 24 + 1536
                                       + 1536 * 768 + 768) + 768,
    "granite-3-2b": 49280 * 2048 + 40 * (2048 * 48 * 64 + 32 * 64 * 2048
                                         + 3 * 2048 * 8192 + 2 * 2048)
    + 2048,
    # layernorm: a scale and a bias per norm; the gelu MLP: two matrices
    "starcoder2-3b": 49152 * 3072 + 30 * (3072 * 28 * 128 + 24 * 128 * 3072
                                          + 2 * 3072 * 12288 + 4 * 3072)
    + 2 * 3072,
    # q/kv width 16 x 256 = 4096, not d_model
    "gemma-7b": 256000 * 3072 + 28 * (_attn(3072, 16, 16, 256)
                                      + 3 * 3072 * 24576 + 2 * 3072) + 3072,
    # the untied lm_head: a second vocab x d_model
    "mistral-large-123b": 2 * 32768 * 12288 + 88 * (
        _attn(12288, 96, 8, 128) + 3 * 12288 * 28672 + 2 * 12288) + 12288,
    # each layer: the router, 128 experts and the dense residual
    "arctic-480b": 2 * 32000 * 7168 + 35 * (
        _attn(7168, 56, 8, 128) + 7168 * 128 + 129 * 3 * 7168 * 4864
        + 2 * 7168) + 7168,
    # vocab 202048 padded to 202112; 24 dense layers, 24 MoE layers with
    # the router, 128 experts and the shared expert
    "llama4-maverick-400b-a17b": 2 * 202112 * 5120 + 48 * (
        _attn(5120, 40, 8, 128) + 2 * 5120) + 24 * 3 * 5120 * 8192
    + 24 * (5120 * 128 + 129 * 3 * 5120 * 8192) + 5120,
    # 9 periods of 8: attention at slot 4, Mamba-2 (d_inner 16384, 8
    # groups of state 128, 128 heads) elsewhere; MoE (16 experts) on the
    # odd slots
    "jamba-1.5-large-398b": 2 * 65536 * 8192 + 9 * (
        _attn(8192, 64, 8, 128) + 7 * _mamba(8192, 16384, 1024, 128, 4)
        + 4 * 3 * 8192 * 24576 + 4 * (8192 * 16 + 16 * 3 * 8192 * 24576)
        + 16 * 8192) + 8192,
    # the untied lm_head; vocab 64000 is a multiple of 128
    "llava-next-34b": 2 * 64000 * 7168 + 60 * (
        _attn(7168, 56, 8, 128) + 3 * 7168 * 20480 + 2 * 7168) + 7168,
    # vocab 256206 padded to 256256, tied; layernorm (scale and bias) and
    # the gelu MLP (two matrices); the encoder's 24 layers and its norm,
    # the decoder's 24 with the cross-attention and its norm, the final
    # norm
    "seamless-m4t-large-v2": 256256 * 1024 + 24 * (
        _attn(1024, 16, 16, 64) + 2 * 1024 * 8192 + 4 * 1024) + 2 * 1024
    + 24 * (2 * _attn(1024, 16, 16, 64) + 2 * 1024 * 8192 + 6 * 1024)
    + 2 * 1024,
}
TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_config_matches_jax(arch):
    port, ref = get_config(arch), jax_get_config(arch)
    a, b = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert str(a.pop("dtype")) == "torch.bfloat16"
    assert jnp.dtype(b.pop("dtype")).name == "bfloat16"
    assert a == b
    assert port.param_count_estimate() == ref.param_count_estimate()
    assert port.active_param_count_estimate() == \
        ref.active_param_count_estimate()
    assert get_smoke(arch).dtype == torch.float32
    smoke, smoke_j = (dataclasses.asdict(c) for c in (get_smoke(arch),
                                                      jax_get_smoke(arch)))
    smoke.pop("dtype")
    smoke_j.pop("dtype")
    assert smoke == smoke_j


@pytest.mark.parametrize("arch", ["gemma-7b", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b", "llava-next-34b"])
def test_unported_families_raise(arch):
    """Every family builds from JAX's smoke config and matches JAX's
    forward (gemma-7b's dense features, jamba's hybrid schedule, the vlm
    family with 8 prepended patch embeddings, the encdec family from a
    7-frame source); ``build_model`` gives the encdec family an
    ``EncDecLM``."""
    cfg = jax_smoke_as_port(arch)
    assert get_config(arch).name == arch
    assert isinstance(build_model(cfg), EncDecLM) == (cfg.family == "encdec")
    _assert_forward_matches_jax(cfg, jax_get_smoke(arch))


@pytest.mark.parametrize("override", [
    dict(family="moe"), dict(tie_embeddings=False), dict(n_experts=4),
    dict(scale_embed=True), dict(decode_kv_seqshard="model")],
    ids=lambda o: next(iter(o)))
def test_build_model_refuses_unported_features(override):
    """Each feature this slice ports builds by what a config needs, not by
    its name, and matches JAX with that override on granite's smoke config
    (``n_experts=4`` with ``top_k`` 2: every layer MoE); ``tp=2`` builds
    too (the TP head layout: KV heads repeated, q groups padded) and its
    logits match ``tp=1``'s on the same params within TOL."""
    if "n_experts" in override:
        override = dict(override, top_k=2)
    cfg = get_smoke("granite-3-2b").with_overrides(**override)
    _assert_forward_matches_jax(
        cfg, jax_get_smoke("granite-3-2b").with_overrides(**override))
    params = build_model(cfg).init(0, "cpu")
    toks = torch.from_numpy(_tokens(2, 9, cfg.vocab, 6))
    with torch.no_grad():
        want = build_model(cfg).forward(params, toks)[0]
        got = build_model(cfg, tp=2).forward(params, toks)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _assert_forward_matches_jax(cfg, cfg_j):
    """The port's model for ``cfg`` on JAX's params for ``cfg_j``: the
    same tree, forward logits and moe_aux within TOL."""
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = from_jax_params(params_j, "cpu")
    assert [p for p, _ in tree_leaves_with_path(model.init(0, "meta"))] \
        == [p for p, _ in tree_leaves_with_path(params)]
    toks = _tokens(2, 9, cfg.vocab, 6)
    rng = np.random.default_rng(7)
    if cfg.family == "encdec":
        src = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
        want = model_j.forward(params_j, jnp.asarray(src), jnp.asarray(toks))
        got = model.forward(params, torch.from_numpy(src),
                            torch.from_numpy(toks).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    extra = (rng.normal(size=(2, cfg.frontend_tokens, cfg.d_model)).astype(
        np.float32) if cfg.family == "vlm" else None)
    want, aux_j = model_j.forward(
        params_j, jnp.asarray(toks),
        None if extra is None else jnp.asarray(extra))
    got, aux = model.forward(params, torch.from_numpy(toks).long(),
                             None if extra is None else
                             torch.from_numpy(extra))
    assert got.shape == (2, 9 + (0 if extra is None else extra.shape[1]),
                         cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), **TOL)


def test_build_model_takes_a_renamed_config():
    cfg = get_smoke("granite-3-2b")
    model = build_model(cfg.with_overrides(name="granite-copy"))
    params = build_model(cfg).init(0, "cpu")
    toks = torch.from_numpy(_tokens(2, 9, cfg.vocab, 2)).long()
    assert torch.equal(model.forward(params, toks)[0],
                       build_model(cfg).forward(params, toks)[0])


def jax_smoke_as_port(arch):
    """A JAX smoke config's fields on the port's ModelConfig."""
    fields = dataclasses.asdict(jax_get_smoke(arch))
    fields["dtype"] = torch.float32
    return get_smoke("mamba2-130m").with_overrides(**fields)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_width_param_tree_matches_jax(arch):
    params = build_model(get_config(arch)).init(0, "meta")
    shapes = jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                            jax.random.PRNGKey(0))
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_leaves_with_path(params)]
    want = [(p, tuple(s.shape), jnp.dtype(s.dtype).name)
            for p, s in tree_leaves_with_path(shapes)]
    assert got == want
    assert sum(int(np.prod(s)) for _, s, _ in got) == FULL_PARAMS[arch]


def _stack_of_periods(gen, spec, dtype, device):
    """``init_stack`` as it was: every period's tree, then stacked."""
    return {f"slot{i}": tree_map(lambda *xs: torch.stack(xs), *[
        _init_slot(gen, spec, slot, dtype, device)
        for _ in range(spec.n_periods)])
        for i, slot in enumerate(spec.slots)}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_stack_is_the_stack_of_periods_bit_for_bit(arch):
    """``init_stack`` fills each stacked leaf period by period and so
    holds the params once; from one seed it gives the old
    stack-of-periods init's params bit for bit, every stack of the model
    (the encdec encoder's and decoder's), in fp32 and bf16, and leaves the
    generator where the old init left it."""
    model = build_model(get_smoke(arch))
    specs = ([model.enc_spec, model.dec_spec]
             if isinstance(model, EncDecLM) else [model.spec])
    for dtype in (torch.float32, torch.bfloat16):
        g_new, g_old = (torch.Generator().manual_seed(5) for _ in range(2))
        for spec in specs:
            new = init_stack(g_new, spec, dtype, "cpu")
            old = _stack_of_periods(g_old, spec, dtype, "cpu")
            got, want = (tree_leaves_with_path(t) for t in (new, old))
            assert [p for p, _ in got] == [p for p, _ in want]
            for (p, a), (_, b) in zip(got, want):
                assert a.dtype == b.dtype, p
                assert torch.equal(a, b), p
        assert torch.equal(g_new.get_state(), g_old.get_state())


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    cfg_j = jax_get_smoke(request.param)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(request.param))
    return model_j, params_j, model, from_jax_params(params_j, "cpu")


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_smoke_forward_matches_jax(smoke):
    model_j, params_j, model, params = smoke
    toks = _tokens(2, 40, model.cfg.vocab, 1)
    want, aux_j = model_j.forward(params_j, jnp.asarray(toks))
    got, aux = model.forward(params, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 40,
                                                        model.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(aux_j), **TOL)


def test_smoke_prefill_and_decode_match_jax(smoke):
    """prefill on 21 tokens (a ragged last SSD chunk for mamba2-130m),
    then 8 decode steps fed the tokens JAX picks greedily; logits and the
    whole cache at every step."""
    model_j, params_j, model, params = smoke
    B, S = 2, 21
    toks = _tokens(B, S, model.cfg.vocab, 2)
    cache_j = model_j.init_cache(B, S + 8, dtype=jnp.float32)
    cache = model.init_cache(B, S + 8, dtype=torch.float32, device="cpu")
    logits_j, cache_j = model_j.prefill(params_j, jnp.asarray(toks), cache_j)
    prefill = make_prefill_step(model)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(toks)}, cache)
    decode = make_decode_step(model)
    for i in range(9):
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                                   **SERVE_TOL)
        for (p, a), (_, b) in zip(tree_leaves_with_path(to_numpy(cache)),
                                  tree_leaves_with_path(cache_j)):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=p,
                                       **SERVE_TOL)
        if i == 8:
            break
        tok = jnp.argmax(logits_j, -1).astype(jnp.int32)
        logits_j, cache_j = model_j.decode_step(params_j, tok, cache_j,
                                                jnp.int32(S + i))
        logits, cache = decode(params, torch.from_numpy(np.array(tok)),
                               cache, S + i)


def test_smoke_prefill_with_lengths_matches_jax(smoke):
    model_j, params_j, model, params = smoke
    toks = _tokens(3, 12, model.cfg.vocab, 3)
    lengths = np.array([12, 5, 1], np.int32)
    want, _ = model_j.prefill(params_j, jnp.asarray(toks),
                              model_j.init_cache(3, 12, dtype=jnp.float32),
                              lengths=jnp.asarray(lengths))
    got, _ = model.prefill(params, torch.from_numpy(toks),
                           model.init_cache(3, 12, torch.float32, "cpu"),
                           lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SERVE_TOL)


def test_smoke_prefill_then_decode_equals_forward(smoke):
    """prefill(t[:S-1]) + decode(t[S-1]) == forward(t) at the last two
    positions, on the port alone (MoE at capacity_factor 16, so that no
    token is dropped in either).  A Mamba cache given is never written; a
    KV cache is written in place and returned, under JAX's key (``kv``,
    or ``kv_seq`` where the decode cache is sequence-sharded)."""
    _, _, model, params = smoke
    model = build_model(model.cfg.with_overrides(capacity_factor=16.0))
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(B, S, model.cfg.vocab, 4)).long()
    full, _ = model.forward(params, toks)
    cache = model.init_cache(B, S + 4, dtype=torch.float32, device="cpu")
    pre, cache2 = model.prefill(params, toks[:, :S - 1], cache)
    torch.testing.assert_close(pre, full[:, S - 2], **SERVE_TOL)
    dec, cache3 = model.decode_step(params, toks[:, S - 1], cache2, S - 1)
    torch.testing.assert_close(dec, full[:, S - 1], **SERVE_TOL)
    key = "kv_seq" if model.cfg.decode_kv_seqshard else "kv"
    kv_slots = [s for s, c in cache.items() if "kv" in c or "kv_seq" in c]
    assert all(set(cache[s]) == {key} for s in kv_slots)
    for slot, c in cache.items():
        if slot in kv_slots:
            assert cache3[slot][key] is cache2[slot][key] is c[key]
            k = c[key].k
            assert float(k[:, :, S - 1].abs().max()) > 0
            assert float(k[:, :, S:].abs().max()) == 0
        else:
            assert all(float(t.abs().max()) == 0 for t in tree_leaves(c))
    assert bool(kv_slots) == bool(model.cfg.n_q)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_weights_cross_bit_for_bit(arch):
    """JAX bf16 params -> the port -> numpy: the same 16-bit patterns, and
    the port's bf16 forward runs on them."""
    cfg_j = jax_get_smoke(arch, dtype=jnp.bfloat16)
    params_j = jax_build_model(cfg_j).init(jax.random.PRNGKey(1))
    params = from_jax_params(params_j, "cpu")
    back = to_numpy(params)
    for (p, a), (_, b) in zip(tree_leaves_with_path(params),
                              tree_leaves_with_path(params_j)):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16, p
            b = b.view(np.uint16)
        got = dict(tree_leaves_with_path(back))[p]
        np.testing.assert_array_equal(got, b, err_msg=p)
    model = CausalLM(get_smoke(arch, dtype=torch.bfloat16))
    toks = torch.from_numpy(_tokens(1, 9, model.cfg.vocab, 5)).long()
    logits, aux = model.forward(params, toks)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("d_model", [64, 3072])
def test_scale_embed_rounds_as_jax(d_model):
    """gemma's embedding scale in bf16: JAX multiplies by
    ``jnp.asarray(sqrt(d_model), bf16)`` (sqrt(3072) = 55.43 rounds to
    55.5); the port's scaled embedding equals JAX's bit for bit."""
    cfg_j = jax_get_smoke("gemma-7b", dtype=jnp.bfloat16).with_overrides(
        d_model=d_model)
    rng = np.random.default_rng(d_model)
    table = jnp.asarray(rng.standard_normal((cfg_j.vocab, d_model)),
                        jnp.bfloat16)
    toks = _tokens(2, 7, cfg_j.vocab, 8)
    want = jax_build_model(cfg_j)._embed({"embed": {"table": table}},
                                         jnp.asarray(toks), None)
    got = CausalLM(get_smoke("gemma-7b", dtype=torch.bfloat16).with_overrides(
        d_model=d_model))._embed(from_jax_params(
            {"embed": {"table": table}}, "cpu"), torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want).view(
        np.uint16))


def _run_serve(arch, *flags):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", *flags], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serve_launcher_on_the_cpu(arch):
    proc = _run_serve(arch, "--device", "cpu", "--batch", "2", "--prompt-len",
                      "16", "--gen", "4")
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout
    assert "decode" in proc.stdout and "tok/s" in proc.stdout


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serve_launcher_refuses_without_a_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = _run_serve(arch, "--batch", "2", "--prompt-len", "16", "--gen", "4")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
