"""The port's LM serving path against the JAX package's, on the CPU, for
each architecture it serves: mamba2-130m (the ssm family), granite-3-2b
and starcoder2-3b (the dense family; layernorm, the tanh-gelu MLP, G = 4
on its smoke config and 12 at full width).  Every test but the refusals of unported families and
features runs once per architecture.

- The full config's fields equal JAX's, and the full-width parameter
  tree (init on the ``meta`` device) has JAX's paths, shapes and dtypes
  (``jax.eval_shape``).
- On the smoke config in fp32, with JAX's weights carried by
  ``from_jax_params``: forward logits within rtol = atol = 1e-4; prefill
  logits and cache, then 8 teacher-forced decode steps fed JAX's tokens,
  within 3e-4 (the JAX package's own serve-consistency tolerance,
  ``tests/test_arch_smokes.py``); the port's own prefill + decode equal
  its forward within 3e-4.
- bfloat16 weights cross bit for bit, both ways.
- The launcher runs on the CPU when asked to and refuses without a card.
- ``build_model`` refuses a config by the features the port lacks, and
  builds a ported one whatever its name.

granite-3-2b's KV caches are written in place (``nn/attention.py``): its
prefill + decode test checks that the cache returned is the one given.
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
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.distributed import make_decode_step, make_prefill_step
from repro_torch.nn.models import CausalLM, build_model
from repro_torch.weights import from_jax_params, to_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ["mamba2-130m", "granite-3-2b", "starcoder2-3b"]
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
}
TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_jax(arch):
    port, ref = get_config(arch), jax_get_config(arch)
    a, b = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert str(a.pop("dtype")) == "torch.bfloat16"
    assert jnp.dtype(b.pop("dtype")).name == "bfloat16"
    assert a == b
    assert port.param_count_estimate() == ref.param_count_estimate()
    assert get_smoke(arch).dtype == torch.float32
    smoke, smoke_j = (dataclasses.asdict(c) for c in (get_smoke(arch),
                                                      jax_get_smoke(arch)))
    smoke.pop("dtype")
    smoke_j.pop("dtype")
    assert smoke == smoke_j


@pytest.mark.parametrize("arch", ["gemma-7b", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b"])
def test_unported_families_raise(arch):
    with pytest.raises(KeyError, match="queue 1, item 9"):
        get_config(arch)
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        build_model(jax_smoke_as_port(arch))


@pytest.mark.parametrize("override", [
    dict(family="moe"), dict(tie_embeddings=False), dict(n_experts=4),
    dict(scale_embed=True), dict(decode_kv_seqshard="model")],
    ids=lambda o: next(iter(o)))
def test_build_model_refuses_unported_features(override):
    """build_model refuses by what a config needs, not by its name."""
    cfg = get_smoke("granite-3-2b").with_overrides(**override)
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        build_model(cfg)
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        build_model(get_smoke("granite-3-2b"), tp=2)


def test_build_model_takes_a_renamed_config():
    cfg = get_smoke("granite-3-2b")
    model = build_model(cfg.with_overrides(name="granite-copy"))
    params = build_model(cfg).init(0, "cpu")
    toks = torch.from_numpy(_tokens(2, 9, cfg.vocab, 2)).long()
    assert torch.equal(model.forward(params, toks),
                       build_model(cfg).forward(params, toks))


def jax_smoke_as_port(arch):
    """A JAX smoke config's fields on the port's ModelConfig."""
    fields = dataclasses.asdict(jax_get_smoke(arch))
    fields["dtype"] = torch.float32
    return get_smoke("mamba2-130m").with_overrides(**fields)


@pytest.mark.parametrize("arch", ARCHS)
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
    want, _ = model_j.forward(params_j, jnp.asarray(toks))
    got = model.forward(params, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 40,
                                                        model.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    positions, on the port alone.  A Mamba cache given is never written; a
    KV cache is written in place and returned."""
    _, _, model, params = smoke
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(B, S, model.cfg.vocab, 4)).long()
    full = model.forward(params, toks)
    cache = model.init_cache(B, S + 4, dtype=torch.float32, device="cpu")
    pre, cache2 = model.prefill(params, toks[:, :S - 1], cache)
    torch.testing.assert_close(pre, full[:, S - 2], **SERVE_TOL)
    dec, cache3 = model.decode_step(params, toks[:, S - 1], cache2, S - 1)
    torch.testing.assert_close(dec, full[:, S - 1], **SERVE_TOL)
    if model.cfg.family == "ssm":
        assert all(float(t.abs().max()) == 0 for _, t in
                   tree_leaves_with_path(cache))
    else:
        assert cache3["slot0"]["kv"] is cache2["slot0"]["kv"] \
            is cache["slot0"]["kv"]
        k = cache["slot0"]["kv"].k
        assert float(k[:, :, S - 1].abs().max()) > 0
        assert float(k[:, :, S:].abs().max()) == 0


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
    logits = model.forward(params, toks)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


def _run_serve(arch, *flags):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", *flags], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_the_cpu(arch):
    proc = _run_serve(arch, "--device", "cpu", "--batch", "2", "--prompt-len",
                      "16", "--gen", "4")
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4) tokens" in proc.stdout
    assert "decode" in proc.stdout and "tok/s" in proc.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_refuses_without_a_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = _run_serve(arch, "--batch", "2", "--prompt-len", "16", "--gen", "4")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
