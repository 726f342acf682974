"""The port's compile-once executables, on the CPU: what the CUDA graphs of
``repro_torch/engine/graphs.py`` rest on, held against the JAX package.

On the card the LM decode step and every CNN bucket executable are
captured once per key and replayed; on the CPU they stay the eager
callables, and these tests hold what a replay needs of them:

- for the granite-3-2b and mamba2-130m smoke configs, ``decode_step`` with
  ``pos`` a 0-d tensor equals the int-``pos`` call bit for bit (logits and
  caches), and writes its caches in place: the attention KV cache and the
  Mamba conv window and state keep their ``data_ptr()`` over the steps,
  and the cache returned is the one given;
- 8 greedy steps through the launcher's ``decode_executable`` /
  ``run_decode`` (a device position, the argmax token fed back) pick the
  JAX package's tokens, and the step fed JAX's tokens at ``jnp.int32``
  positions gives its logits within ``tests/test_torch_lm.py``'s serve
  tolerance (rtol = atol = 3e-4);
- the eager decode executable warms on a copy of the cache, and a second
  generation on one engine runs through the same executable;
- ``graphs`` refuses a CPU device, counts a replay's launches into the
  wrappers' counters, and names the source line a failed capture broke
  at; ``Executable`` on the CPU is its eager ``forward``.

The replays themselves are the ``gpu`` tests of ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.nn.models import build_model as jax_build_model
from repro_torch.configs import CNN_SMOKES, get_smoke
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import make_decode_step
from repro_torch.engine import ExecutionPolicy, graphs, plan_model
from repro_torch.kernels import flash_attention, trim_conv2d, trim_matmul
from repro_torch.launch.serve import decode_executable, run_decode
from repro_torch.nn.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.weights import from_jax_params

ARCHS = ["mamba2-130m", "granite-3-2b"]
SERVE_TOL = dict(rtol=3e-4, atol=3e-4)
B, S, STEPS = 2, 11, 8


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    cfg_j = jax_get_smoke(request.param)
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(request.param))
    return model_j, params_j, model, from_jax_params(params_j, "cpu")


def _prompt(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _prefilled(model, params, toks):
    cache = model.init_cache(B, S + STEPS + 1, dtype=torch.float32,
                             device="cpu")
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks).long(),
                                      cache)
    return logits, cache


def test_tensor_pos_equals_int_pos_bit_for_bit(smoke):
    _, _, model, params = smoke
    logits, cache = _prefilled(model, params, _prompt(model.cfg.vocab))
    other = tree_map(torch.clone, cache)
    tok = logits.argmax(-1)
    with torch.inference_mode():
        for i in range(STEPS):
            a, cache = model.decode_step(params, tok, cache, S + i)
            b, other = model.decode_step(params, tok, other,
                                         torch.tensor(S + i))
            assert torch.equal(a, b), i
            for x, y in zip(tree_leaves(cache), tree_leaves(other)):
                assert torch.equal(x, y), i
            tok = a.argmax(-1)


def test_tensor_pos_with_explicit_kv_length(smoke):
    """A per-row ``kv_length`` given with a tensor ``pos`` is used as it
    is, as with an int ``pos``."""
    _, _, model, params = smoke
    logits, cache = _prefilled(model, params, _prompt(model.cfg.vocab, 4))
    other = tree_map(torch.clone, cache)
    kvl = torch.tensor([S + 1, 3], dtype=torch.int32)
    tok = logits.argmax(-1)
    with torch.inference_mode():
        a, _ = model.decode_step(params, tok, cache, S, kv_length=kvl)
        b, _ = model.decode_step(params, tok, other, torch.tensor(S),
                                 kv_length=kvl)
    assert torch.equal(a, b)


def test_decode_writes_its_caches_in_place(smoke):
    """The cache returned is the one given, and every leaf (the KV cache
    of granite-3-2b, the conv window and SSM state of mamba2-130m) keeps
    its storage over the steps while its values move."""
    _, _, model, params = smoke
    logits, cache = _prefilled(model, params, _prompt(model.cfg.vocab, 5))
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    pos = torch.tensor(S)
    tok = logits.argmax(-1)
    with torch.inference_mode():
        for _ in range(3):
            before = [t.clone() for t in tree_leaves(cache)]
            out, got = model.decode_step(params, tok, cache, pos)
            assert got is cache
            assert [t.data_ptr() for t in tree_leaves(cache)] == ptrs
            assert any(not torch.equal(x, y)
                       for x, y in zip(before, tree_leaves(cache)))
            tok = out.argmax(-1)
            pos += 1


def test_greedy_decode_matches_jax(smoke):
    """8 greedy steps after a prefill: the launcher's decode loop (device
    position, argmax fed back) picks JAX's tokens, and the step fed JAX's
    tokens at ``jnp.int32`` positions gives JAX's logits."""
    model_j, params_j, model, params = smoke
    toks = _prompt(model.cfg.vocab, 6)
    cache_j = model_j.init_cache(B, S + STEPS + 1, dtype=jnp.float32)
    logits_j, cache_j = model_j.prefill(params_j, jnp.asarray(toks), cache_j)
    want_tok, want_logits = [], []
    tok_j = jnp.argmax(logits_j, -1).astype(jnp.int32)
    first = np.asarray(tok_j)
    for i in range(STEPS):
        logits_j, cache_j = model_j.decode_step(params_j, tok_j, cache_j,
                                                jnp.int32(S + i))
        want_logits.append(np.asarray(logits_j))
        tok_j = jnp.argmax(logits_j, -1).astype(jnp.int32)
        want_tok.append(np.asarray(tok_j))

    logits, cache = _prefilled(model, params, toks)
    tok = logits.argmax(-1)
    assert np.array_equal(tok.numpy(), first)
    eng = ServeEngine(name="lm", buckets=(B,), device="cpu")
    decode = decode_executable(eng, model, params, tok, cache, S)
    got, _, _, finite = run_decode(decode, params, tok, cache, S, STEPS,
                                   torch.device("cpu"))
    assert finite
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  np.stack(want_tok))

    _, cache = _prefilled(model, params, toks)
    step = make_decode_step(model)
    feed = [first] + want_tok[:-1]
    with torch.inference_mode():
        for i in range(STEPS):
            tok = torch.from_numpy(np.array(feed[i])).long()
            out, cache = step(params, tok, cache,
                              torch.tensor(S + i, dtype=torch.int32))
            np.testing.assert_allclose(out.numpy(), want_logits[i],
                                       err_msg=f"step {i}", **SERVE_TOL)


def test_eager_decode_executable_warms_on_a_copy(smoke):
    """Building the decode executable leaves the cache as it was: its
    warm call runs on a copy, since decode advances the state it is
    given."""
    _, _, model, params = smoke
    logits, cache = _prefilled(model, params, _prompt(model.cfg.vocab, 7))
    before = [t.clone() for t in tree_leaves(cache)]
    eng = ServeEngine(name="lm", buckets=(B,), device="cpu")
    decode = decode_executable(eng, model, params, logits.argmax(-1),
                               cache, S)
    for x, y in zip(before, tree_leaves(cache)):
        assert torch.equal(x, y)
    assert eng.compile_counts == {next(iter(eng.compile_counts)): 1}
    assert eng.capture_counts == {}
    assert decode_executable(eng, model, params, logits.argmax(-1), cache,
                             S) is decode


def test_two_generations_on_one_engine(smoke):
    """The decode executable is built once per (arch, batch): a second
    generation, on a new prompt's cache, runs through the same one and
    picks the tokens it picks alone on a fresh engine."""
    _, _, model, params = smoke

    def generate(eng, seed):
        logits, cache = _prefilled(model, params, _prompt(model.cfg.vocab,
                                                          seed))
        tok = logits.argmax(-1)
        decode = decode_executable(eng, model, params, tok, cache, S)
        got, _, _, finite = run_decode(decode, params, tok, cache, S,
                                       STEPS, torch.device("cpu"))
        assert finite
        return decode, torch.stack(got)

    eng = ServeEngine(name="lm", buckets=(B,), device="cpu")
    first, _ = generate(eng, 8)
    again, toks = generate(eng, 9)
    assert again is first and set(eng.compile_counts.values()) == {1}
    _, alone = generate(ServeEngine(name="lm", buckets=(B,), device="cpu"),
                        9)
    assert torch.equal(toks, alone)


def test_graphs_refuse_a_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.GraphPool("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        ServeEngine(name="x", buckets=(1,), device="cpu").graph_pool()


def test_replay_counts_the_launches_recorded():
    """A replay runs no Python: it adds the launches one call recorded to
    every wrapper's counter, the matmul's per path too."""

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    out = torch.zeros(2)
    g = graphs.CapturedGraph(
        Graph(), out, "fake",
        {"trim_conv2d": 13, "flash_attention": 40, "trim_matmul": 2,
         "trim_matmul.stream": 2}, {})
    before = graphs.launch_counts()
    try:
        for _ in range(3):
            assert g.replay() is out
        after = graphs.launch_counts()
        delta = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert delta == {"trim_conv2d": 39, "flash_attention": 120,
                         "trim_matmul": 6, "trim_matmul.stream": 6}
        assert Graph.replays == 3
    finally:
        graphs._add_launches({k: -v for k, v in delta.items()})
    assert graphs.launch_counts() == before
    assert trim_conv2d.LAUNCHES == before["trim_conv2d"]
    assert flash_attention.LAUNCHES == before["flash_attention"]
    assert trim_matmul.LAUNCHES_BY_PATH["stream"] == \
        before["trim_matmul.stream"]


def test_capture_error_names_the_line_that_broke():
    """The origin of a failed capture is the first error's line outside
    torch (the end of the capture raises its own error on top)."""
    def step():
        return torch.ones(3).sum().item() + undefined  # noqa: F821

    try:
        try:
            step()
        except NameError:
            raise RuntimeError("the end of the capture")
    except RuntimeError as err:
        where = graphs._origin(err)
    assert "test_torch_graphs.py" in where and ".item()" in where
    assert "NameError" in where


@pytest.mark.parametrize("work", ["cut", "pre-pass"])
def test_capture_refuses_a_recorded_weight_cut_or_pre_pass(work):
    """A recording that cut a grouped layer's weights or wrote u8 x s8
    transposed weights raises: each would run again on every replay."""
    from repro_torch.engine import execute

    before = graphs._weight_work()
    graphs._refuse_weight_work("fake", before)       # nothing moved
    mod, attr = ((execute, "GROUP_CUTS") if work == "cut"
                 else (trim_conv2d, "PREPASSES"))
    setattr(mod, attr, getattr(mod, attr) + 1)
    try:
        with pytest.raises(graphs.CaptureError,
                           match="grouped weight cuts, which every replay"):
            graphs._refuse_weight_work("fake", before)
    finally:
        setattr(mod, attr, getattr(mod, attr) - 1)
    assert graphs._weight_work() == before


def test_executable_on_the_cpu_is_its_eager_forward():
    cfg = CNN_SMOKES["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy())
    params = plan.init(0, "cpu")
    ex = plan.executable_for(2, "float", device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        ex.shape).astype(np.float32))
    assert torch.equal(ex(params, imgs), ex.forward(params, imgs))
    with pytest.raises(ValueError, match="executable takes"):
        ex(params, imgs[:1])


def test_grouped_weights_are_cut_once_per_tensor():
    """AlexNet's grouped convs (the smoke shapes with CL2 and CL3 in 2
    groups) on the int8 lane: the first call cuts each grouped layer's
    weights and requant pairs into per-group pieces and keeps them, a
    second call cuts nothing (so a captured bucket records no slice copy
    and no weight pre-pass), an in-place update of a weight cuts that
    tensor again, and the features stay bit-equal to the oracle
    substrate's.  Tensors that autograd records, and inference tensors,
    are cut on every call."""
    from repro_torch.engine import execute
    from test_torch_cuda import alexnet_grouped_smoke

    cfg = alexnet_grouped_smoke()
    plan = plan_model(cfg, ExecutionPolicy("kernel"))
    oracle = plan_model(cfg, ExecutionPolicy("oracle"))
    assert [lp.groups for lp in plan.layers] == [1, 2, 2]
    qp, _ = plan.quantize(plan.init(0, "cpu"))
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 23, 23, 3)).astype(np.uint8))
    requant = plan.calibrate_requant(qp, images)
    want = oracle.forward_int8(qp, images, requant=requant)
    ex = plan.executable_for(4, "int8", "cpu")
    counts = []
    for _ in range(2):
        before = execute.GROUP_CUTS
        assert torch.equal(ex(qp, images, requant), want)
        counts.append(execute.GROUP_CUTS - before)
    # the first call cuts what calibration did not (CL2's requant pairs
    # at least); the second finds every piece kept
    assert counts[0] >= 2 and counts[1] == 0
    w = qp["conv"][1]["kernel"]
    pieces = execute.group_parts(w, 2, w.shape[-1])
    assert all(not p.is_inference() for p in pieces)
    with torch.no_grad():
        w.add_(0)                                   # a new version
    assert execute.group_parts(w, 2, w.shape[-1])[0] is not pieces[0]
    before = execute.GROUP_CUTS
    assert torch.equal(ex(qp, images, requant), want)
    assert execute.GROUP_CUTS - before == 0       # cut by the call above
    f = torch.randn(3, 3, 4, 8, requires_grad=True)
    parts = execute.group_parts(f, 2, 8)
    assert parts[0].requires_grad
    assert execute.group_parts(f, 2, 8)[0] is not parts[0]
    with torch.inference_mode():
        t = torch.randn(3, 3, 4, 8)
    assert execute.group_parts(t, 2, 8)[0] is not \
        execute.group_parts(t, 2, 8)[0]
    with torch.no_grad():
        kept = execute.group_parts(f, 2, 8)
        assert execute.group_parts(f, 2, 8)[0] is kept[0]
