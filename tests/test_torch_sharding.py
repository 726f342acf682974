"""The port's sharding rules against the JAX package's, with no process.

- For every registered LM arch's full config and both CNNs, the port's
  ``param_pspec``, ``zero1_pspec``, ``fsdp_pspec`` (``state_pspec``),
  ``cache_pspec`` and ``batch_pspec`` equal JAX's leaf by leaf, as tuples,
  on the (16, 16) ("data", "model") and (2, 16, 16) ("pod", "data",
  "model") production meshes, and under the 2-D serve rule
  ``{"batch": (("pod",),)}``.  The JAX side resolves on a
  ``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` trees (no device,
  nothing allocated); the port's on a named shape over ``meta`` trees.
- JAX's own rule cases (``tests/test_distributed.py``): the divisibility
  fallback, the param-path patterns, the spec resolution on a fake mesh.
- ``attn_layout`` for tp in {1, 2, 4, 16} equal to JAX's for every arch.
- The smoke logits of ``build_model(cfg, tp=4)`` equal ``tp=1``'s and
  JAX's ``tp=4`` on one device, in fp32 (within 1e-5 of the largest
  |logit|: the padded layout regroups the same heads' sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import CNN_REGISTRY as JAX_CNNS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.distributed import sharding as jsh
from repro.distributed import steps as jsteps
from repro.nn.attention import attn_layout as jax_attn_layout
from repro.nn.conv import init_cnn as jax_init_cnn
from repro.nn.models import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, CNN_REGISTRY, get_config, get_smoke
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn.attention import attn_layout
from repro_torch.nn.conv import init_cnn
from repro_torch.nn.models import build_model
from repro_torch.weights import from_jax_params

MESHES = {"single": False, "multi": True}
SERVE_2D = {"batch": (("pod",),)}
CACHE_BATCH, CACHE_LEN, CROSS_LEN = 64, 4096, 1024
LOGIT_TOL = 1e-5


def _jax_mesh(multi: bool) -> AbstractMesh:
    if multi:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _jax_specs(tree) -> list:
    """[(path, spec tuple)] of a JAX spec tree, in ``jax.tree_util``
    order, trailing Nones kept as ``PartitionSpec`` keeps them."""
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [tuple(s) for s in leaves]


def _flat_port(tree) -> list:
    """[spec tuple] of a port spec tree, in ``core.tree`` order."""
    out = []

    def walk(node):
        if isinstance(node, sh.PartitionSpec):
            out.append(tuple(node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            for v in node:
                walk(v)
    walk(tree)
    return out


def _lm_trees(arch: str):
    """(JAX params, JAX cache, port params, port cache) as shape trees."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    p = m.init(0, "meta")
    if cfg.family == "encdec":
        jc = jax.eval_shape(lambda: jm.init_cache(CACHE_BATCH, CACHE_LEN,
                                                  CROSS_LEN))
        c = m.init_cache(CACHE_BATCH, CACHE_LEN, CROSS_LEN, device="meta")
    else:
        jc = jax.eval_shape(lambda: jm.init_cache(CACHE_BATCH, CACHE_LEN))
        c = m.init_cache(CACHE_BATCH, CACHE_LEN, device="meta")
    return jp, jc, p, c


_TREES = {}


def _trees(arch):
    if arch not in _TREES:
        _TREES[arch] = _lm_trees(arch)
    return _TREES[arch]


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_specs_match_jax(arch, mesh_kind):
    multi = MESHES[mesh_kind]
    jp, jc, p, c = _trees(arch)
    jmesh, mesh = _jax_mesh(multi), make_production_mesh(multi_pod=multi)
    with jsh.activate_mesh(jmesh) as jctx, sh.activate_mesh(mesh) as ctx:
        pairs = {
            "param": (jsh.param_pspec(jp, jctx), sh.param_pspec(p, ctx)),
            "zero1": (jsh.zero1_pspec(jp, jctx), sh.zero1_pspec(p, ctx)),
            "fsdp": (jsh.fsdp_pspec(jp, jctx), sh.fsdp_pspec(p, ctx)),
            "cache": (jsteps.cache_pspec(jc, jctx),
                      steps.cache_pspec(c, ctx)),
        }
        jstate = {"params": jp, "opt": {"m": jp, "v": jp,
                                        "step": jax.ShapeDtypeStruct(
                                            (), jnp.int32)}}
        pstate = {"params": p, "opt": {"m": p, "v": p,
                                       "step": torch.empty((),
                                                           device="meta")}}
        for fsdp in (False, True):
            pairs[f"state fsdp={fsdp}"] = (
                jsteps.state_pspec(jstate, jctx, fsdp=fsdp),
                steps.state_pspec(pstate, ctx, fsdp=fsdp))
        jb = {"tokens": jax.ShapeDtypeStruct((CACHE_BATCH, 4097), jnp.int32)}
        b = {"tokens": torch.empty((CACHE_BATCH, 4097), device="meta")}
        pairs["batch"] = (jsteps.batch_pspec(jb, jctx),
                          steps.batch_pspec(b, ctx))
    for what, (want, got) in pairs.items():
        want, got = _jax_specs(want), _flat_port(got)
        assert len(want) == len(got), what
        assert got == want, (arch, mesh_kind, what)
    # some leaf really is sharded on this mesh
    assert any(any(e is not None for e in s)
               for s in _flat_port(pairs["param"][1]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_2d_rule_matches_jax(arch):
    """The 2-D serve layout: batch over "pod" only, on the multi-pod
    mesh, for the cache and batch specs."""
    _, jc, _, c = _trees(arch)
    jmesh, mesh = _jax_mesh(True), make_production_mesh(multi_pod=True)
    with jsh.activate_mesh(jmesh, SERVE_2D) as jctx, \
            sh.activate_mesh(mesh, SERVE_2D) as ctx:
        want = _jax_specs(jsteps.cache_pspec(jc, jctx))
        got = _flat_port(steps.cache_pspec(c, ctx))
        jb = {"tokens": jax.ShapeDtypeStruct((CACHE_BATCH, 8), jnp.int32)}
        b = {"tokens": torch.empty((CACHE_BATCH, 8), device="meta")}
        want_b = _jax_specs(jsteps.batch_pspec(jb, jctx))
        got_b = _flat_port(steps.batch_pspec(b, ctx))
    assert got == want
    assert got_b == want_b == [("pod", None)]


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(CNN_REGISTRY))
def test_cnn_specs_match_jax(arch, mesh_kind):
    multi = MESHES[mesh_kind]
    jp = jax.eval_shape(lambda k: jax_init_cnn(k, JAX_CNNS[arch]),
                        jax.random.PRNGKey(0))
    p = init_cnn(0, CNN_REGISTRY[arch], device="meta")
    jmesh, mesh = _jax_mesh(multi), make_production_mesh(multi_pod=multi)
    with jsh.activate_mesh(jmesh) as jctx, sh.activate_mesh(mesh) as ctx:
        for jfn, fn in ((jsh.param_pspec, sh.param_pspec),
                        (jsh.zero1_pspec, sh.zero1_pspec),
                        (jsh.fsdp_pspec, sh.fsdp_pspec)):
            assert _flat_port(fn(p, ctx)) == _jax_specs(jfn(jp, jctx))
        got = _flat_port(sh.param_pspec(p, ctx))
    assert ("model" in got[1]) or any("model" in s for s in got)


# -- JAX's rule cases ---------------------------------------------------------

def test_logical_rules_divisibility_fallback():
    with sh.activate_mesh(sh.MeshShape(("model",), (1,))):
        # axis size 1 -> never shard
        assert sh.logical_to_spec(["heads"], [56]) == (None,)


def test_param_axis_patterns():
    assert sh.param_logical_axes("layer/q_proj/kernel", 2) == ("embed",
                                                               "qkv_dim")
    assert sh.param_logical_axes("stack/slot0/moe/experts/w_gate", 3) == \
        ("experts", "embed", "ff")
    assert sh.param_logical_axes("stack/slot0/attn/q_proj/kernel", 3) == \
        (None, "embed", "qkv_dim")
    assert sh.param_logical_axes("embed/table", 2) == ("vocab", "embed")
    assert sh.param_logical_axes("stack/slot0/mamba/conv1d/w", 3) == \
        (None, "conv_k", "d_inner")


def test_spec_resolution_on_fake_mesh():
    with sh.activate_mesh(sh.MeshShape(("data", "model"), (2, 4))):
        assert sh.logical_to_spec(["heads"], [56]) == ("model",)
        assert sh.logical_to_spec(["heads"], [55]) == (None,)
        assert sh.logical_to_spec(["batch", None], [8, 3]) == ("data", None)
        spec = sh.logical_to_spec(["heads", "ff"], [8, 8])
        assert tuple(spec) == ("model", None)
    assert sh.logical_to_spec(["heads"], [8]) == ()      # no mesh
    assert isinstance(sh.P("data", None), tuple)
    assert sh.P(("pod", "data"), None) == (("pod", "data"), None)


def test_shard_is_a_noop_without_a_mesh_or_on_plain_tensors():
    x = torch.ones(4, 8)
    assert sh.shard(x, "batch", "embed") is x
    with sh.activate_mesh(sh.MeshShape(("data", "model"), (2, 2))):
        assert sh.shard(x, "batch", "embed") is x


def test_production_meshes():
    single, multi = (make_production_mesh(), make_production_mesh(
        multi_pod=True))
    assert (single.axis_names, single.sizes) == (("data", "model"), (16, 16))
    assert (multi.axis_names, multi.sizes, multi.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)


# -- the TP head layout -------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_attn_layout_matches_jax(tp):
    seen = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.n_q or (cfg.n_q, cfg.n_kv) in seen:
            continue
        seen.add((cfg.n_q, cfg.n_kv))
        want = jax_attn_layout(cfg.n_q, cfg.n_kv, cfg.head_dim, tp)
        got = attn_layout(cfg.n_q, cfg.n_kv, cfg.head_dim, tp)
        assert tuple(got) == tuple(want), (arch, tp)
        assert (got.kv_eff, got.g_eff, got.n_q_pad) == (
            want.kv_eff, want.g_eff, want.n_q_pad)
    assert len(seen) >= 4


@pytest.mark.parametrize("arch", ["granite-3-2b", "llava-next-34b",
                                  "starcoder2-3b"])
def test_tp4_logits_equal_tp1_and_jax(arch):
    jcfg, cfg = jax_get_smoke(arch), get_smoke(arch)
    jm4 = jax_build_model(jcfg, tp=4)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    p = from_jax_params(jp, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    want = np.asarray(jm4.forward(jp, jnp.asarray(tokens, jnp.int32))[0])
    with torch.no_grad():
        got4 = build_model(cfg, tp=4).forward(p, torch.from_numpy(tokens))[0]
        got1 = build_model(cfg, tp=1).forward(p, torch.from_numpy(tokens))[0]
    lay = build_model(cfg, tp=4).spec.layout
    assert lay.kv_repeat > 1 or lay.g_pad != cfg.n_q // cfg.n_kv \
        or arch == "starcoder2-3b"
    scale = float(np.abs(want).max())
    assert float(np.abs(got4.numpy() - want).max()) <= LOGIT_TOL * scale
    assert float((got4 - got1).abs().max()) <= LOGIT_TOL * scale
