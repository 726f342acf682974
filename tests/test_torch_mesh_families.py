"""The mesh arms of the moe, hybrid, vlm and encdec families on the CPU: one
gloo spawn of 4 ranks (``init_method="file://..."``) on a (2, 2) ("data",
"model") mesh, the checks grouped in it.

For the smoke configs of arctic-480b (MoE with a dense residual, top-2),
llama4-maverick-400b-a17b (MoE with the shared expert, top-1),
jamba-1.5-large-398b (Mamba, attention and MoE slots), llava-next-34b
(``extra_embeds``) and seamless-m4t-large-v2 (``EncDecLM``, the cross-KV):

- one ``make_train_step`` step on the mesh (``build_model(cfg, tp=2)``,
  the state placed by ``state_pspec``) against the port's one-device step
  and the JAX package's single-device jitted step, within JAX's own
  bounds (loss < 1e-4, params < 5e-3: ``tests/test_distributed.py:
  122-123``);
- a prefill and 3 decode steps (the last with a per-row kv_length) on the
  mesh through the serve launcher's ``MeshStep`` against one device's
  logits within 1e-5, the caches placed by ``cache_pspec``: the experts
  cut over "model" (their local shard half the experts), jamba's Mamba
  state and conv window cut on their heads and channels and written in
  place, the cross-KV's heads cut;
- the ops each run gathered to ``Replicate()``, by name;
- arctic's MoE on its einsum arm (a train step against one device's), and
  with 3 experts on the 2-rank "model" axis (served: every expert on
  every rank, gathered by name as ``moe_experts``).
"""
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke as jax_get_smoke
from repro.distributed import StepConfig as JaxStepConfig
from repro.distributed import make_train_state as jax_make_train_state
from repro.distributed import make_train_step as jax_make_train_step
from repro.nn.models import build_model as jax_build_model
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path

LOSS_TOL, PARAM_TOL = 1e-4, 5e-3
DECODE_TOL = 1e-5
ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
         "llava-next-34b", "seamless-m4t-large-v2")
SCFG = dict(warmup_steps=1, total_steps=10)
#: the train batch (rows, target tokens) and the serve run's (rows, prompt
#: tokens, cache rows; encdec: source frames)
B, S = 4, 16
SB, SP, SMAX, SRC = 4, 8, 12, 10


def _store(d: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=world)


def _flat(tree) -> dict:
    return {p: np.asarray(a) for p, a in tree_leaves_with_path(tree)}


def _inputs(arch: str) -> dict:
    """The train batch and the serve inputs, from a seed."""
    cfg = jax_get_smoke(arch)
    rng = np.random.default_rng(3)
    f32 = np.float32
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32),
           "serve_tokens": rng.integers(0, cfg.vocab, (SB, SP)).astype(
               np.int64)}
    if cfg.family == "vlm":
        n = cfg.frontend_tokens
        out["extra_embeds"] = rng.normal(size=(B, n, cfg.d_model)).astype(f32)
        out["serve_extra"] = rng.normal(size=(SB, n, cfg.d_model)).astype(f32)
        out["tokens"] = out["tokens"][:, :S + 1 - n]
        out["serve_tokens"] = out["serve_tokens"][:, :SP - n]
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(size=(B, SRC, cfg.d_model)).astype(f32)
        out["serve_src"] = rng.normal(size=(SB, SRC, cfg.d_model)).astype(f32)
    return out


def _train_batch(z: dict) -> dict:
    return {k: z[k] for k in ("tokens", "extra_embeds", "src_embeds")
            if k in z}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Run the 4-rank checks once; returns (their results, the JAX train
    references)."""
    d = str(tmp_path_factory.mktemp("families"))
    refs = {}
    for arch in ARCHS:
        model = jax_build_model(jax_get_smoke(arch))
        state = jax_make_train_state(model, jax.random.PRNGKey(0))
        np.savez(os.path.join(d, f"init_{arch}.npz"),
                 **_flat(jax.tree_util.tree_map(np.asarray, state)))
        z = _inputs(arch)
        np.savez(os.path.join(d, f"in_{arch}.npz"), **z)
        new, mets = jax.jit(jax_make_train_step(
            model, JaxStepConfig(**SCFG)))(state, _train_batch(z))
        refs[arch] = (float(mets["loss"]), _flat(jax.tree_util.tree_map(
            np.asarray, new["params"])))
    torch.multiprocessing.spawn(_worker, args=(d,), nprocs=4)
    got = {arch: dict(np.load(os.path.join(d, f"out_{arch}.npz")))
           for arch in ARCHS + ("moe",)}
    return got, refs


def _unflatten_like(template, flat: dict):
    from repro_torch.core.tree import tree_unflatten
    return tree_unflatten(template, [torch.from_numpy(flat[p].copy())
                                     for p, _ in
                                     tree_leaves_with_path(template)])


def _serve(model, params, z, mesh=None):
    """A prefill and 3 greedy decode steps (the last with a per-row
    kv_length) on one device or, with ``mesh``, through ``MeshStep`` with
    the params and cache placed by ``serve_shardings``: (the logits of
    each, the cache)."""
    from repro_torch.distributed import make_decode_step, make_prefill_step
    from repro_torch.launch.serve import MeshStep, _place_on_mesh
    cfg = model.cfg
    toks = torch.from_numpy(z["serve_tokens"])
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch = {"src_embeds": torch.from_numpy(z["serve_src"]),
                 "tokens": toks}
        cache = model.init_cache(SB, SMAX, cross_len=SRC,
                                 dtype=torch.float32, device="cpu")
        pos0 = toks.shape[1]
    else:
        if "serve_extra" in z:
            batch["extra_embeds"] = torch.from_numpy(z["serve_extra"])
        cache = model.init_cache(SB, SMAX, dtype=torch.float32, device="cpu")
        pos0 = SP
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    if mesh is not None:
        params, cache = _place_on_mesh(model, params, cache, mesh)
        prefill, decode = MeshStep(prefill, mesh), MeshStep(decode, mesh)
    out = []
    with torch.no_grad():
        logits, cache = prefill(params, batch, cache)
        out.append(logits)
        tok = logits.argmax(-1)
        for i in range(3):
            kvl = (torch.tensor([pos0 + i + 1, 3, pos0 + i + 1, 2],
                                dtype=torch.int32) if i == 2 else None)
            logits, cache = decode(params, tok, cache, pos0 + i, kvl)
            out.append(logits)
            tok = logits.argmax(-1)
    return out, cache


def _worker(rank: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import (StepConfig, activate_mesh,
                                         gather_state, make_train_state,
                                         make_train_step, place_state,
                                         state_pspec)
    from repro_torch.distributed.sharding import REPLICATED_OPS
    from repro_torch.nn.models import build_model
    _store(d, rank, 4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        scfg = StepConfig(**SCFG)
        for arch in ARCHS:
            cfg = get_smoke(arch)
            model1, model2 = build_model(cfg), build_model(cfg, tp=2)
            template = make_train_state(model1, 0, "cpu")
            state = _unflatten_like(template, dict(np.load(os.path.join(
                d, f"init_{arch}.npz"))))
            z = dict(np.load(os.path.join(d, f"in_{arch}.npz")))
            batch = _train_batch(z)
            s1, m1 = make_train_step(model1, scfg)(state, batch)
            with activate_mesh(mesh) as ctx:
                placed = place_state(state, state_pspec(state, ctx), mesh)
            REPLICATED_OPS.clear()
            s2, m2 = make_train_step(model2, scfg, mesh)(placed, batch)
            res = {"replicated_train": np.array(sorted(REPLICATED_OPS)),
                   "loss1": float(m1["loss"]), "loss2": float(m2["loss"])}
            for (p, a), (_, b) in zip(
                    tree_leaves_with_path(s1["params"]),
                    tree_leaves_with_path(gather_state(s2)["params"])):
                res[f"p1/{p}"] = a.numpy()
                res[f"p2/{p}"] = b.numpy()
            # serving: one device against the mesh
            params = state["params"]
            REPLICATED_OPS.clear()
            one, _ = _serve(model1, params, z)
            two, cache = _serve(model2, params, z, mesh)
            res["replicated_serve"] = np.array(sorted(REPLICATED_OPS))
            res["serve_gap"] = np.array([float((a - b).abs().max())
                                         for a, b in zip(one, two)])
            res["serve_scale"] = float(max(a.abs().max() for a in one))
            leaves = dict(tree_leaves_with_path(cache))
            for p, t in leaves.items():
                res[f"cache_local/{p}"] = np.array(t.to_local().shape)
                res[f"cache_global/{p}"] = np.array(t.shape)
            if cfg.n_experts:
                w = s2["params"]["stack"]
                slot = next(k for k in w if "moe" in w[k])
                g = w[slot]["moe"]["experts"]["w_gate"]
                res["experts_local"] = np.array(g.to_local().shape)
                res["experts_global"] = np.array(g.shape)
            if rank == 0:
                np.savez(os.path.join(d, f"out_{arch}.npz"), **res)
        # the MoE's einsum arm (a train step), and experts that do not
        # divide the model axis (served, every expert on every rank)
        res = {}
        for tag, over, train in (("einsum", {"moe_impl": "einsum"}, True),
                                 ("uneven", {"n_experts": 3}, False)):
            cfg = get_smoke("arctic-480b").with_overrides(**over)
            model1, model2 = build_model(cfg), build_model(cfg, tp=2)
            state = make_train_state(model1, 0, "cpu")
            z = dict(np.load(os.path.join(d, "in_arctic-480b.npz")))
            REPLICATED_OPS.clear()
            if train:
                s1, m1 = make_train_step(model1, scfg)(state,
                                                       _train_batch(z))
                with activate_mesh(mesh) as ctx:
                    placed = place_state(state, state_pspec(state, ctx),
                                         mesh)
                s2, m2 = make_train_step(model2, scfg, mesh)(
                    placed, _train_batch(z))
                res[f"{tag}/loss"] = abs(float(m1["loss"])
                                         - float(m2["loss"]))
                res[f"{tag}/params"] = max(
                    float((a - b).abs().max()) for a, b in zip(
                        tree_leaves(s1["params"]),
                        tree_leaves(gather_state(s2)["params"])))
            one, _ = _serve(model1, state["params"], z)
            two, _ = _serve(model2, state["params"], z, mesh)
            res[f"{tag}/serve_gap"] = max(float((a - b).abs().max())
                                          for a, b in zip(one, two))
            res[f"{tag}/replicated"] = np.array(sorted(REPLICATED_OPS))
        if rank == 0:
            np.savez(os.path.join(d, "out_moe.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_one_device_and_jax(world4, arch):
    got, refs = world4
    t = got[arch]
    jax_loss, jax_params = refs[arch]
    assert abs(float(t["loss2"]) - float(t["loss1"])) < LOSS_TOL
    assert abs(float(t["loss2"]) - jax_loss) < LOSS_TOL
    paths = [k[3:] for k in t if k.startswith("p2/")]
    assert sorted(paths) == sorted(jax_params)
    for p in paths:
        mesh = t[f"p2/{p}"].astype(np.float32)
        one = t[f"p1/{p}"].astype(np.float32)
        assert np.abs(mesh - one).max() < PARAM_TOL, p
        assert np.abs(mesh - jax_params[p].astype(np.float32)).max() \
            < PARAM_TOL, p


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_matches_one_device(world4, arch):
    """The prefill's and 3 decode steps' logits within 1e-5 of one
    device's (fp32)."""
    t = world4[0][arch]
    gap = t["serve_gap"]
    assert gap.shape == (4,)
    assert float(gap.max()) < DECODE_TOL, (gap, float(t["serve_scale"]))


#: what each arch's cache holds cut over "model" = 2 on the mesh: a
#: leaf's path fragment and the dim its local shard halves (a MambaCache
#: is (conv window (NP, B, K-1, CC), state (NP, B, H, P, S)))
CUT = {"jamba-1.5-large-398b": (("mamba/1", 2), ("mamba/0", 3)),
       "seamless-m4t-large-v2": (("cross_kv", 3),),
       "llava-next-34b": (("kv_seq", 2),),
       "arctic-480b": (("kv_seq", 2),),
       "llama4-maverick-400b-a17b": (("kv_seq", 2),)}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_layouts(world4, arch):
    """The caches' local shards are cut as ``cache_pspec`` says (batch over
    "data" = 2, the named dims over "model" = 2), and the experts' local
    shard holds half of them."""
    t = world4[0][arch]
    for frag, dim in CUT[arch]:
        keys = [k[len("cache_local/"):] for k in t
                if k.startswith("cache_local/") and frag in k]
        assert keys, frag
        for k in keys:
            g = tuple(t[f"cache_global/{k}"])
            loc = tuple(t[f"cache_local/{k}"])
            want = list(g)
            want[1] //= 2
            want[dim] //= 2
            assert loc == tuple(want), (k, g, loc)
    if "experts_local" in t:
        g, loc = tuple(t["experts_global"]), tuple(t["experts_local"])
        assert loc[1] == g[1] // 2, (g, loc)   # (n_periods, E, d, ff)


#: the ops each arch's (2, 2) train step and serve run gather by name
REPLICATED = {
    "arctic-480b": (["softmax_xent"], []),
    "llama4-maverick-400b-a17b": (["softmax_xent"], []),
    "jamba-1.5-large-398b": (["mamba_in_proj_split", "softmax_xent"],
                             ["mamba_in_proj_split"]),
    "llava-next-34b": (["softmax_xent"], []),
    "seamless-m4t-large-v2": (["mask_pad_logits", "softmax_xent"],
                              ["drop_pad_logits"]),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_ops_are_named(world4, arch):
    from repro_torch.distributed.sharding import REPLICATED_OP_NAMES
    t = world4[0][arch]
    train, serve = (list(t[k]) for k in ("replicated_train",
                                         "replicated_serve"))
    assert set(train) | set(serve) <= set(REPLICATED_OP_NAMES)
    assert (train, serve) == REPLICATED[arch]


def test_moe_einsum_arm_and_uneven_experts(world4):
    t = world4[0]["moe"]
    assert float(t["einsum/loss"]) < LOSS_TOL
    assert float(t["einsum/params"]) < PARAM_TOL
    assert float(t["einsum/serve_gap"]) < DECODE_TOL
    assert float(t["uneven/serve_gap"]) < DECODE_TOL
    assert "moe_experts" in list(t["uneven/replicated"])
    assert "moe_experts" not in list(t["einsum/replicated"])
