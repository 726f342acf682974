"""The port's distributed layer on the CPU: gloo process groups of spawned
processes (``init_method="file://..."``, so no port is raced for), the
checks grouped per spawn.

- The mesh train step (``make_train_step(model, scfg, mesh)``) on a
  (2, 2) ("data", "model") mesh, one step: granite-3-2b's smoke config at
  ``tp=2``, VGG-16's smoke shapes and mamba2-130m's smoke config, each
  held to the port's one-device step and to the JAX package's
  single-device jitted step within JAX's own bounds (loss < 1e-4, params
  < 5e-3: ``tests/test_distributed.py:122-123``).  The local shard shapes
  are the specs' (``q_proj`` at model=2 holds half its columns; ZeRO-1
  moments their ``data`` shard).
- The elastic restore: a run on (2, 2) saves through ``train_loop``; a run
  on (4, 1) resumes from it: the restored state equals the saved one and
  the resumed step equals the step from that state placed directly, bit
  for bit.
- The sequence-sharded decode across 4 ranks (model=4) and in the "2d"
  mode on (2, 2): prefill, then 3 decode steps (the last with a per-row
  kv_length); outputs and the gathered caches equal JAX's
  ``seqshard_flash_decode`` without a mesh within fp32 1e-5.
- ``compressed_grads``: JAX's ``test_compressed_grads_close_and_ef``
  case on (4, 2) (rel < 0.02 against the uncompressed grads, the error
  feedback > 0); at world 1 the int8 codes equal those of JAX's
  ``compressed_grads`` on a (1, 1) mesh and the scales agree within 1
  ulp; the world-1 mesh step equals the one-device step bit for bit, and
  serving on the (1, 1) mesh equals one device.
- ``pipeline_run``: 4 stages x 2, tanh stages, within 1e-6 of the
  sequential loop (JAX's case).
- Serving on the mesh (the serve launcher's ``MeshStep``): granite-3-2b
  and llava-next-34b at ``tp=2`` on (2, 2), prefill and 3 decode steps
  within 1e-5 of one device's logits.
- The launcher under ``torchrun`` on the CPU: ``--tp 2
  --compress-grads --device cpu`` on a smoke config.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import CNN_SMOKES as JAX_CNN_SMOKES
from repro.configs import get_smoke as jax_get_smoke
from repro.distributed import StepConfig as JaxStepConfig
from repro.distributed import make_train_state as jax_make_train_state
from repro.distributed import make_train_step as jax_make_train_step
from repro.distributed.compression import compressed_grads as jax_compressed
from repro.engine import plan_model as jax_plan_model
from repro.nn.decode_attn import seqshard_flash_decode as jax_seqshard
from repro.nn.models import build_model as jax_build_model
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, PARAM_TOL = 1e-4, 5e-3
DECODE_TOL = 1e-5
ARCHS = ("granite-3-2b", "vgg16", "mamba2-130m")
SCFG = dict(warmup_steps=1, total_steps=10)
# the sequence-sharded decode: B, S (cache rows), n_q, n_kv, D, prefill rows
SEQ = dict(B=2, S=16, n_q=4, n_kv=2, D=8, S0=9)


def _store(d: str, rank: int, world: int) -> None:
    # one thread a rank, as torchrun sets: the ranks share the CPU with
    # each other and with the test run's other workers
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=world)


def _flat(tree) -> dict:
    return {p: np.asarray(a) for p, a in tree_leaves_with_path(tree)}


# -- references, made in the parent ------------------------------------------

def _jax_model(arch):
    if arch == "vgg16":
        return jax_plan_model(JAX_CNN_SMOKES["vgg16"])
    return jax_build_model(jax_get_smoke(arch))


def _batch(arch):
    rng = np.random.default_rng(0)
    if arch == "vgg16":
        return {"images": rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
                "labels": rng.integers(0, 10, (4,)).astype(np.int32)}
    vocab = jax_get_smoke(arch).vocab
    return {"tokens": rng.integers(0, vocab, (4, 17)).astype(np.int32)}


def _seq_inputs():
    """The decode inputs: a prefilled unrepeated cache and 3 steps' q and
    new K/V, and JAX's outputs and caches without a mesh."""
    B, S, n_q, n_kv, D, S0 = (SEQ[k] for k in
                              ("B", "S", "n_q", "n_kv", "D", "S0"))
    rng = np.random.default_rng(5)
    f = np.float32
    pre_k = rng.standard_normal((B, S0, n_kv, D)).astype(f)
    pre_v = rng.standard_normal((B, S0, n_kv, D)).astype(f)
    ins = {"pre_k": pre_k, "pre_v": pre_v}
    kc = jnp.zeros((B, S, n_kv, D), jnp.float32).at[:, :S0].set(pre_k)
    vc = jnp.zeros((B, S, n_kv, D), jnp.float32).at[:, :S0].set(pre_v)
    want = {}
    for i in range(3):
        ins[f"q{i}"] = rng.standard_normal((B, 1, n_q, D)).astype(f)
        ins[f"k{i}"] = rng.standard_normal((B, 1, n_kv, D)).astype(f)
        ins[f"v{i}"] = rng.standard_normal((B, 1, n_kv, D)).astype(f)
        kvl = np.array([S0 + i + 1, 3], np.int32) if i == 2 else None
        if kvl is not None:
            ins["kvl"] = kvl
        o, kc, vc = jax_seqshard(
            jnp.asarray(ins[f"q{i}"]), kc, vc, jnp.asarray(ins[f"k{i}"]),
            jnp.asarray(ins[f"v{i}"]), jnp.int32(S0 + i),
            kv_length=None if kvl is None else jnp.asarray(kvl))
        want[f"o{i}"] = np.asarray(o)
    want["k"], want["v"] = np.asarray(kc), np.asarray(vc)
    return ins, want


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Run the 4-rank checks once; returns (their results, the JAX
    train references, the JAX decode references)."""
    d = str(tmp_path_factory.mktemp("world4"))
    refs = {}
    for arch in ARCHS:
        model = _jax_model(arch)
        state = jax_make_train_state(model, jax.random.PRNGKey(0))
        np.savez(os.path.join(d, f"init_{arch}.npz"),
                 **_flat(jax.tree_util.tree_map(np.asarray, state)))
        batch = _batch(arch)
        np.savez(os.path.join(d, f"batch_{arch}.npz"), **batch)
        new, mets = jax.jit(jax_make_train_step(
            model, JaxStepConfig(**SCFG)))(state, batch)
        refs[arch] = (float(mets["loss"]), _flat(jax.tree_util.tree_map(
            np.asarray, new["params"])))
    ins, want = _seq_inputs()
    np.savez(os.path.join(d, "seq.npz"), **ins)
    torch.multiprocessing.spawn(_worker4, args=(d,), nprocs=4)
    got = {k: dict(np.load(os.path.join(d, f"{k}.npz")))
           for k in ("train", "restore", "seq", "serve")}
    return got, refs, want


def _unflatten_like(template, flat: dict):
    from repro_torch.core.tree import tree_unflatten
    return tree_unflatten(template, [torch.from_numpy(flat[p].copy())
                                     for p, _ in
                                     tree_leaves_with_path(template)])


def _port_model(arch, tp=1):
    from repro_torch.configs import CNN_SMOKES, get_smoke
    from repro_torch.engine import ExecutionPolicy, plan_model
    from repro_torch.nn.models import build_model
    if arch == "vgg16":
        return plan_model(CNN_SMOKES["vgg16"], ExecutionPolicy())
    return build_model(get_smoke(arch), tp=tp)


def _worker4(rank: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint.manager import restore_pytree
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import (StepConfig, TrainLoopConfig,
                                         activate_mesh, gather_state,
                                         make_train_state, make_train_step,
                                         place_state, state_pspec,
                                         train_loop)
    from repro_torch.distributed.sharding import REPLICATED_OPS, to_placements
    from repro_torch.nn.decode_attn import (seqshard_flash_decode,
                                            seqshard_prefill_write)
    from repro_torch.nn.attention import KVCache
    _store(d, rank, 4)
    try:
        m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))
        m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data",
                                                              "model"))
        m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data",
                                                              "model"))
        res = {}
        scfg = StepConfig(**SCFG)
        # the mesh train step against the one-device step
        for arch in ARCHS:
            model1 = _port_model(arch)
            model2 = _port_model(arch, tp=2)
            template = make_train_state(model1, 0, "cpu")
            state = _unflatten_like(template, dict(np.load(os.path.join(
                d, f"init_{arch}.npz"))))
            batch = dict(np.load(os.path.join(d, f"batch_{arch}.npz")))
            s1, m1 = make_train_step(model1, scfg)(state, batch)
            with activate_mesh(m22) as ctx:
                specs = state_pspec(state, ctx)
            placed = place_state(state, specs, m22)
            REPLICATED_OPS.clear()
            s2, m2 = make_train_step(model2, scfg, m22)(placed, batch)
            res[f"{arch}/replicated"] = np.array(sorted(REPLICATED_OPS))
            full = gather_state(s2)
            res[f"{arch}/loss1"] = float(m1["loss"])
            res[f"{arch}/loss2"] = float(m2["loss"])
            for (p, a), (_, b) in zip(tree_leaves_with_path(s1["params"]),
                                      tree_leaves_with_path(full["params"])):
                res[f"{arch}/p1/{p}"] = a.numpy()
                res[f"{arch}/p2/{p}"] = b.numpy()
            if arch == "granite-3-2b":
                q = s2["params"]["stack"]["slot0"]["attn"]["q_proj"]["kernel"]
                mq = s2["opt"]["m"]["stack"]["slot0"]["attn"]["q_proj"][
                    "kernel"]
                res["q_local"] = np.array(q.to_local().shape)
                res["q_global"] = np.array(q.shape)
                res["m_local"] = np.array(mq.to_local().shape)
                res["m_spec"] = np.array([str(e) for e in specs["opt"]["m"][
                    "stack"]["slot0"]["attn"]["q_proj"]["kernel"]])
        if rank == 0:
            np.savez(os.path.join(d, "train.npz"), **res)

        # the elastic restore: saved on (2, 2), resumed on (4, 1)
        model = _port_model("granite-3-2b", tp=2)
        cfg = model.cfg
        ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=17, global_batch=4,
                                seed=0)
        ck = os.path.join(d, "ckpt")
        quiet = {"log_fn": lambda *_: None}
        st = make_train_state(model, 0, "cpu")
        with activate_mesh(m22) as ctx:
            specs22 = state_pspec(st, ctx)
        with activate_mesh(m41) as ctx:
            specs41 = state_pspec(st, ctx)
        a = train_loop(make_train_step(model, scfg, m22),
                       place_state(st, specs22, m22), ds,
                       TrainLoopConfig(total_steps=1, ckpt_every=1,
                                       ckpt_dir=ck), **quiet)
        saved = gather_state(a["state"])
        dist.barrier()
        other = place_state(make_train_state(model, 1, "cpu"), specs41, m41)
        b = train_loop(make_train_step(model, scfg, m41), other, ds,
                       TrainLoopConfig(total_steps=2, ckpt_every=10,
                                       ckpt_dir=ck), **quiet)
        restored = gather_state(restore_pytree(other, os.path.join(
            ck, "step_1")))
        c, _ = make_train_step(model, scfg, m41)(
            place_state(saved, specs41, m41), ds.batch_at(1))
        pairs = [(x, y) for x, y in zip(tree_leaves(restored),
                                        tree_leaves(saved))]
        res2 = {"resumed_from": np.array(b["resumed_from"]),
                "restored_equal": np.array(all(torch.equal(x, y)
                                               for x, y in pairs)),
                "resumed_equal": np.array(all(
                    torch.equal(x, y) for x, y in zip(
                        tree_leaves(gather_state(b["state"])),
                        tree_leaves(gather_state(c))))),
                "placements": np.array(str(tree_leaves(b["state"])[0]
                                           .placements))}
        if rank == 0:
            np.savez(os.path.join(d, "restore.npz"), **res2)

        # the sequence-sharded decode: model=4, and "2d" on (2, 2)
        z = dict(np.load(os.path.join(d, "seq.npz")))
        out = {}
        for tag, mesh, axes in (("m4", m14, ("model",)),
                                ("2d", m22, ("data", "model"))):
            B, S, n_kv, D = SEQ["B"], SEQ["S"], SEQ["n_kv"], SEQ["D"]
            pl = to_placements((None, axes if len(axes) > 1 else axes[0]),
                               mesh)
            kc, vc = (distribute_tensor(torch.zeros(B, S, n_kv, D), mesh, pl,
                                        src_data_rank=None)
                      for _ in range(2))
            with activate_mesh(mesh):
                seqshard_prefill_write(KVCache(kc, vc),
                                       torch.from_numpy(z["pre_k"]),
                                       torch.from_numpy(z["pre_v"]), axes)
                for i in range(3):
                    o, kc, vc = seqshard_flash_decode(
                        torch.from_numpy(z[f"q{i}"]), kc, vc,
                        torch.from_numpy(z[f"k{i}"]),
                        torch.from_numpy(z[f"v{i}"]), SEQ["S0"] + i,
                        kv_length=(torch.from_numpy(z["kvl"]) if i == 2
                                   else None), axes=axes)
                    out[f"{tag}/o{i}"] = o.numpy()
            out[f"{tag}/k"] = kc.full_tensor().numpy()
            out[f"{tag}/v"] = vc.full_tensor().numpy()
            out[f"{tag}/local_rows"] = np.array(kc.to_local().shape[1])
        if rank == 0:
            np.savez(os.path.join(d, "seq.npz"), **out)

        # serving on the mesh: prefill + 3 decode steps against one device
        srv = {}
        for arch in ("granite-3-2b", "llava-next-34b"):
            srv[arch], srv[f"{arch}/placements"] = _serve_gap(arch, 2, m22)
        if rank == 0:
            np.savez(os.path.join(d, "serve.npz"), **srv)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_one_device_and_jax(world4, arch):
    got, refs, _ = world4
    t = got["train"]
    jax_loss, jax_params = refs[arch]
    assert abs(t[f"{arch}/loss2"] - t[f"{arch}/loss1"]) < LOSS_TOL
    assert abs(t[f"{arch}/loss2"] - jax_loss) < LOSS_TOL
    paths = [k[len(arch) + 4:] for k in t if k.startswith(f"{arch}/p2/")]
    assert sorted(paths) == sorted(jax_params)
    for p in paths:
        mesh = t[f"{arch}/p2/{p}"].astype(np.float32)
        one = t[f"{arch}/p1/{p}"].astype(np.float32)
        assert np.abs(mesh - one).max() < PARAM_TOL, p
        assert np.abs(mesh - jax_params[p].astype(np.float32)).max() \
            < PARAM_TOL, p


#: the ops each arch's (2, 2) step gathers to Replicate(), by name
REPLICATED = {"granite-3-2b": ["mask_pad_logits", "softmax_xent"],
              "vgg16": ["cnn_flatten", "cnn_xent"],
              "mamba2-130m": ["mamba_in_proj_split", "softmax_xent"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_ops_are_named(world4, arch):
    """The ops the mesh step gathers because no DTensor rule keeps their
    shards are counted in ``sharding.REPLICATED_OPS`` by name (the TP
    gaps ROADMAP lists), and these are all each arch's step gathers."""
    from repro_torch.distributed.sharding import REPLICATED_OP_NAMES
    got = list(world4[0]["train"][f"{arch}/replicated"])
    assert got == REPLICATED[arch]
    assert set(got) <= set(REPLICATED_OP_NAMES)


def test_local_shard_shapes(world4):
    t = world4[0]["train"]
    q_global, q_local = tuple(t["q_global"]), tuple(t["q_local"])
    # (n_periods, d_model, n_q D): q_proj's columns over model=2
    assert q_local == q_global[:2] + (q_global[2] // 2,)
    # ZeRO-1: the moment's largest unsharded dim over data=2 as well
    assert tuple(t["m_spec"]) == ("None", "data", "model")
    assert tuple(t["m_local"]) == (q_global[0], q_global[1] // 2,
                                   q_global[2] // 2)


def test_elastic_restore_resumes_bit_for_bit(world4):
    r = world4[0]["restore"]
    assert int(r["resumed_from"]) == 1
    assert bool(r["restored_equal"]) and bool(r["resumed_equal"])
    assert "Shard" in str(r["placements"]) or "Replicate" in str(
        r["placements"])


@pytest.mark.parametrize("tag", ["m4", "2d"])
def test_seqshard_decode_across_ranks_matches_jax(world4, tag):
    got, _, want = world4
    s = got["seq"]
    assert int(s[f"{tag}/local_rows"]) == SEQ["S"] // 4
    for i in range(3):
        np.testing.assert_allclose(s[f"{tag}/o{i}"], want[f"o{i}"],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(s[f"{tag}/{kv}"], want[kv],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)


def test_serving_on_the_mesh_matches_one_device(world4):
    """granite-3-2b (the KV cache's heads over "model") and
    llava-next-34b (its sequence over "model": the multi-rank decode arm)
    at tp=2 on (2, 2): the prefill's and 3 decode steps' logits (the last
    with a per-row kv_length) within 1e-5 of one device's."""
    s = world4[0]["serve"]
    for arch in ("granite-3-2b", "llava-next-34b"):
        assert float(s[arch]) < DECODE_TOL, arch
    assert "Shard(dim=3)" in str(s["granite-3-2b/placements"])
    assert "Shard(dim=2)" in str(s["llava-next-34b/placements"])


def _serve_gap(arch: str, tp: int, mesh):
    """The serve launcher's ``MeshStep`` on ``mesh``: a prefill and 3
    decode steps (the last with a per-row kv_length) against one device;
    (the largest logit gap, the cache's first leaf's placements)."""
    from repro_torch.distributed import make_decode_step, make_prefill_step
    from repro_torch.launch.serve import MeshStep, _place_on_mesh
    model = _port_model(arch, tp=tp)
    params = model.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (4, 8)))
    c1 = model.init_cache(4, 12, dtype=torch.float32, device="cpu")
    p2, c2 = _place_on_mesh(model, params, model.init_cache(
        4, 12, dtype=torch.float32, device="cpu"), mesh)
    with torch.no_grad():
        l1, c1 = make_prefill_step(model)(params, {"tokens": toks}, c1)
    l2, c2 = MeshStep(make_prefill_step(model), mesh)(p2, {"tokens": toks},
                                                       c2)
    worst = float((l1 - l2).abs().max())
    tok = l1.argmax(-1)
    for i in range(3):
        kvl = (torch.tensor([9 + i, 5, 9 + i, 2], dtype=torch.int32)
               if i == 2 else None)
        with torch.no_grad():
            l1, c1 = make_decode_step(model)(params, tok, c1, 8 + i,
                                             kv_length=kvl)
        l2, c2 = MeshStep(make_decode_step(model), mesh)(p2, tok, c2, 8 + i,
                                                          kvl)
        worst = max(worst, float((l1 - l2).abs().max()))
        tok = l1.argmax(-1)
    return worst, str(tree_leaves(c2)[0].placements)


# -- 8 ranks: compressed gradients on (4, 2) and the pipeline -----------------

def _compress_case():
    key = jax.random.PRNGKey(0)
    p = {"w": np.asarray(jax.random.normal(key, (16, 8)))}
    b = {"x": np.asarray(jax.random.normal(key, (32, 16))),
         "y": np.asarray(jax.random.normal(key, (32, 8)))}
    return p, b


def _mse(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), {}


def _worker8(rank: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.compression import compressed_grads
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  pipeline_run)
    _store(d, rank, 8)
    try:
        z = dict(np.load(os.path.join(d, "in.npz")))
        p = {"w": torch.from_numpy(z["w"])}
        b = {"x": torch.from_numpy(z["x"]), "y": torch.from_numpy(z["y"])}
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data",
                                                               "model"))
        live = p["w"].clone().requires_grad_(True)
        g1 = torch.autograd.grad(_mse({"w": live}, b)[0], live)[0]
        (_, _), g2 = compressed_grads(_mse, p, b, mesh)
        ef = {"w": torch.zeros(4, 8)}   # dim 0 (16) over the 4 DP ranks
        (_, _), g3, ef2 = compressed_grads(_mse, p, b, mesh, ef)
        rel = float((g2["w"] - g1).abs().max() / g1.abs().max())
        resid = float(ef2["w"].abs().max())
        pmesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("pod",
                                                                "data"))
        sp = {"w": torch.from_numpy(z["sw"])}
        xs = torch.from_numpy(z["xs"])
        out = pipeline_run(lambda q, x: torch.tanh(x @ q["w"]), sp, xs,
                           mesh=pmesh, axis="pod")
        ref = xs
        for s in range(4):
            ref = torch.tanh(ref @ sp["w"][s])
        err = float((out - ref).abs().max())
        if rank == 0:
            np.savez(os.path.join(d, "out.npz"), rel=rel, resid=resid,
                     g3=(g3["w"] - g1).abs().max().numpy(), err=err,
                     bubble=bubble_fraction(6, 4))
    finally:
        dist.destroy_process_group()


def test_compressed_grads_and_pipeline_on_eight_ranks(tmp_path):
    p, b = _compress_case()
    key = jax.random.PRNGKey(0)
    sw = np.asarray(jax.random.normal(key, (4, 8, 8)) * 0.5)
    xs = np.asarray(jax.random.normal(key, (6, 3, 8)))
    np.savez(tmp_path / "in.npz", w=p["w"], x=b["x"], y=b["y"], sw=sw, xs=xs)
    torch.multiprocessing.spawn(_worker8, args=(str(tmp_path),), nprocs=8)
    r = np.load(tmp_path / "out.npz")
    assert float(r["rel"]) < 0.02          # the int8 quantization bound
    assert float(r["resid"]) > 0           # EF holds the residual
    assert float(r["g3"]) < 0.02 * 10
    assert float(r["err"]) < 1e-6
    assert float(r["bubble"]) == pytest.approx(3 / 9)


# -- world 1: the int8 codes against JAX's, the mesh step against one device --

def _worker1(rank: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import (StepConfig, activate_mesh,
                                         gather_state, make_train_state,
                                         make_train_step, place_state,
                                         state_pspec)
    from repro_torch.distributed.compression import (compressed_grads,
                                                     quantize_int8)
    _store(d, rank, 1)
    try:
        z = dict(np.load(os.path.join(d, "in.npz")))
        p = {"w": torch.from_numpy(z["w"])}
        b = {"x": torch.from_numpy(z["x"]), "y": torch.from_numpy(z["y"])}
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        live = p["w"].clone().requires_grad_(True)
        g = torch.autograd.grad(_mse({"w": live}, b)[0], live)[0]
        codes, scale = quantize_int8(g)
        (_, _), deq = compressed_grads(_mse, p, b, mesh)
        # the world-1 mesh step against the one-device step (VGG-16 smoke)
        model = _port_model("vgg16")
        state = make_train_state(model, 0, "cpu")
        batch = _batch("vgg16")
        scfg = StepConfig(**SCFG)
        s1, m1 = make_train_step(model, scfg)(state, batch)
        with activate_mesh(mesh) as ctx:
            placed = place_state(state, state_pspec(state, ctx), mesh)
        s2, m2 = make_train_step(model, scfg, mesh)(placed, batch)
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(s1), tree_leaves(gather_state(s2))))
        serve = _serve_gap("granite-3-2b", 1, mesh)
        np.savez(os.path.join(d, "out.npz"), codes=codes.numpy(),
                 scale=scale.numpy(), deq=deq["w"].numpy(),
                 losses=np.array([float(m1["loss"]), float(m2["loss"])]),
                 same=same, serve=serve)
    finally:
        dist.destroy_process_group()


def test_world_one_codes_equal_jax_and_step_equals_one_device(tmp_path):
    p, b = _compress_case()
    mesh = jax.make_mesh((1, 1), ("data", "model"))

    def loss_fn(pp, bb):
        return jnp.mean((bb["x"] @ pp["w"] - bb["y"]) ** 2), {}
    with mesh:
        (_, _), g_full = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        (_, _), deq_j = jax.jit(lambda pp, bb: jax_compressed(
            loss_fn, pp, bb, mesh))(p, b)
    g_full, deq_j = np.asarray(g_full["w"]), np.asarray(deq_j["w"])
    scale_j = np.float32(max(np.abs(g_full).max(), 1e-30)) / np.float32(127)
    codes_j = np.round(deq_j / scale_j).astype(np.int8)
    np.savez(tmp_path / "in.npz", **p, **b)
    torch.multiprocessing.spawn(_worker1, args=(str(tmp_path),), nprocs=1)
    r = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(r["codes"], codes_j)
    assert abs(float(r["scale"][0]) - float(scale_j)) <= np.spacing(scale_j)
    np.testing.assert_allclose(r["deq"], deq_j, rtol=1e-6, atol=0)
    assert r["losses"][0] == r["losses"][1] and bool(r["same"])
    gap, placements = r["serve"]
    assert float(gap) < DECODE_TOL, placements   # serving at world 1


# -- the launcher under torchrun ----------------------------------------------

def test_launcher_under_torchrun_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-3-2b", "--smoke", "--tp", "2",
         "--compress-grads", "--steps", "2", "--batch", "4", "--seq", "16",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh {'data': 1, 'model': 2}, int8 gradients" in proc.stdout
    assert "[train] granite-3-2b-smoke on cpu: steps 0-1" in proc.stdout
    assert proc.stdout.count("[train] granite-3-2b-smoke") == 1  # rank 0
