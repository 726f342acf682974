"""``StackSpec.remat`` in the port (``nn/blocks.py:remat_period``) on the
CPU, against itself and against the JAX package's ``jax.checkpoint``.

On the smoke configs of the dense (granite-3-2b), ssm (mamba2-130m) and
moe (arctic-480b) families, in fp32:

- with ``remat`` none / dots / full the loss and every leaf's gradient
  are bit-equal to each other (a recompute runs the same operators on the
  same inputs);
- at "dots" the port matches the JAX package at "dots" within the
  tolerances of ``tests/test_torch_lm_train.py`` (loss rtol 1e-5, each
  leaf's gradient within a relative norm error of 1e-4);
- a ``TorchDispatchMode`` counts the operators of a forward and backward:
  "dots" runs the projection products (``aten.mm``) no more often than
  "none" (saved) but recomputes the rest, "full" recomputes the
  products too;
- under ``torch.no_grad()`` and inference mode no checkpoint is entered
  (forward, prefill and decode), so the decode graphs capture as before;
  under grad one is entered per period;
- the dry-run's train cell on a fake world of 8 peaks lower at "dots"
  than at "none", and lower still at "full", and counts the recompute's
  flops; ``run_cell`` records the config's remat;
- the mesh train step (DTensor state, ``tp=2`` on a (1, 2) gloo mesh of
  spawned ranks) gives the same loss and params at none / dots / full,
  bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke as jax_get_smoke
from repro.nn.models import build_model as jax_build_model
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeCell
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.engine import ExecutionPolicy
from repro_torch.nn import blocks
from repro_torch.nn.models import build_model
from repro_torch.weights import from_jax_params

FAMILIES = ["granite-3-2b", "mamba2-130m", "arctic-480b"]
REMATS = ("none", "dots", "full")
LOSS_RTOL = 1e-5
REL_GRAD = 1e-4
#: a train cell whose activations outweigh the smoke model's state
CELL = ShapeCell("train_remat", "train", 64, 128)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, vocab, (2, 19)).astype(
        np.int32)


class _Ops(TorchDispatchMode):
    """Counts every aten operator run under it."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(arch: str, remat: str, params_np=None, count=False):
    cfg = get_smoke(arch).with_overrides(remat=remat, dtype=torch.float32)
    model = build_model(cfg, policy=ExecutionPolicy("kernel"))
    params = (model.init(0, "cpu") if params_np is None
              else from_jax_params(params_np, "cpu"))
    live = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = torch.from_numpy(_tokens(cfg.vocab))
    mode = _Ops()
    if count:
        with mode:
            loss, mets = model.loss(params, {"tokens": toks})
            grads = torch.autograd.grad(loss, live)
    else:
        loss, mets = model.loss(params, {"tokens": toks})
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), mets, grads, params, mode.n


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_modes_are_bit_equal(arch):
    ref_loss, ref_mets, ref_g, params, _ = _loss_and_grads(arch, "none")
    for remat in ("dots", "full"):
        loss, mets, grads, _, _ = _loss_and_grads(arch, remat)
        assert torch.equal(loss, ref_loss), remat
        for k in ref_mets:
            assert torch.equal(mets[k].detach(), ref_mets[k].detach()), k
        for (path, _), a, b in zip(tree_leaves_with_path(params), grads,
                                   ref_g):
            assert torch.equal(a, b), (remat, path)


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_matches_jax_dots(arch):
    cfg_j = jax_get_smoke(arch).with_overrides(remat="dots")
    model_j = jax_build_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    toks = _tokens(cfg_j.vocab)
    (want, _), grads_j = jax.value_and_grad(model_j.loss, has_aux=True)(
        params_j, {"tokens": jnp.asarray(toks)})
    loss, _, grads, params, _ = _loss_and_grads(arch, "dots", params_j)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    want_g = tree_leaves_with_path(grads_j)
    assert [p for p, _ in want_g] == [p for p, _ in
                                      tree_leaves_with_path(params)]
    for (path, gj), g in zip(want_g, grads):
        assert _rel(g.numpy(), np.asarray(gj)) <= REL_GRAD, path


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_saves_the_projections_and_full_saves_none(arch):
    n = {r: _loss_and_grads(arch, r, count=True)[-1] for r in REMATS}
    mm = torch.ops.aten.mm.default
    recomputed = [op for op in n["none"] if op not in blocks.SAVED_DOTS
                  and n["dots"].get(op, 0) > n["none"][op]]
    # "dots": every projection product saved, the rest recomputed
    assert n["dots"][mm] == n["none"][mm]
    assert recomputed
    # "full": the products recomputed too, and what "dots" recomputes
    # (bar the detaches, which the saved products' cache adds)
    assert n["full"][mm] > n["none"][mm]
    for op in recomputed:
        if op != torch.ops.aten.detach.default:
            assert n["full"].get(op, 0) > n["none"][op], op


@pytest.mark.parametrize("arch", FAMILIES)
def test_no_checkpoint_without_a_graph(arch, monkeypatch):
    entered = []
    real = blocks.checkpoint

    def spy(*a, **kw):
        entered.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(blocks, "checkpoint", spy)
    cfg = get_smoke(arch).with_overrides(remat="dots", dtype=torch.float32)
    model = build_model(cfg, policy=ExecutionPolicy("kernel"))
    params = model.init(0, "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab)).long()

    def serve():
        cache = model.init_cache(toks.shape[0], 32, dtype=torch.float32,
                                 device="cpu")
        _, cache = model.prefill(params, toks, cache)
        model.decode_step(params, toks[:, 0], cache,
                          torch.tensor(toks.shape[1]))

    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            model.forward(params, toks)
            serve()
    serve()          # under grad too: a cache is written in place
    assert not entered
    model.forward(params, toks)
    assert len(entered) == model.spec.n_periods


def test_dryrun_train_cell_peaks_lower_under_remat():
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    dryrun._fake_world(8)
    try:
        mesh = init_device_mesh("cpu", (8, 1),
                                mesh_dim_names=("data", "model"))
        rec = {r: dryrun.run_recorded(
            get_smoke("granite-3-2b").with_overrides(remat=r, n_layers=4),
            CELL, mesh)[0] for r in REMATS}
        assert rec["dots"].peak < rec["none"].peak
        assert rec["full"].peak < rec["dots"].peak
        assert rec["none"].flops < rec["dots"].flops < rec["full"].flops
        for r in ("none", "dots"):
            got = dryrun.run_cell("granite-3-2b", CELL, False, mesh=mesh,
                                  cfg_overrides={"remat": r})
            assert got["remat"] == r
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- the mesh train step on spawned gloo ranks ---------------------------------

def _mesh_worker(rank: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import (StepConfig, activate_mesh,
                                         gather_state, make_train_state,
                                         make_train_step, place_state,
                                         state_pspec)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        res = {}
        for arch in ("granite-3-2b", "arctic-480b"):
            vocab = get_smoke(arch).vocab
            batch = {"tokens": np.random.default_rng(0).integers(
                0, vocab, (4, 17)).astype(np.int32)}
            for remat in REMATS:
                model = build_model(get_smoke(arch).with_overrides(
                    remat=remat), tp=2)
                state = make_train_state(model, 0, "cpu")
                with activate_mesh(mesh) as ctx:
                    specs = state_pspec(state, ctx)
                placed = place_state(state, specs, mesh)
                new, mets = make_train_step(
                    model, StepConfig(warmup_steps=1, total_steps=10),
                    mesh)(placed, batch)
                full = gather_state(new)
                res[f"{arch}/{remat}/loss"] = float(mets["loss"])
                for p, a in tree_leaves_with_path(full["params"]):
                    res[f"{arch}/{remat}/{p}"] = a.float().numpy()
        if rank == 0:
            np.savez(os.path.join(d, "remat.npz"), **res)
    finally:
        dist.destroy_process_group()


def test_mesh_train_step_is_bit_equal_under_remat(tmp_path):
    torch.multiprocessing.spawn(_mesh_worker, args=(str(tmp_path),),
                                nprocs=2)
    res = dict(np.load(tmp_path / "remat.npz"))
    for arch in ("granite-3-2b", "arctic-480b"):
        keys = [k.split("/", 2)[2] for k in res
                if k.startswith(f"{arch}/none/")]
        assert len(keys) > 2
        for remat in ("dots", "full"):
            for k in keys:
                np.testing.assert_array_equal(
                    res[f"{arch}/{remat}/{k}"], res[f"{arch}/none/{k}"],
                    err_msg=f"{arch} {remat} {k}")
