"""The steps.  Training: loss -> gradients (through the TrIM backward on
the kernel substrate) -> AdamW, with gradient accumulation and the
non-finite step skip.  Serving an LM: the prefill and decode steps
(``repro/distributed/steps.py:195-210``).  And the specs that place them
on a mesh: :func:`batch_pspec`, :func:`state_pspec`, :func:`cache_pspec`,
:func:`serve_shardings`, with :func:`place_state` (the analogue of
``jax.device_put`` with shardings).

Port of ``repro/distributed/steps.py``.  The JAX step is a pure function
of (state, batch) under ``jit``; this one runs eagerly and is pure in the
same sense: it returns a new state and leaves the one it was given
untouched.

On a mesh (``make_train_step(model, scfg, mesh)``, a ``DeviceMesh``) the
state is DTensors placed by :func:`state_pspec` (params by their TP
specs, or FSDP's; the AdamW moments by ZeRO-1's; the count replicated),
the batch is cut over the DP axes, and the model runs on DTensors under
``activate_mesh`` (its ``shard()`` points and ``local_map``'d kernels).
Each gradient is reduced to its param's placement; AdamW runs on the
ZeRO-1 shards, and the new params are gathered back to their specs.
With ``compress_grads`` the params enter the forward replicated over the
DP axes, and each rank's gradient contribution is summed over them on
the int8 wire (``distributed.compression``), with error feedback where
the state holds an ``ef`` tree (:func:`add_ef`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.tree import (tree_leaves, tree_map,
                                   tree_map_with_path, tree_unflatten)
from repro_torch.distributed import compression
from repro_torch.distributed.sharding import (P, MeshContext, activate_mesh,
                                              fsdp_pspec, is_dtensor,
                                              logical_to_spec, param_pspec,
                                              to_placements, zero1_pspec)
from repro_torch.engine.policy import resolve_device
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)


@dataclass(frozen=True)
class StepConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    accum: int = 1                    # gradient-accumulation microbatches
    skip_nonfinite: bool = True       # NaN/Inf step -> keep old state
    compress_grads: bool = False      # int8 DP gradient reduction


def make_train_state(model, seed, device="cuda") -> Dict[str, Any]:
    """{"params": model.init(seed, device), "opt": adamw_init(params)};
    ``seed`` is an int or a ``torch.Generator`` on ``device``."""
    params = model.init(seed, resolve_device(device))
    return {"params": params, "opt": adamw_init(params)}


def train_state_shapes(model) -> Dict[str, Any]:
    """The train state's tree on the ``meta`` device: shapes and dtypes,
    nothing allocated."""
    return make_train_state(model, 0, "meta")


def batch_pspec(batch_shapes, ctx: Optional[MeshContext] = None):
    """Every batch leaf's dim 0 over the DP axes; the rest replicated."""
    def one(leaf):
        shape = tuple(leaf.shape)
        return logical_to_spec(["batch"] + [None] * (len(shape) - 1), shape,
                               ctx)
    return tree_map(one, batch_shapes)


def state_pspec(state_shapes, ctx: Optional[MeshContext] = None,
                fsdp: bool = False):
    """Params by their TP specs (FSDP's with ``fsdp``), the AdamW moments
    by ZeRO-1's, the count replicated; an ``ef`` tree (compressed
    gradients' error feedback, one per-rank shard) is left out."""
    pfn = fsdp_pspec if fsdp else param_pspec
    return {
        "params": pfn(state_shapes["params"], ctx),
        "opt": {
            "m": zero1_pspec(state_shapes["opt"]["m"], ctx),
            "v": zero1_pspec(state_shapes["opt"]["v"], ctx),
            "step": P(),
        },
    }


def cache_pspec(cache_shapes, ctx: Optional[MeshContext] = None):
    """KV caches (NP, B, S, kv_eff, D): batch over DP, kv heads over model;
    the sequence-sharded caches (``kv_seq``, ``kv_seq2``) their sequence
    axis; Mamba caches: the SSD state (NP, B, H, P, S) its heads over
    model, the conv window (NP, B, K-1, CC) its channels."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if "mamba" in path:
            axes = ([None, "batch", "heads", None, None] if ndim == 5
                    else [None, "batch", None, "d_inner"])
        elif "kv_seq2" in path:          # 2d serve: seq over data+model
            axes = [None, "batch_pod", "kv_seq2", None, None]
        elif "kv_seq" in path:           # seq-sharded unrepeated KV
            axes = [None, "batch", "kv_seq", None, None]
        elif ndim == 5:                  # stacked (cross-)KV (NP,B,S,H,D)
            axes = [None, "batch", "kv_len", "kv_heads", None]
        else:
            axes = [None, "batch"] + [None] * max(ndim - 2, 0)
        axes = axes[:ndim] + [None] * (ndim - len(axes))
        return logical_to_spec(axes, shape, ctx)
    return tree_map_with_path(one, cache_shapes)


def serve_shardings(model, cache_shapes, mesh):
    """(param spec tree, cache spec tree) of an LM on ``mesh`` (a
    ``DeviceMesh`` or a named shape)."""
    with activate_mesh(mesh) as ctx:
        pspec = param_pspec(model.init(0, "meta"), ctx)
        cspec = cache_pspec(cache_shapes, ctx)
    return pspec, cspec


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def place_state(state, specs, mesh):
    """Each tensor leaf of ``state`` as a DTensor on ``mesh`` placed by its
    spec in ``specs`` (a tree of :class:`~repro_torch.distributed.
    sharding.PartitionSpec`).  Every rank holds the same full leaf (made
    from one seed, or restored), so each takes its own shard without
    communication.  Leaves of ``state`` outside ``specs`` (an ``ef``
    tree) pass through."""
    from torch.distributed.tensor import distribute_tensor

    def walk(node, spec):
        if spec is None:
            return node
        if isinstance(node, torch.Tensor):
            if is_dtensor(node):
                return node.redistribute(mesh, to_placements(spec, mesh))
            return distribute_tensor(node, mesh, to_placements(spec, mesh),
                                     src_data_rank=None)
        if isinstance(node, dict):
            return {k: walk(v, spec.get(k) if isinstance(spec, dict)
                            else None) for k, v in node.items()}
        kids = [walk(v, spec[i]) for i, v in enumerate(node)]
        return type(node)(*kids) if hasattr(node, "_fields") \
            else type(node)(kids)
    return walk(state, specs)


def gather_state(state):
    """``state`` with every DTensor leaf gathered whole
    (``full_tensor()``) on each rank: JAX's mesh-agnostic form."""
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t,
                    state)


def add_ef(state, mesh):
    """``state`` with an error-feedback tree for compressed gradients:
    per-rank fp32 zeros shaped like each compressible gradient's
    reduce-scattered shard (``compression.init_ef``)."""
    _, _, world = compression.dp_group(mesh)
    leaves = tree_leaves(state["params"])
    dev = leaves[0].to_local().device if is_dtensor(leaves[0]) \
        else leaves[0].device
    shapes = tree_map(lambda p: torch.empty(_dp_local_shape(p, mesh),
                                            device="meta"), state["params"])
    return {**state, "ef": compression.init_ef(shapes, world, dev)}


def _dp_replicated(t, mesh):
    """Placements of DTensor ``t`` with its DP-axis shards replicated."""
    from torch.distributed.tensor import Replicate
    dp = compression.dp_axes(mesh)
    return [Replicate() if n in dp else p
            for n, p in zip(mesh.mesh_dim_names, t.placements)]


def _dp_local_shape(t, mesh) -> tuple:
    """The local shape of ``t`` with its DP-axis shards replicated: the
    shape its gradient has on this rank in the compressed step."""
    shape = list(t.shape)
    if is_dtensor(t):
        for i, p in enumerate(_dp_replicated(t, mesh)):
            if p.is_shard():
                shape[p.dim] //= mesh.size(i)
    return tuple(shape)


def _loss_fn(model, params, batch):
    out = model.loss(params, batch)
    if isinstance(out, tuple) and isinstance(out[1], dict):
        return out
    return out, {}


def make_train_step(model, scfg: StepConfig = StepConfig(),
                    mesh=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``model`` has ``loss(params, batch) -> (loss, metrics)`` (a
    ``ModelPlan``).  ``batch`` is a dict of arrays or tensors with the
    batch first; it is moved to the params' device.  The metrics are
    0-dim tensors: loss, lr, the model's own, grad_norm, param_norm and
    skipped.
    """
    if mesh is not None:
        return _make_mesh_train_step(model, scfg, mesh)
    if scfg.accum < 1:
        raise ValueError(f"accum must be >= 1, got {scfg.accum}")

    def grads_of(params, batch):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, mets = _loss_fn(model, tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in mets.items()},
                tree_unflatten(params, list(grads)))

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if scfg.accum > 1:
            n = scfg.accum
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=dev), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                mb_loss, mets, g = grads_of(params, mb)
                g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
                loss = loss + mb_loss
            grads = tree_map(lambda g: g / n, g_acc)
            loss = loss / n
        else:
            loss, mets, grads = grads_of(params, batch)

        lr = warmup_cosine(opt["step"], peak_lr=scfg.peak_lr,
                           warmup_steps=scfg.warmup_steps,
                           total_steps=scfg.total_steps)
        new_params, new_opt, opt_mets = adamw_update(grads, opt, params, lr,
                                                     scfg.adamw)
        if scfg.skip_nonfinite:
            ok = torch.isfinite(loss) & torch.isfinite(opt_mets["grad_norm"])
            # the new trees' leaves are this step's own tensors: on a bad
            # step each takes its old value in place, one leaf at a time,
            # so no second copy of the state is ever held
            for a, b in zip(tree_leaves((new_params, new_opt)),
                            tree_leaves((params, opt))):
                a.copy_(torch.where(ok, a, b))
            opt_mets["skipped"] = (~ok).to(torch.float32)
        metrics = {"loss": loss, "lr": lr, **mets, **opt_mets}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def _make_mesh_train_step(model, scfg: StepConfig, mesh) -> Callable:
    """``make_train_step`` on a ``DeviceMesh``: the state placed by
    :func:`state_pspec` (:func:`place_state`), the batch global."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"the mesh arm runs on a DeviceMesh, not "
                        f"{type(mesh).__name__}")
    if scfg.accum < 1:
        raise ValueError(f"accum must be >= 1, got {scfg.accum}")
    group, _, world = compression.dp_group(mesh)
    compress = scfg.compress_grads and bool(compression.dp_axes(mesh))

    def grads_of(params, batch, ef):
        """(loss, mets, grads on each param's placement, new ef)."""
        leaves = tree_leaves(params)
        if compress:   # the DP reduction is ours: params DP-replicated
            leaves = [p.redistribute(mesh, _dp_replicated(p, mesh))
                      for p in leaves]
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, mets = _loss_fn(model, tree_unflatten(params, live), batch)
            grads = list(torch.autograd.grad(loss, live))
        new_ef = ef
        if compress:
            grads, new_ef = _compressed(grads, live, ef)
        grads = [g.redistribute(mesh, p.placements)
                 for g, p in zip(grads, tree_leaves(params))]
        return (loss.detach(), {k: v.detach() for k, v in mets.items()},
                tree_unflatten(params, grads), new_ef)

    def _compressed(grads, live, ef):
        """Each gradient's DP contributions (its Partial placements on the
        DP axes) summed on the int8 wire; the model axis as DTensor has
        it."""
        from torch.distributed.tensor import Replicate
        dp = compression.dp_axes(mesh)
        local = []
        for g, p in zip(grads, live):
            want = [p_g if n in dp else pl for n, p_g, pl in
                    zip(mesh.mesh_dim_names, g.placements, p.placements)]
            g = g.redistribute(mesh, want)
            for n, pl in zip(mesh.mesh_dim_names, g.placements):
                if n in dp and not (pl.is_partial() or pl.is_replicate()):
                    raise RuntimeError(f"a gradient sharded over {n}: "
                                       f"{g.placements}")
            local.append((g, g.to_local()))
        partial = [any(pl.is_partial() for n, pl in
                       zip(mesh.mesh_dim_names, g.placements) if n in dp)
                   for g, _ in local]
        # a contribution replicated over DP (no batch-dependent path) is
        # already the sum: it is divided by the world before the sum
        contribs = [t if part else t / world
                    for (_, t), part in zip(local, partial)]
        flat_e = tree_leaves(ef) if ef is not None else None
        red, new_e = compression.reduce_grads(
            contribs, flat_e, group, world)
        out = []
        for (g, _), r in zip(local, red):
            pl = [Replicate() if n in dp else q
                  for n, q in zip(mesh.mesh_dim_names, g.placements)]
            out.append(DTensor.from_local(r.to(g.dtype), mesh, pl,
                                          run_check=False))
        new_ef = tree_unflatten(ef, new_e) if ef is not None else None
        return out, new_ef

    def place_batch(batch, ctx):
        """Each leaf cut over the DP axes (a DTensor passes as placed)."""
        spec = batch_pspec(batch, ctx)
        return {k: v if is_dtensor(v) else distribute_tensor(
            v, mesh, to_placements(spec[k], mesh), src_data_rank=None)
            for k, v in batch.items()}

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        ef = state.get("ef")
        dev = tree_leaves(params)[0].to_local().device
        batch = {k: v if is_dtensor(v) else torch.as_tensor(v, device=dev)
                 for k, v in batch.items()}
        with activate_mesh(mesh) as ctx:
            if scfg.accum > 1:
                n = scfg.accum
                g_acc, loss = None, 0.0
                for i in range(n):
                    mb = {k: v.reshape((n, v.shape[0] // n)
                                       + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                    mb_loss, mets, g, ef = grads_of(
                        params, place_batch(mb, ctx), ef)
                    g = tree_map(lambda t: t.float(), g)
                    g_acc = g if g_acc is None else tree_map(
                        lambda a, b: a + b, g_acc, g)
                    loss = loss + mb_loss
                grads = tree_map(lambda g: g / n, g_acc)
                loss = loss / n
            else:
                loss, mets, grads, ef = grads_of(
                    params, place_batch(batch, ctx), ef)
            # AdamW on the ZeRO-1 shards, the new params gathered back
            z_pl = [m.placements for m in tree_leaves(opt["m"])]
            shard_z = (lambda tree: tree_unflatten(tree, [
                t.redistribute(mesh, pl)
                for t, pl in zip(tree_leaves(tree), z_pl)]))
            lr = warmup_cosine(opt["step"], peak_lr=scfg.peak_lr,
                               warmup_steps=scfg.warmup_steps,
                               total_steps=scfg.total_steps)
            new_z, new_opt, opt_mets = adamw_update(
                shard_z(grads), opt, shard_z(params), lr, scfg.adamw)
            new_params = tree_unflatten(params, [
                t.redistribute(mesh, p.placements) for t, p in
                zip(tree_leaves(new_z), tree_leaves(params))])
            if scfg.skip_nonfinite:
                ok = torch.isfinite(loss) & torch.isfinite(
                    opt_mets["grad_norm"])
                for a, b in zip(tree_leaves((new_params, new_opt)),
                                tree_leaves((params, opt))):
                    a.copy_(torch.where(ok, a, b))
                opt_mets["skipped"] = (~ok).to(torch.float32)
        metrics = {"loss": loss, "lr": lr, **mets, **opt_mets}
        metrics = {k: (v.full_tensor() if is_dtensor(v) else v)
                   for k, v in metrics.items()}
        new_state = {"params": new_params, "opt": new_opt}
        if "ef" in state:
            new_state["ef"] = ef
        return new_state, metrics

    return train_step


def make_prefill_step(model) -> Callable:
    """``prefill_step(params, batch, cache) -> (last logits, cache)`` for
    an LM, routed as ``repro/distributed/steps.py:195-203``: with
    ``src_embeds`` (B, S_src, d) in ``batch`` the encdec prefill of the
    target ``tokens`` (B, S); else the ``tokens`` after ``extra_embeds``
    (B, S_img, d) where given, and optionally ``lengths`` (B,)."""
    def prefill_step(params, batch, cache):
        if "src_embeds" in batch:
            return model.prefill(params, batch["src_embeds"],
                                 batch["tokens"], cache)
        return model.prefill(params, batch["tokens"], cache,
                             extra_embeds=batch.get("extra_embeds"),
                             lengths=batch.get("lengths"))
    return prefill_step


def make_decode_step(model) -> Callable:
    """``decode_step(params, token, cache, pos, kv_length=None) ->
    (logits, cache)``: ``pos`` is the position written, a 0-d integer
    tensor on the device (as the JAX step's traced ``jnp.int32``: a
    captured step replays at whatever position it holds) or an int;
    ``kv_length`` (B,) the keys each row attends to (default pos + 1).
    The cache is written in place and returned."""
    def decode_step(params, token, cache, pos, kv_length=None):
        return model.decode_step(params, token, cache, pos,
                                 kv_length=kv_length)
    return decode_step
