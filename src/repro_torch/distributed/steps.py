"""The steps on one device.  Training: loss -> gradients (through the
TrIM backward on the kernel substrate) -> AdamW, with gradient
accumulation and the non-finite step skip.  Serving an LM: the prefill and
decode steps (``repro/distributed/steps.py:195-210``).

Port of ``repro/distributed/steps.py:26-146`` for one device.  The JAX
step is a pure function of (state, batch) under ``jit``; this one runs
eagerly and is pure in the same sense: it returns a new state and leaves
the one it was given untouched.  A mesh and the int8-compressed gradient
reduction raise ``NotImplementedError``: they belong to the distributed
slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
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
        raise NotImplementedError("a mesh belongs to the distributed slice "
                                  "of the port; this step runs on one "
                                  "device")
    if scfg.compress_grads:
        raise NotImplementedError("compress_grads (int8 data-parallel "
                                  "gradient reduction) is not ported yet")
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
