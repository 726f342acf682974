"""AdamW (decoupled weight decay) as plain functions on param trees.

Port of ``repro/optim/adamw.py``, kept to its arithmetic rather than
``torch.optim.AdamW``'s (which rounds and decays differently): moments in
fp32 whatever the param dtype, clipping by the global norm first, the
bias corrections ``1 - b**step`` in fp32, and no decay for a leaf whose
path (``conv/0/bias``, as ``core.tree`` builds it) contains one of
``no_decay_fragments``.  Nothing is updated in place: each call returns
new trees.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import (tree_leaves, tree_leaves_with_path,
                                   tree_map, tree_unflatten)


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # params whose path matches any of these fragments skip weight decay
    no_decay_fragments: Tuple[str, ...] = ("norm", "bias", "A_log",
                                           "dt_bias", "/D")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares (leaves in
    ``jax.tree_util`` order)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def adamw_update(grads, opt_state, params, lr,
                 cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_opt_state, metrics) with
    ``grad_norm`` (before clipping, when clipping is on) and
    ``param_norm`` (after the step)."""
    metrics: Dict[str, torch.Tensor] = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    step = opt_state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(path, p, g, m, v):
        gf = g.float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        update = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if cfg.weight_decay and not any(f in path
                                        for f in cfg.no_decay_fragments):
            update = update + cfg.weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype), m_new, v_new

    leaves = [upd(path, p, g, m, v) for (path, p), g, m, v in zip(
        tree_leaves_with_path(params), tree_leaves(grads),
        tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]))]
    new_params, new_m, new_v = (
        tree_unflatten(params, [t[i] for t in leaves]) for i in range(3))
    metrics["param_norm"] = global_norm(new_params)
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics
