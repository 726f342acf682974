"""Carry the JAX package's parameters and train state into the port's
tensors, and back to numpy.

``from_jax_params(tree, device)`` maps a nested dict/list/tuple of arrays
(anything ``numpy.asarray`` accepts: the JAX float param tree
``{"conv": [{"kernel", "bias"}], "fc": [...]}``, the whole train state
``{"params", "opt": {"m", "v", "step"}}``, the int8 ``qparams`` and the
list of requant ``(mult, shift)`` pairs) onto the same structure of torch
tensors on ``device``, keeping every layout and dtype (0-dim leaves such
as the optimizer's step stay 0-dim).  :func:`to_numpy` is its inverse.
Neither imports anything of JAX: arrays convert through numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.engine.policy import resolve_device


def from_jax_params(tree, device="cuda"):
    """The same tree with every array leaf as a torch tensor on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev),
                    tree)


def to_numpy(tree):
    """The same tree with every tensor leaf as a numpy array (on the
    host, detached)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
