"""Carry the JAX package's parameters into the port's tensors.

``from_jax_params(tree, device)`` maps a nested dict/list/tuple of arrays
(anything ``numpy.asarray`` accepts: the JAX float param tree
``{"conv": [{"kernel", "bias"}], "fc": [...]}``, the int8 ``qparams`` and
the list of requant ``(mult, shift)`` pairs) onto the same structure of
torch tensors on ``device``, keeping every layout and dtype.  It imports
nothing of JAX: the caller's arrays convert through numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.policy import resolve_device


def from_jax_params(tree, device="cuda"):
    """The same tree with every array leaf as a torch tensor on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)
