"""Carry the JAX package's parameters and train state into the port's
tensors, and back to numpy.

``from_jax_params(tree, device)`` maps a nested dict/list/tuple of arrays
(anything ``numpy.asarray`` accepts: the JAX float param tree
``{"conv": [{"kernel", "bias"}], "fc": [...]}``, the whole train state
``{"params", "opt": {"m", "v", "step"}}``, the int8 ``qparams``, the
int5 ``qparams`` ``{"conv": [{"kernel": w5, "shift": e}]}`` and the list
of requant ``(mult, shift)`` pairs) onto the same structure of torch
tensors on ``device``, keeping every layout and dtype (0-dim leaves such
as the optimizer's step stay 0-dim), and the LM param tree
``{"embed", "final_norm", "stack": {"slot0": {...}}}`` with its
bfloat16 leaves carried bit for bit.  :func:`to_numpy` is its inverse.
Neither imports anything of JAX or ``ml_dtypes``: arrays convert through
numpy, bfloat16 through its 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.engine.policy import resolve_device


def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' type: carry the bits
        bits = torch.from_numpy(arr.view(np.uint16).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def from_jax_params(tree, device="cuda"):
    """The same tree with every array leaf as a torch tensor on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_numpy(tree):
    """The same tree with every tensor leaf as a numpy array (on the
    host, detached).  A bfloat16 leaf comes back as its uint16 bit
    patterns (``.view(ml_dtypes.bfloat16)`` restores the values)."""
    return tree_map(_to_array, tree)
