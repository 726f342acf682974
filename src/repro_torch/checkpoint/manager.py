"""Checkpoints: one ``.npy`` file per tree leaf, a JSON manifest, an
async writer and an atomic commit (port of ``repro/checkpoint/manager.py``).

Layout, the JAX package's own, so that each package reads the other's
checkpoints::

    <dir>/step_<k>/
        manifest.json          {"leaves": [{"path", "file", "shape", "dtype"}]}
        leaf_<sha1[:16]>.npy   one file per leaf, named by its path's hash
        COMMITTED              empty marker, written LAST

A leaf's path is its ``/``-joined dict keys and list indices
(``core.tree``, as ``_path_str`` at ``repro/checkpoint/manager.py:41``
builds it from ``jax.tree_util``): the port's param and AdamW trees carry
the JAX trees' structure and names, so the same leaf has the same path
in both packages.  bfloat16 (and the fp8 types) are stored as their bit
patterns, uint16 (uint8), under the dtype's own name: a tensor is
bit-viewed (``Tensor.view(torch.int16)``), never converted, so neither
package needs ``ml_dtypes`` to write or read them.  Restore puts each leaf
on its template leaf's device and dtype.  :func:`latest_step` skips a
checkpoint without ``COMMITTED`` (torn by a crash mid-write).

Under a mesh the format stays mesh-agnostic: every DTensor leaf is
gathered whole (``full_tensor()``, on every rank) and rank 0 writes it;
plain tensor leaves beside DTensors are per-rank (the compressed
gradients' error feedback) and are not saved.  Restore is elastic: a
DTensor template leaf takes the restored tensor onto its own mesh and
placements, whatever mesh wrote it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves_with_path, tree_map_with_path

#: dtypes numpy cannot hold -> (their name, the unsigned bit-pattern dtype
#: stored, and the signed integer type of that width in numpy and torch,
#: through which the bits pass unchanged)
_EXOTIC = {
    torch.bfloat16: ("bfloat16", np.uint16, np.int16, torch.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, np.int8, torch.int8),
    torch.float8_e5m2: ("float8_e5m2", np.uint8, np.int8, torch.int8),
}
_BY_NAME = {spec[0]: (dt, *spec[1:]) for dt, spec in _EXOTIC.items()}


def _leaf_file(path_str: str) -> str:
    h = hashlib.sha1(path_str.encode()).hexdigest()[:16]
    return f"leaf_{h}.npy"


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of ``t`` on the host as numpy, and its dtype's name."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype in _EXOTIC:
        name, bits, _, signed = _EXOTIC[t.dtype]
        return t.view(signed).numpy().view(bits), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _BY_NAME:
        dt, _, signed, _ = _BY_NAME[dtype_name]
        return torch.from_numpy(np.ascontiguousarray(arr).view(signed)).view(dt)
    return torch.from_numpy(np.array(arr, copy=True))


def _write(host, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    leaves = []
    for ps, (arr, dtype_name) in host:
        fname = _leaf_file(ps)
        np.save(os.path.join(directory, fname), arr)
        leaves.append({"path": ps, "file": fname, "shape": list(arr.shape),
                       "dtype": dtype_name})
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump({"leaves": leaves}, f)
    # the atomic commit marker: written last
    with open(os.path.join(directory, "COMMITTED"), "w") as f:
        f.write("ok")


def _is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _snapshot(tree):
    """[(path, host array)]: DTensors gathered whole; beside them, plain
    leaves (per rank) left out."""
    leaves = tree_leaves_with_path(tree)
    meshed = any(_is_dtensor(t) for _, t in leaves)
    return [(ps, _to_host(leaf.full_tensor() if _is_dtensor(leaf) else leaf))
            for ps, leaf in leaves if not meshed or _is_dtensor(leaf)]


def _writer() -> bool:
    """Whether this process writes: rank 0 of an initialized group, or
    the only process."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def save_pytree(tree, directory: str) -> None:
    """Write every tensor leaf of ``tree`` under ``directory``, then the
    manifest, then ``COMMITTED`` (under a mesh: every rank gathers, rank 0
    writes)."""
    host = _snapshot(tree)
    if _writer():
        _write(host, directory)


def restore_pytree(template, directory: str):
    """A tree of ``template``'s structure read from ``directory``: each
    leaf by its path, checked against the template leaf's shape, on the
    template leaf's device and in its dtype."""
    with open(os.path.join(directory, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    meshed = any(_is_dtensor(t) for _, t in tree_leaves_with_path(template))

    def one(ps, leaf):
        if meshed and not _is_dtensor(leaf):
            return leaf          # per rank: not in the checkpoint
        if ps not in by_path:
            raise KeyError(f"checkpoint missing leaf {ps!r}")
        entry = by_path[ps]
        t = _from_host(np.load(os.path.join(directory, entry["file"])),
                       entry["dtype"])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{ps}: checkpoint shape {tuple(t.shape)} != "
                             f"template {tuple(leaf.shape)}")
        if _is_dtensor(leaf):
            from torch.distributed.tensor import distribute_tensor
            t = t.to(device=leaf.to_local().device, dtype=leaf.dtype)
            return distribute_tensor(t, leaf.device_mesh, leaf.placements,
                                     src_data_rank=None)
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return tree_map_with_path(one, template)


def latest_step(base_dir: str) -> Optional[int]:
    """The largest committed step under ``base_dir``, or None."""
    if not os.path.isdir(base_dir):
        return None
    steps = []
    for name in os.listdir(base_dir):
        if name.startswith("step_"):
            d = os.path.join(base_dir, name)
            if os.path.exists(os.path.join(d, "COMMITTED")):
                try:
                    steps.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
    return max(steps) if steps else None


class CheckpointManager:
    """Checkpoints under ``base_dir``: the tree is copied to the host when
    :meth:`save` is called, and written by a background thread (one at a
    time: the next save waits for the last); the newest ``keep_last``
    step directories are kept."""

    def __init__(self, base_dir: str, keep_last: int = 3):
        self.base_dir = base_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        os.makedirs(base_dir, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.base_dir, f"step_{step}")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(int(n.split("_", 1)[1])
                       for n in os.listdir(self.base_dir)
                       if n.startswith("step_"))
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def save(self, tree, step: int) -> None:
        """Copy ``tree`` to the host now; write it as step ``step`` in the
        background (:meth:`wait` for the write to finish)."""
        self.wait()
        host = _snapshot(tree)
        if not _writer():
            return

        def work():
            _write(host, self._dir(step))
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def restore_latest(self, template, shardings=None
                       ) -> Tuple[Optional[int], Any]:
        """(the latest committed step, the tree restored from it), or
        (None, ``template``).  ``shardings`` (spec tree, mesh), where
        given, places the restored tree on that mesh (the elastic
        restore of a plain template)."""
        step = latest_step(self.base_dir)
        if step is None:
            return None, template
        tree = restore_pytree(template, self._dir(step))
        if shardings is not None:
            from repro_torch.distributed.steps import place_state
            specs, mesh = shardings
            tree = place_state(tree, specs, mesh)
        return step, tree
