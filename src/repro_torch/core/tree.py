"""Nested dict/list/tuple trees of tensors, walked as ``jax.tree_util``
walks them: dict keys in sorted order, sequences (NamedTuples too, such as
the Mamba cache) in order, and a leaf's path string built as
``repro/optim/adamw.py:_path_str`` builds it (``conv/0/bias``)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return [(str(i), v) for i, v in enumerate(node)]


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def tree_leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in ``jax.tree_util`` order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in _children(tree):
        out += tree_leaves_with_path(child, f"{prefix}/{key}" if prefix
                                     else key)
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *other_leaves)`` over trees of one structure."""
    if not _is_node(tree):
        return fn(prefix, tree, *rest)

    def child(key, sub, others):
        path = f"{prefix}/{key}" if prefix else str(key)
        return tree_map_with_path(fn, sub, *others, prefix=path)

    if isinstance(tree, dict):
        return {k: child(k, tree[k], [r[k] for r in rest])
                for k in sorted(tree)}
    children = [child(i, v, [r[i] for r in rest]) for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):          # a NamedTuple takes its fields
        return type(tree)(*children)
    return type(tree)(children)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *other_leaves)`` over trees of one structure."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
