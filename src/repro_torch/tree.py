"""Nested-dict trees of tensors: the few ``jax.tree_util`` operations the
port needs (params, optimizer state and metrics are plain nested dicts).

Leaves are visited in the dicts' key order, so two trees built the same way
flatten in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``, which
    share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` with ``leaves`` in flatten order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_select(tree, keep: Callable[[str], bool], prefix: str = ""):
    """The subtree of the leaves whose path ``keep`` accepts, in ``tree``'s
    key order; dicts left empty are dropped (``{}`` when nothing is
    kept)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            sub = tree_select(v, keep, path)
            if sub:
                out[k] = sub
        elif keep(path):
            out[k] = v
    return out
