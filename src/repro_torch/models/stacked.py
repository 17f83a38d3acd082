"""Stacked layers (port of the serving half of ``repro.models.stacked``).

Layer params are one tree of stacked ``[L, ...]`` leaves, the JAX package's
layout, so ``repro_torch.bridge`` copies them key for key.  JAX consumes
them with ``lax.scan``; PyTorch runs eagerly, so a plain Python loop over
the layer index takes its place (``layer_loop``).  Grouping and remat are
training concerns and come with the training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch


def stack_init(init_fn: Callable[..., Any], gen: torch.Generator, n: int):
    """Init ``n`` i.i.d. layers as one stacked tree (``[n, ...]`` leaves).

    ``init_fn(gen, lead)`` makes every leaf with the leading dims ``lead``
    in one draw, which is the same distribution as ``n`` separate draws."""
    return init_fn(gen, (n,))


def take_layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so in-place writes land in it."""
    if isinstance(tree, dict):
        return {k: take_layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(take_layer(v, i) for v in tree)
    return tree[i]


def stack_layers(trees):
    """Inverse of ``take_layer`` over a list of per-layer trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer_loop(body: Callable[[Any, Any], Tuple[Any, Any]], xs, carry,
               n_layers: int):
    """``carry, y = body(carry, layer_i(xs))`` for every layer; returns the
    final carry and the per-layer ``y`` stacked — what ``Stacked.scan``
    returns in JAX.  ``y`` may be None (nothing collected)."""
    ys = []
    for i in range(n_layers):
        carry, y = body(carry, take_layer(xs, i))
        ys.append(y)
    if ys and ys[0] is not None:
        return carry, stack_layers(ys)
    return carry, None
