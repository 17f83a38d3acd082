"""Stacked layers and activation-remat policies (port of
``repro.models.stacked``).

Layer params are one tree of stacked ``[L, ...]`` leaves, the JAX package's
layout, so ``repro_torch.bridge`` copies them key for key.  JAX consumes
them with ``lax.scan``; PyTorch runs eagerly, so a Python loop over the
layers takes its place: ``layer_loop`` for serving, ``Stacked.fold`` for
training.  ``fold`` runs the layers in groups of ``block_size`` and wraps
each group's body in the remat policy:

* ``none``      — save every intermediate;
* ``full``      — ``torch.utils.checkpoint`` saving nothing inside the
                  group (the backward recomputes the whole group body);
* ``selective`` — the same checkpoint with a selective context that saves
                  the matmul outputs (``aten.mm``/``bmm``/``addmm``/
                  ``baddbmm``) and recomputes the rest, the counterpart of
                  JAX's ``dots_saveable``.

The stacked leaves are split into their layers once per ``fold`` with
``torch.unbind``, whose backward stacks the L layer gradients into one
``[L, ...]`` tensor, as the transpose of JAX's scan does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import torch

REMAT_VARIANTS = ("none", "full", "selective")


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """Named activation-checkpoint policy applied to a layer group."""

    name: str = "full"

    def __post_init__(self):
        if self.name not in REMAT_VARIANTS:
            raise ValueError(
                f"unknown remat policy {self.name!r}; one of {REMAT_VARIANTS}")

    def wrap(self, fn: Callable) -> Callable:
        if self.name == "none":
            return fn
        from torch.utils.checkpoint import checkpoint

        if self.name == "selective":
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts

            context_fn = functools.partial(create_selective_checkpoint_contexts,
                                           _save_matmuls)
            return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                         context_fn=context_fn)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep matmul outputs, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default,
              aten.baddbmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat(policy) -> RematPolicy:
    """Accept a RematPolicy, a policy name, or None (-> full)."""
    if policy is None:
        return RematPolicy("full")
    if isinstance(policy, RematPolicy):
        return policy
    return RematPolicy(str(policy))


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
    if isinstance(first, tuple):
        return tuple(stack_layers([t[i] for t in trees])
                     for i in range(len(first)))
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


def unbind_layers(tree, n_layers: int):
    """The ``n_layers`` per-layer trees of a stacked tree, made with one
    ``torch.unbind`` per leaf (one stacked gradient per leaf in backward)."""
    if isinstance(tree, dict):
        per_key = {k: unbind_layers(v, n_layers) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n_layers)]
    return list(torch.unbind(tree))


class Stacked:
    """A homogeneous layer stack, applied in groups of ``block_size``.

    ``body(carry, layer_params) -> carry`` is the single-layer step;
    ``fold`` threads the carry through all layers (grouped and remat'd);
    ``tail`` runs after each group (JAX's weight-shared attention hook).
    ``block_size`` becomes the largest divisor of ``n_layers`` that is at
    most the requested size, as in JAX.  ``gather`` (under a mesh,
    ``base.gather_fsdp``) turns each layer's stored params into the ones
    its body reads, inside the remat wrap: the FSDP all-gather runs once
    per layer in the forward and again in the recompute, and no gathered
    layer is kept between the passes.
    """

    def __init__(self, body: Callable[[Any, Any], Any], n_layers: int,
                 block_size: int = 1, remat="full",
                 tail: Optional[Callable[[Any], Any]] = None,
                 gather: Optional[Callable[[Any], Any]] = None):
        self.body = body
        self.n_layers = n_layers
        k = max(1, min(int(block_size) or 1, n_layers))
        while n_layers % k:
            k -= 1
        self.block_size = k
        self.remat = resolve_remat(remat)
        self.tail = tail
        self.gather = gather

    def fold(self, stack_params, carry):
        """carry -> carry through all layers (the training hot path)."""
        layers = unbind_layers(stack_params, self.n_layers)

        def group_body(carry, *group):
            for lp in group:
                if self.gather is not None:
                    lp = self.gather(lp)
                carry = self.body(carry, lp)
            if self.tail is not None:
                carry = self.tail(carry)
            return carry

        run = self.remat.wrap(group_body)
        k = self.block_size
        for g in range(0, self.n_layers, k):
            carry = run(carry, *layers[g:g + k])
        return carry
