"""AdamW over a param tree (port of ``repro.optim.adamw``).

State (m, v) mirrors the param tree in f32; ``update`` writes it and the
params in place.  ``count`` and the learning rate stay tensors on the
params' device, so an update issues no host sync.
On DTensor leaves (a sharding plan's layout) the same in-place update runs
shard by shard: the moments take the params' placements, ``count`` is
replicated and the global norm sums over every shard.
Weight decay follows JAX's rule ``p.ndim >= 2`` on the *stacked* leaves:
per-layer norm weights ``[L, D]`` and biases ``[L, H, dh]`` are decayed, the
unstacked ``final_norm [D]`` is not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from ..models.base import is_dtensor, replicate_like
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    #: params in bf16 with f32 master copies in the optimizer state
    master_weights: bool = False

    def init(self, params) -> Dict[str, Any]:
        """Zero moments in f32 (on a DTensor param, a DTensor with its
        placements) and a zero count (replicated on a DTensor param's
        mesh)."""
        zeros = lambda: tree_map(_zeros_f32, params)  # noqa: E731
        first = tree_leaves(params)[0]
        count = torch.zeros((), dtype=torch.int32, device=first.device)
        state = {"m": zeros(), "v": zeros(),
                 "count": replicate_like(count, first)}
        if self.master_weights:
            state["master"] = tree_map(lambda p: p.float().clone(), params)
        return state

    def _lr(self, count):
        if callable(self.lr):
            return self.lr(count)
        return torch.tensor(self.lr, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any]]:
        """One AdamW step.  JAX returns new trees; the port writes m, v and
        the params (and the master copies) in place, one leaf at a time,
        with JAX's arithmetic op for op, and returns the same trees.  A
        second copy of the f32 state does not fit one card for the largest
        model it trains (Zamba2-2.7B: params, gradients, m and v are 33 GB
        in f32), so the old state does not survive the step."""
        scale = None
        if self.grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        cf = count.float()
        c1 = 1 - torch.pow(b1, cf)
        c2 = 1 - torch.pow(b2, cf)
        lr = self._lr(count)
        target = state["master"] if self.master_weights else params
        for p, g, mm, vv, t in _zip_leaves(params, grads, state["m"],
                                           state["v"], target):
            g = g.float()
            if scale is not None:
                g = g * scale
            mm.mul_(b1).add_((1 - b1) * g)
            vv.mul_(b2).add_((1 - b2) * torch.square(g))
            step = (mm / c1) / (torch.sqrt(vv / c2) + self.eps)
            if self.weight_decay > 0 and t.dim() >= 2:
                step = step + self.weight_decay * t.float()
            t.copy_(t.float() - lr * step)
            if t is not p:
                p.copy_(t)
        new_state = {"m": state["m"], "v": state["v"], "count": count}
        if self.master_weights:
            new_state["master"] = state["master"]
        return params, new_state


def _zeros_f32(p):
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _zip_leaves(tree, *rest):
    """The leaves of ``tree`` with the leaves at the same keys of ``rest``
    (which may hold their keys in another order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _zip_leaves(v, *(r[k] for r in rest))
    else:
        yield (tree,) + rest


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))
