"""AdamW over a param tree (port of ``repro.optim.adamw``).

State (m, v) mirrors the param tree in f32.  ``count`` and the learning
rate stay tensors on the params' device, so an update issues no host sync.
Weight decay follows JAX's rule ``p.ndim >= 2`` on the *stacked* leaves:
per-layer norm weights ``[L, D]`` and biases ``[L, H, dh]`` are decayed, the
unstacked ``final_norm [D]`` is not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

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
        zeros = lambda: tree_map(  # noqa: E731
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        device = tree_leaves(params)[0].device
        state = {"m": zeros(), "v": zeros(),
                 "count": torch.zeros((), dtype=torch.int32, device=device)}
        if self.master_weights:
            state["master"] = tree_map(lambda p: p.float().clone(), params)
        return state

    def _lr(self, count):
        if callable(self.lr):
            return self.lr(count)
        return torch.tensor(self.lr, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any]]:
        grads = tree_map(lambda g: g.float(), grads)
        if self.grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g),
                     state["v"], grads)
        cf = count.float()
        c1 = 1 - torch.pow(b1, cf)
        c2 = 1 - torch.pow(b2, cf)
        lr = self._lr(count)

        def upd(p, mm, vv):
            step = (mm / c1) / (torch.sqrt(vv / c2) + self.eps)
            if self.weight_decay > 0 and p.dim() >= 2:
                step = step + self.weight_decay * p.float()
            return p.float() - lr * step

        if self.master_weights:
            new_master = tree_map(upd, state["master"], m, v)
            new_params = tree_map(lambda nm, p: nm.to(p.dtype), new_master,
                                  params)
            return new_params, {"m": m, "v": v, "count": count,
                                "master": new_master}
        new_params = tree_map(lambda p, mm, vv: upd(p, mm, vv).to(p.dtype),
                              params, m, v)
        return new_params, {"m": m, "v": v, "count": count}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))
