"""The parameter tree of a configuration and its seeded weights.

``param_specs`` lists every leaf of the port's tree (paths as the port
names them, stacked ``[L, ...]`` layer leaves) with its shape and how it is
initialised, from the configuration's sizes alone (the architecture's own
module gives its leaves).  ``make_weights`` draws
the values on a device from one seed in a few large calls (one normal and
one uniform draw for the whole tree, then per-leaf scaling in place), in
float32, the type the port trains.  The benchmark hands these weights to
the program and makes them again for the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Spec = Tuple[Tuple[str, ...], Tuple[int, ...], Tuple[Any, ...]]


def normal(fan_in):
    return ("normal", 1.0 / math.sqrt(fan_in))


def lm_specs(arch) -> List[Spec]:
    """The leaves every language model has: the embedding, the final norm
    and, where the head is not tied to the embedding, the head."""
    D, V = arch["d_model"], arch["vocab"]
    specs: List[Spec] = [
        (("embed",), (V, D), ("normal", 0.02)),
        (("final_norm", "scale"), (D,), ("ones",)),
    ]
    if not arch.get("tie_embeddings", False):
        specs.append((("lm_head",), (D, V), ("normal", 0.02)))
    return specs


def param_specs(arch) -> List[Spec]:
    """Every leaf: (path, shape, init), from the architecture's module.
    ``init`` is ``("normal", std)`` (clipped at ±3σ), ``("ones",)``,
    ``("zeros",)``, ``("a_log", lo, hi)`` (log of a uniform draw in
    [lo, hi]) or ``("dt_bias", lo, hi)`` (the inverse softplus of a step
    drawn log-uniform in [lo, hi])."""
    from . import model

    return model(arch).param_specs(arch)


def n_params(arch) -> int:
    """Every parameter counted once."""
    return sum(_numel(shape) for _, shape, _ in param_specs(arch))


def path_name(path) -> str:
    return "/".join(path)


def _numel(shape) -> int:
    return math.prod(shape)


def set_leaf(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def get_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def make_weights(arch, seed: int, device) -> Dict[str, Any]:
    """The seeded f32 weights as a nested dict in the port's layout.  Each
    leaf is a contiguous view of one of four buffers (normal, uniform,
    ones, zeros), drawn with one generator on ``device``."""
    specs = param_specs(arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    kinds = {"normal": [], "uniform": [], "ones": [], "zeros": []}
    for spec in specs:
        kind = spec[2][0]
        kinds["uniform" if kind in ("a_log", "dt_bias") else kind].append(spec)

    def total(group):
        return sum(_numel(shape) for _, shape, _ in group)

    f32 = torch.float32
    bufs = {
        "normal": torch.randn(total(kinds["normal"]), dtype=f32,
                              device=device, generator=gen).clamp_(-3.0, 3.0),
        "uniform": torch.rand(total(kinds["uniform"]), dtype=f32,
                              device=device, generator=gen),
        "ones": torch.ones(total(kinds["ones"]), dtype=f32, device=device),
        "zeros": torch.zeros(total(kinds["zeros"]), dtype=f32, device=device),
    }
    tree: Dict[str, Any] = {}
    for kind, group in kinds.items():
        off = 0
        for path, shape, init in group:
            n = _numel(shape)
            leaf = bufs[kind][off:off + n].view(shape)
            off += n
            if init[0] == "normal":
                leaf.mul_(init[1])
            elif init[0] == "a_log":
                lo, hi = init[1], init[2]
                leaf.mul_(hi - lo).add_(lo).log_()
            elif init[0] == "dt_bias":
                lo, hi = math.log(init[1]), math.log(init[2])
                dt = leaf.mul_(hi - lo).add_(lo).exp_()
                # softplus(dt_bias) == dt
                leaf.copy_(dt + torch.log(-torch.expm1(-dt)))
            set_leaf(tree, path, leaf)
    return tree
