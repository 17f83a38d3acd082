"""Carry parameters (or caches) between the JAX package and the port.

Both packages keep the same tree: the same keys, the same shapes (``wq
[D,H,dh]``, ``wo [H,dh,D]``, stacked ``[L, ...]`` layer leaves).  The
exchange format is a nested dict of numpy arrays, so this module imports
neither package: the tests turn JAX arrays into numpy and back.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the port's params on the CPU, key for
    key.  Arrays keep their dtype (bf16 from ``ml_dtypes`` goes through f32
    and back, exactly)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))   # a private, writable copy


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params (or cache) -> nested dict of numpy arrays; bf16
    leaves come back as f32 (exact), since numpy has no bf16 of its own.
    Each array is a private copy: the port updates caches in place, and a
    snapshot must not follow them."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()
