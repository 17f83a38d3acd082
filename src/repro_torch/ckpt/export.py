"""HF-style export (port of ``repro.ckpt.export``), Modalities' "convert a
distributed checkpoint to an HF-compatible one".

Unstacks the scan-over-layers ``[L, ...]`` dims into per-layer flat keys
(``model.blocks.3.attn.wq`` style) so any external tool can consume the
weights without knowing the stacked layout.  bf16 leaves are written as
their uint16 bits, with ``bfloat16`` as the manifest's dtype (the port has
no numpy bf16).
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from .format import flatten_with_paths, to_storable

_STACK_KEYS = ("blocks", "moe_blocks", "dense_blocks", "ssm_blocks",
               "enc_blocks", "dec_blocks")


def export_flat(params, out_dir: str, prefix: str = "model") -> str:
    """Unstack layer dims -> per-layer flat keys; write npz + manifest."""
    os.makedirs(out_dir, exist_ok=True)
    out: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, leaf in flatten_with_paths(params):
        arr, dtype = to_storable(leaf)
        parts = key.split("/")
        if parts[0] in _STACK_KEYS:
            stack = parts[0]
            rest = ".".join(parts[1:])
            for layer in range(arr.shape[0]):
                name = f"{prefix}.{stack}.{layer}.{rest}"
                out[name], dtypes[name] = arr[layer], dtype
        else:
            name = f"{prefix}.{'.'.join(parts)}"
            out[name], dtypes[name] = arr, dtype
    path = os.path.join(out_dir, "export.npz")
    np.savez(path, **out)
    with open(os.path.join(out_dir, "export_manifest.json"), "w") as f:
        json.dump(
            {k: {"shape": list(v.shape), "dtype": dtypes[k]}
             for k, v in out.items()},
            f, indent=2,
        )
    return path
