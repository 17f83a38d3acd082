"""Legacy checkpoint surface (port of ``repro.train.checkpoint``): a thin
layer over :mod:`repro_torch.ckpt`.

- ``save_checkpoint`` writes the historic single-``.npz`` format (keys are
  the ``/``-joined tree paths), atomically: tmp file + ``os.replace``, the
  ``.npz`` renamed last.  bf16/float8 leaves are stored as their uint bits;
  the ``step_XXXXXXXX.json`` beside it names their dtype.
- ``latest_checkpoint`` finds the newest legacy ``.npz`` *or* committed
  sharded checkpoint directory.
- ``restore_checkpoint`` dispatches on what the path is (npz vs sharded
  dir) and warns on lossy dtype casts (``LossyCastWarning``).
- ``restore_params`` restores the params subtree of a training checkpoint
  in either format (or a bare params checkpoint).

Restored leaves go to the device of their ``like`` leaf, or to ``device``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..ckpt import elastic as _elastic
from ..ckpt import format as _format
from ..ckpt.elastic import LossyCastWarning  # noqa: F401  (public re-export)
from ..ckpt.export import export_flat  # noqa: F401  (public re-export)


def _flatten(tree) -> Dict[str, Any]:
    return dict(_format.flatten_with_paths(tree))


def _sidecar(path: str) -> str:
    return path[:-len(".npz")] + ".json"


def save_checkpoint(state, ckpt_dir: str, step: int) -> str:
    """Atomic legacy save: one ``.npz`` of flattened leaves + manifest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    stored = {k: _format.to_storable(v) for k, v in _flatten(state).items()}
    arrays = {k: a for k, (a, _) in stored.items()}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    mpath = _sidecar(path)
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:  # file handle: savez cannot append ".npz"
            np.savez(f, **arrays)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": d}
                       for k, (a, d) in stored.items()},
        }
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(mpath + ".tmp", mpath)
        os.replace(tmp, path)  # the .npz is the commit marker: renamed last
    except BaseException:
        for p in (tmp, mpath + ".tmp"):
            if os.path.exists(p):
                os.remove(p)
        raise
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """Newest checkpoint: legacy ``.npz`` files AND committed sharded dirs."""
    best: Optional[Tuple[int, str]] = None
    if os.path.isdir(ckpt_dir):
        for fn in os.listdir(ckpt_dir):
            m = re.fullmatch(r"step_(\d+)\.npz", fn)
            if m:
                step = int(m.group(1))
                if best is None or step > best[0]:
                    best = (step, os.path.join(ckpt_dir, fn))
    sharded = _format.latest_checkpoint(ckpt_dir)
    if sharded is not None and (best is None or sharded[0] > best[0]):
        best = sharded
    return best


def _restore_npz_tree(tree_like, path: str, subtree: str = "", device=None):
    """Rebuild ``tree_like`` from a legacy npz.  ``subtree`` names a key
    prefix (e.g. ``params``) used when the checkpoint has it — a
    full-TrainState save — and ignored for bare saves of the subtree
    itself.  The one npz-restore implementation behind both
    :func:`restore_checkpoint` and :func:`restore_params`."""
    dtypes: Dict[str, str] = {}
    if os.path.isfile(_sidecar(path)):
        with open(_sidecar(path)) as f:
            dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    restored = {}
    with np.load(path) as data:
        prefix = subtree if subtree and any(
            k.startswith(subtree + "/") for k in data.files) else ""
        for k, like in _format.flatten_with_paths(tree_like):
            key = f"{prefix}/{k}" if prefix else k
            if key not in data:
                raise _elastic.RestoreError(
                    f"{path}: no leaf {key!r} (checkpoint holds "
                    f"{len(data.files)} leaves, "
                    f"e.g. {sorted(data.files)[:4]})")
            raw = data[key]
            arr = _format.from_stored(raw, dtypes.get(key, str(raw.dtype)))
            if tuple(arr.shape) != tuple(like.shape):
                raise _elastic.RestoreError(
                    f"{key}: checkpoint shape {tuple(arr.shape)} vs state "
                    f"shape {tuple(like.shape)}"
                )
            arr = _elastic.cast_leaf(arr, like.dtype, key=key)
            restored[k] = arr.to(device if device is not None else like.device)
    return _format.unflatten_paths(tree_like, restored)


def restore_params(params_like, path: str, device=None):
    """Params-only restore from a TRAINING checkpoint (either format).

    Training checkpoints hold the full ``{params, opt, step}`` TrainState;
    serving needs just the ``params`` subtree.  ``params_like`` may live on
    the ``meta`` device (no allocation for the target), with ``device``
    naming where the params go.  Bare params-only checkpoints (no
    ``params/`` key prefix) restore too.
    """
    if os.path.isdir(path):
        keys = _elastic.manifest_keys(path)
        prefix = "params" if any(k.startswith("params/") for k in keys) else ""
        return _elastic.restore(params_like, path, prefix=prefix,
                                device=device)
    return _restore_npz_tree(params_like, path, subtree="params",
                             device=device)


def restore_checkpoint(state_like, path: str, device=None):
    """Restore into the structure of ``state_like`` (shapes must match).

    Accepts either format; lossy dtype casts (e.g. f32 master weights into
    a bf16 tree) raise :class:`LossyCastWarning`.
    """
    if os.path.isdir(path):
        return _elastic.restore(state_like, path, device=device)
    return _restore_npz_tree(state_like, path, device=device)
