"""Checkpoint format: per-leaf shard files + a JSON manifest (the port's own
copy of ``repro.ckpt.format``; the layout is JAX's, byte for byte).

Layout of one committed checkpoint::

    <ckpt_dir>/
      step_00000042/
        manifest.json             # step, leaves: shape/dtype/spec/file
        leaves/
          params.blocks.attn.wq.npy
          opt.m.blocks.attn.wq.npy
          ...

Each tree leaf is one ``.npy`` file keyed by its path.  Keys join dict keys
with ``/`` and leaves are listed in JAX's flatten order (dict keys sorted),
so a manifest the port writes lists its leaves as JAX's does and
``leaf_filename`` collisions resolve the same way.  Each leaf's ``spec`` is
the layout it was saved under (:func:`spec_text`): JAX's
``spec_to_json`` of a DTensor leaf's plan spec, ``null`` for a leaf on one
device, as JAX writes for a leaf with no ``PartitionSpec``.  The files hold
full tensors whatever the layout, so any plan restores them.

bf16 and float8 leaves are stored as a ``uint`` view of their bits with the
dtype name in the manifest, as JAX stores its ``ml_dtypes`` leaves.  The
port maps those names to torch dtypes itself (``TORCH_DTYPES``) and needs no
``ml_dtypes``.

Commits are atomic: everything (manifest last) is written into a hidden
``.tmp-*`` sibling directory, which is then ``os.replace``d to its final
``step_XXXXXXXX`` name.  A ``step_*`` directory containing ``manifest.json``
is committed; anything else is an aborted write and is ignored (and swept
by the engine's retention pass).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
LEAF_DIR = "leaves"
FORMAT_VERSION = 1

_STEP_RE = re.compile(r"step_(\d+)")

#: manifest dtype name -> torch dtype (the names numpy and ``ml_dtypes``
#: give these dtypes)
TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}
#: dtypes numpy cannot name: stored as a uint view of the same width
_BIT_VIEWS = {torch.bfloat16: (torch.int16, np.uint16),
              torch.float8_e4m3fn: (torch.int8, np.uint8),
              torch.float8_e5m2: (torch.int8, np.uint8)}


# ---------------------------------------------------------------------------
# tree path keys
# ---------------------------------------------------------------------------
def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` where key is the '/'-joined dict path, in JAX's
    flatten order (each dict's keys sorted); a bare leaf has key ``''``."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        else:
            out.append((prefix, node))

    walk(tree, "")
    return out


def unflatten_paths(like, values: Dict[str, Any], prefix: str = ""):
    """A tree with ``like``'s structure (and key order) whose leaf at each
    path key is ``values[key]``."""
    if isinstance(like, dict):
        return {k: unflatten_paths(v, values,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    return values[prefix]


def leaf_filename(key: str) -> str:
    """Shard filename for a tree key ('' names a bare-leaf tree)."""
    safe = key.replace("/", ".") if key else "_root"
    return f"{safe}.npy"


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------
def torch_dtype(name) -> torch.dtype:
    """Manifest dtype name (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return TORCH_DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"checkpoint dtype {name!r} has no torch "
                         f"counterpart in the port") from None


def to_storable(leaf) -> Tuple[np.ndarray, str]:
    """A host tensor (or numpy array) -> (the array ``np.save`` writes, the
    manifest's dtype name).  bf16/float8 become their uint bits."""
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    t = leaf.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    name = DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise ValueError(f"cannot checkpoint a {t.dtype} leaf")
    view = _BIT_VIEWS.get(t.dtype)
    if view is not None:
        return t.view(view[0]).numpy().view(view[1]), name
    return t.numpy(), name


def from_stored(raw: np.ndarray, name: str) -> torch.Tensor:
    """``np.load``'s array and the manifest's dtype name -> CPU tensor; uint
    (or legacy void) bits of an extension dtype are reinterpreted."""
    want = torch_dtype(name)
    if not raw.flags.c_contiguous:   # (ascontiguousarray would make 0-d 1-d)
        raw = raw.copy()
    view = _BIT_VIEWS.get(want)
    if view is not None:
        if raw.dtype.itemsize != want.itemsize or raw.dtype.kind not in "uV":
            raise ValueError(f"leaf stored as {raw.dtype} cannot hold "
                             f"{name} bits")
        bits = raw.view(np.dtype(f"i{want.itemsize}"))
        return torch.from_numpy(bits).view(want)
    return torch.from_numpy(raw)


def spec_text(leaf) -> Optional[List[Any]]:
    """The JSON form of a DTensor leaf's spec (JAX's ``spec_to_json`` of its
    ``PartitionSpec``), None for a tensor that is not laid out on a
    mesh."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return None
    from ..sharding.plans import placements_spec, spec_to_json

    return spec_to_json(placements_spec(leaf.device_mesh, leaf.placements,
                                        leaf.ndim))


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
def step_dirname(step: int) -> str:
    return f"step_{step:08d}"


def write_checkpoint(ckpt_dir: str, step: int,
                     arrays: Dict[str, Any],
                     specs: Optional[Dict[str, Any]] = None,
                     extra: Optional[Dict[str, Any]] = None) -> str:
    """Write one atomic checkpoint of ``arrays`` (key -> host tensor or
    numpy array, in manifest order); returns the committed directory."""
    specs = specs or {}
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, step_dirname(step))
    tmp = os.path.join(ckpt_dir, f".tmp-{step_dirname(step)}-{uuid.uuid4().hex[:8]}")
    os.makedirs(os.path.join(tmp, LEAF_DIR))
    leaves: Dict[str, Dict[str, Any]] = {}
    used: set = set()
    try:
        for key, leaf in arrays.items():
            arr, dtype = to_storable(leaf)
            fn = leaf_filename(key)
            while fn in used:  # 'a/b' and 'a.b' both map to a.b.npy
                fn = "dup." + fn
            used.add(fn)
            np.save(os.path.join(tmp, LEAF_DIR, fn), arr, allow_pickle=False)
            leaves[key] = {
                "shape": list(arr.shape),
                "dtype": dtype,
                "spec": specs.get(key),
                "file": f"{LEAF_DIR}/{fn}",
            }
        manifest = {
            "format_version": FORMAT_VERSION,
            "step": int(step),
            "n_leaves": len(leaves),
            "leaves": leaves,
        }
        if extra:
            manifest.update(extra)
        # the manifest is the commit marker inside the dir: written LAST
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        if os.path.isdir(final):
            # re-save of the same step wins, but the committed dir is moved
            # aside atomically (not rmtree'd in place): a crash mid-swap
            # leaves only invisible .tmp-* dirs, never a torn checkpoint
            aside = os.path.join(
                ckpt_dir, f".tmp-replaced-{step_dirname(step)}-{uuid.uuid4().hex[:8]}")
            os.replace(final, aside)
            os.replace(tmp, final)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


# ---------------------------------------------------------------------------
# reading / discovery
# ---------------------------------------------------------------------------
def is_committed(step_dir: str) -> bool:
    return os.path.isfile(os.path.join(step_dir, MANIFEST))


def read_manifest(step_dir: str) -> Dict[str, Any]:
    with open(os.path.join(step_dir, MANIFEST)) as f:
        return json.load(f)


def read_leaf(step_dir: str, entry: Dict[str, Any]) -> torch.Tensor:
    """One leaf of a committed checkpoint as a CPU tensor of its saved
    dtype."""
    raw = np.load(os.path.join(step_dir, entry["file"]), allow_pickle=False)
    return from_stored(raw, entry["dtype"])


def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """All COMMITTED checkpoints as sorted ``(step, dir)`` pairs."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for fn in os.listdir(ckpt_dir):
        m = _STEP_RE.fullmatch(fn)
        path = os.path.join(ckpt_dir, fn)
        if m and os.path.isdir(path) and is_committed(path):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """The newest committed checkpoint, or None."""
    all_ = list_checkpoints(ckpt_dir)
    return all_[-1] if all_ else None


def sweep_aborted(ckpt_dir: str) -> int:
    """Delete leftover ``.tmp-*`` directories from interrupted writes."""
    if not os.path.isdir(ckpt_dir):
        return 0
    n = 0
    for fn in os.listdir(ckpt_dir):
        if fn.startswith(".tmp-"):
            shutil.rmtree(os.path.join(ckpt_dir, fn), ignore_errors=True)
            n += 1
    return n
