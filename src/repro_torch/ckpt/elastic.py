"""Restore a checkpoint into a train state (port of ``repro.ckpt.elastic``).

Each restored leaf is laid out under a target sharding, which may differ
from the one it was saved under (the elastic part): a
``plans.NamedSharding`` from ``shardings`` (or derived from a
``plan``/``mesh``) makes it a DTensor on that mesh, every rank keeping its
block of the full tensor it read; a DTensor ``state_like`` leaf gives its
own layout; otherwise the leaf goes to the device of its ``state_like``
leaf (or to ``device``).  Checkpoints store full tensors in the
plan-independent ``[L, ...]`` shapes, so any layout restores any
checkpoint.

Dtype rules, as in JAX: a checkpointed leaf is cast to the target leaf's
dtype.  A *lossy* cast (fewer mantissa bits, less range, float -> int)
raises a :class:`LossyCastWarning`, except for compute params whose f32
master copies are restored in the same call (mixed-precision training keeps
the precision in ``opt/master``; the bf16 compute copy is derived).
"""
from __future__ import annotations

import math
import warnings as _warnings
from typing import Any, Dict, List

import torch

from . import format as F


class LossyCastWarning(UserWarning):
    """A checkpoint leaf was cast to a dtype that cannot represent it."""


class RestoreError(Exception):
    """Checkpoint does not match the requested state structure."""


# ---------------------------------------------------------------------------
# dtype casting
# ---------------------------------------------------------------------------
def _mantissa_bits(dt: torch.dtype):
    if not dt.is_floating_point:
        return None
    return round(-math.log2(torch.finfo(dt).eps))


def is_lossy_cast(src, dst) -> bool:
    """True when casting ``src`` -> ``dst`` (torch dtypes or manifest
    names) can lose information: JAX's rules, with ``torch.finfo`` in place
    of ``jnp.finfo``."""
    src, dst = F.torch_dtype(src), F.torch_dtype(dst)
    if src == dst:
        return False
    s_m, d_m = _mantissa_bits(src), _mantissa_bits(dst)
    if s_m is not None and d_m is not None:
        # precision loss (fewer mantissa bits) OR range loss (bf16 -> f16
        # overflows to inf above 65504 despite more mantissa bits)
        return d_m < s_m or torch.finfo(dst).max < torch.finfo(src).max
    if s_m is not None and d_m is None:
        return True  # float -> int
    if s_m is None and d_m is None:
        return dst.itemsize < src.itemsize
    # int -> float: exact only while the float's mantissa covers the
    # integer's value bits (f32 represents ints exactly up to 2**24)
    bits = 8 * src.itemsize - (1 if src.is_signed else 0)
    return d_m + 1 < bits


def cast_leaf(arr: torch.Tensor, target_dtype, key: str = "",
              warn: bool = True, master_restored: bool = False) -> torch.Tensor:
    """Cast one restored leaf, warning on lossy casts.

    ``master_restored`` suppresses the warning for compute params that have
    their f32 master copy restored alongside (nothing is actually lost).
    """
    target_dtype = F.torch_dtype(target_dtype)
    if arr.dtype == target_dtype:
        return arr
    if warn and not master_restored and is_lossy_cast(arr.dtype, target_dtype):
        _warnings.warn(
            f"restore: {key or '<leaf>'} saved as {F.DTYPE_NAMES[arr.dtype]} "
            f"but restored into {F.DTYPE_NAMES[target_dtype]} — a lossy cast "
            f"(e.g. f32 master weights into bf16 compute params loses 16 "
            f"mantissa bits)",
            LossyCastWarning,
            stacklevel=3,
        )
    return arr.to(target_dtype)


def _master_keys(ckpt_keys, target_keys) -> set:
    """Param keys whose f32 master copy is restored IN THIS CALL
    (``opt/master/<param-key>`` mirrors ``params/<param-key>``).  The master
    must be in the checkpoint AND among the keys being restored now — a
    params-only restore (fresh-optimizer warmstart) discards the masters,
    so its f32 -> bf16 casts really are lossy and must warn."""
    out = set()
    for k in ckpt_keys:
        if k.startswith("opt/master/") and k in target_keys:
            out.add("params/" + k[len("opt/master/"):])
    return out


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------
def _resolve_step_dir(path: str) -> str:
    """Accept a committed step dir or a ckpt dir (-> latest committed)."""
    if F.is_committed(path):
        return path
    latest = F.latest_checkpoint(path)
    if latest is None:
        raise RestoreError(f"no committed checkpoint at {path!r}")
    return latest[1]


def restore(state_like, path: str, shardings: Any = None, *,
            prefix: str = "", strict: bool = True,
            warn_lossy: bool = True, device=None):
    """Rebuild ``state_like``'s tree from a checkpoint.

    ``state_like`` supplies structure, shapes, and target dtypes (shapes
    must match the manifest; dtypes may differ — see the casting rules);
    its leaves may live on the ``meta`` device.  ``shardings`` (optional) is
    a matching tree of ``plans.NamedSharding`` (or None leaves): each leaf is
    laid out under ITS target sharding, however different from the saved
    layout.  A leaf with no target sharding keeps a DTensor ``state_like``
    leaf's layout, or goes to ``device`` (when None, to its ``state_like``
    leaf's device).  ``prefix`` selects a subtree of the checkpoint (e.g.
    ``params`` for a params-only warmstart).  ``strict=False`` keeps
    ``state_like``'s value for keys the checkpoint does not have (partial
    warmstart).
    """
    step_dir = _resolve_step_dir(path)
    manifest = F.read_manifest(step_dir)
    entries: Dict[str, Any] = manifest["leaves"]

    flat_like = F.flatten_with_paths(state_like)
    sh_by_key: Dict[str, Any] = {}
    if shardings is not None:
        flat_sh = F.flatten_with_paths(shardings)
        if len(flat_sh) != len(flat_like):
            raise RestoreError(
                f"shardings tree has {len(flat_sh)} leaves, state has "
                f"{len(flat_like)}")
        sh_by_key = dict(flat_sh)
    target_keys = {f"{prefix}/{k}" if prefix else k for k, _ in flat_like}
    masters = _master_keys(entries, target_keys)
    restored: Dict[str, Any] = {}
    missing: List[str] = []
    for key, like in flat_like:
        ck_key = f"{prefix}/{key}" if prefix else key
        entry = entries.get(ck_key)
        if entry is None:
            if strict:
                missing.append(ck_key)
                continue
            restored[key] = like
            continue
        arr = F.read_leaf(step_dir, entry)
        like_shape = tuple(like.shape)
        if tuple(arr.shape) != like_shape:
            if strict:
                raise RestoreError(
                    f"{ck_key}: checkpoint shape {tuple(arr.shape)} vs state "
                    f"shape {like_shape}"
                )
            # partial warmstart (e.g. a resized head): the reshaped leaf
            # keeps its fresh init
            _warnings.warn(
                f"restore: {ck_key} shape {tuple(arr.shape)} != state "
                f"{like_shape}; keeping the current value (strict=False)",
                UserWarning, stacklevel=2)
            restored[key] = like
            continue
        arr = cast_leaf(arr, like.dtype, key=ck_key, warn=warn_lossy,
                        master_restored=ck_key in masters)
        restored[key] = _place(arr, like, sh_by_key.get(key), device)
    if missing:
        raise RestoreError(
            f"checkpoint {step_dir} is missing {len(missing)} leaves "
            f"(first: {missing[:4]}); pass strict=False to keep current "
            f"values for absent keys"
        )
    return F.unflatten_paths(state_like, restored)


def _place(arr, like, sharding, device):
    """A restored full tensor on its target: a DTensor under ``sharding``
    or under a DTensor ``like``'s layout (each rank cuts its block from the
    host tensor and moves only that; no data moves between ranks), else a
    tensor on ``device`` or ``like``'s."""
    from torch.distributed.tensor import DTensor

    from ..sharding.plans import local_block

    if sharding is None and isinstance(like, DTensor):
        mesh, placements = like.device_mesh, like.placements
    elif sharding is not None:
        mesh, placements = sharding.mesh, sharding.placements
    else:
        return arr.to(device if device is not None else like.device)
    if device is None:
        device = (like.device if like.device.type != "meta" else
                  torch.device(mesh.device_type, torch.cuda.current_device())
                  if mesh.device_type == "cuda" else mesh.device_type)
    block = local_block(arr, mesh, placements).contiguous().to(device)
    return DTensor.from_local(block, mesh, placements, run_check=False,
                              shape=arr.shape, stride=arr.stride())


def restore_train_state(state_like, path: str, *, plan=None, mesh=None,
                        model=None, optimizer=None, shardings=None,
                        seed: int = 0, warn_lossy: bool = True, device=None):
    """Restore a full ``{"params", "opt", "step"}`` train state, re-laid-out
    under ``plan``/``mesh`` (derived via
    :func:`repro_torch.sharding.plans.train_state_shardings`) or an explicit
    ``shardings`` tree."""
    if shardings is None and plan is not None and mesh is not None:
        from ..sharding import plans as PL

        if model is None or optimizer is None:
            raise RestoreError(
                "restore_train_state under a plan/mesh needs model and "
                "optimizer to derive the target layout"
            )
        shardings, _ = PL.train_state_shardings(plan, mesh, model, optimizer,
                                                seed=seed)
    return restore(state_like, path, shardings, warn_lossy=warn_lossy,
                   device=device)


def saved_step(path: str) -> int:
    """The step a checkpoint (dir or step dir) was taken at."""
    return int(F.read_manifest(_resolve_step_dir(path))["step"])


def manifest_keys(path: str) -> set:
    """The tree keys a checkpoint (dir or step dir) holds."""
    return set(F.read_manifest(_resolve_step_dir(path))["leaves"])
