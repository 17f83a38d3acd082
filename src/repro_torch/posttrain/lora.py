"""LoRA adapters as a params-transform over the port's models (port of
``repro.posttrain.lora``).

A :class:`LoRAModel` wraps any :class:`~repro_torch.models.base.Model`
without touching its forward code: ``init`` returns the base tree plus a
parallel ``lora`` subtree of low-rank ``{a, b}`` factor pairs, and every
forward method first *merges* ``W + (alpha/rank) * a @ b`` and then
delegates to the wrapped model.  ``b`` is zero-initialized, so a freshly
injected adapter is an exact no-op: the merged forward is the base forward,
which is what makes warmstarting a LoRA run from a pretrained checkpoint
well-defined.

The factor layout is JAX's, so an adapter checkpoint is JAX's byte for
byte: for a base leaf ``[d_in, *d_out]``, ``a`` is ``[d_in, r]`` and ``b``
``[r, *d_out]``; a stacked leaf keeps its layer dim on both factors (``wo
[L, H, dh, D]`` gets ``a [L, H, r]`` and ``b [L, r, dh, D]``).  Stacking is
read from ``param_axes()`` (``axes[0] == LAYER``), never guessed from key
names.

The frozen/trainable split is a *path predicate* (everything under the
top-level ``lora`` key trains), enforced by :class:`FrozenBaseOptimizer`.
JAX zeroes the frozen gradients and pins the frozen params and masters back
after the inner update; the port's AdamW writes its leaves in place, so the
wrapper hands it the trainable leaves only and never writes a frozen one.

Adapter checkpoints reuse the checkpoint format with only the
``params/lora/...`` leaves (:func:`save_adapter` / :func:`load_adapter`);
:func:`export_merged` folds the adapters into the base weights and writes
the flat per-layer export (:mod:`repro_torch.ckpt.export`).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import MetaGenerator
from ..models import base as B
from ..models.common import dense_init
from ..tree import tree_leaves, tree_map, tree_select

#: top-level params key holding the adapter subtree.
ADAPTER_KEY = "lora"

_DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Which leaves get adapters, and at what rank/scale.

    ``targets`` are fnmatch patterns matched against the *last* path
    component of each base-param leaf; only matrix-shaped leaves (>= 2
    non-layer dims) are eligible — vectors (norm scales, biases) never
    get factors."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = _DEFAULT_TARGETS

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {self.rank}")
        if not self.targets:
            raise ValueError("LoRA needs at least one target pattern")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _targeted(name: str, shape: Tuple[int, ...], axes: Tuple[str, ...],
              cfg: LoRAConfig) -> bool:
    stacked = bool(axes) and axes[0] == B.LAYER
    core = shape[1:] if stacked else shape
    if len(core) < 2:
        return False
    return any(fnmatch.fnmatch(name, pat) for pat in cfg.targets)


def _is_pair(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {"a", "b"}


def _walk_targets(shapes: Dict[str, Any], axes: Dict[str, Any],
                  cfg: LoRAConfig,
                  make: Callable[[str, Any, Tuple[str, ...]], Any]
                  ) -> Dict[str, Any]:
    """Mirror the base tree, keeping only targeted leaves (as ``make``'s
    output); prunes empty subtrees so the adapter tree stays minimal."""
    out: Dict[str, Any] = {}
    for key in shapes:
        node, ax = shapes[key], axes[key]
        if isinstance(node, dict):
            sub = _walk_targets(node, ax, cfg, make)
            if sub:
                out[key] = sub
        elif _targeted(key, tuple(node.shape), tuple(ax), cfg):
            out[key] = make(key, node, tuple(ax))
    return out


class _IEEEMatmul(torch.autograd.Function):
    """``a @ b`` (batched over leading dims) in IEEE f32, forward and
    backward: TF32 is switched off around each product whatever the global
    flag says — JAX pins ``_delta`` to ``Precision.HIGHEST``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _ieee(torch.matmul, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (_ieee(torch.matmul, g, b.transpose(-1, -2)),
                _ieee(torch.matmul, a.transpose(-1, -2), g))


def _ieee(fn, *args):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The low-rank update ``a @ b`` (batched over a leading layer dim when
    the factors are stacked), in IEEE f32: ``a [(L,) d, r]``, ``b [(L,) r,
    *out]`` -> ``[(L,) d, *out]``."""
    lead = b.shape[:a.dim() - 1]                  # (L, r) or (r,)
    out = b.shape[len(lead):]
    flat = b.reshape(lead + (math.prod(out),))
    return _IEEEMatmul.apply(a, flat).reshape(a.shape[:-1] + out)


def _mesh_delta(w, a, b):
    """:func:`_delta` of DTensor factors, laid out as the base leaf ``w``.

    Each rank computes its own block of ``w`` in ``local_map``
    (``base.local_call``; DTensor does not dispatch the custom
    ``_IEEEMatmul``): ``a`` comes in cut as ``w`` cuts its leading (layer,
    ``d_in``) dims and ``b`` as ``w`` cuts its output dims, the rank dim of
    both whole, so no rank contracts over part of the rank dim and every
    element is the one-device product.  A factor's gradient is a partial
    sum over the mesh dims that cut ``w`` along the other factor's dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..models.base import local_call

    lead = a.dim() - 1     # w's dims that a carries, (L,) d_in; b its others
    a_in, b_in, a_g, b_g = [], [], [], []
    for p in w.placements:
        d = p.dim % w.dim() if isinstance(p, Shard) else None
        if d is None:
            a_in.append(Replicate())
            b_in.append(Replicate())
            a_g.append(Replicate())
            b_g.append(Replicate())
        elif d < lead:     # the layer dim (both factors) or d_in (a's)
            a_in.append(Shard(d))
            b_in.append(Shard(d) if d < lead - 1 else Replicate())
            a_g.append(Shard(d))
            b_g.append(Shard(d) if d < lead - 1 else Partial())
        else:
            a_in.append(Replicate())
            b_in.append(Shard(d))
            a_g.append(Partial())
            b_g.append(Shard(d))
    return local_call(_delta, (a, b), (a_in, b_in), (a_g, b_g),
                      list(w.placements))


def merge_tree(base_params: Dict[str, Any], adapters: Dict[str, Any],
               scale: float) -> Dict[str, Any]:
    """Fold ``W + scale * a @ b`` into a copy of the base tree (f32 math,
    cast back to the leaf dtype).  DTensor leaves (a sharding plan's
    layout) merge on each rank's block (:func:`_mesh_delta`): each merged
    leaf keeps its base leaf's placements."""
    from ..models.base import is_dtensor

    out = dict(base_params)
    for key, node in adapters.items():
        if _is_pair(node):
            w = base_params[key]
            a, b = node["a"].float(), node["b"].float()
            d = _mesh_delta(w, a, b) if is_dtensor(w) else _delta(a, b)
            out[key] = (w.float() + scale * d).to(w.dtype)
        else:
            out[key] = merge_tree(base_params[key], node, scale)
    return out


def is_adapter_path(path: str) -> bool:
    """True for '/'-joined *param* paths inside the adapter subtree."""
    return path.split("/", 1)[0] == ADAPTER_KEY


class LoRAModel(B.Model):
    """Frozen base + trainable low-rank factors, same Model interface.

    Params are ``{**base_params, "lora": {...}}`` where the ``lora``
    subtree mirrors the base structure at targeted leaves, each replaced
    by an ``{a, b}`` pair (``a`` fan-in init, ``b`` zeros; stacked leaves
    keep the layer dim on both factors).  All forward methods merge on the
    fly and delegate, so the wrapper composes with every cache/serving path
    the base supports."""

    def __init__(self, base: B.Model, lora: LoRAConfig):
        self.base = base
        self.cfg = base.cfg
        self.lora = lora
        self._axes = base.param_axes()
        self._shapes = base.init(MetaGenerator())
        if ADAPTER_KEY in self._shapes:
            raise ValueError(
                f"base model already has a top-level {ADAPTER_KEY!r} params "
                f"entry; cannot inject adapters")
        n = len(tree_leaves(self.adapter_shapes()))
        if n == 0:
            raise ValueError(
                f"LoRA targets {list(lora.targets)} match no matrix leaves "
                f"of {type(base).__name__}")

    # -- structure ---------------------------------------------------------
    def _factor_shapes(self, shape, axes):
        r = self.lora.rank
        if axes[0] == B.LAYER:
            return (shape[0], shape[1], r), (shape[0], r) + shape[2:]
        return (shape[0], r), (r,) + shape[1:]

    def adapter_shapes(self) -> Dict[str, Any]:
        """The ``lora`` subtree as ``meta`` tensors (layout contract)."""
        def make(_name, leaf, axes):
            a, b = self._factor_shapes(tuple(leaf.shape), axes)
            return {"a": torch.empty(a, dtype=leaf.dtype, device="meta"),
                    "b": torch.empty(b, dtype=leaf.dtype, device="meta")}

        return _walk_targets(self._shapes, self._axes, self.lora, make)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """The base model's params from ``gen`` (those ``base.init(gen)``
        makes), then each ``a`` drawn from ``gen`` in tree order and each
        ``b`` zero.  The same seed gives other factors than JAX's (tests
        carry JAX's params across with ``bridge.params_from_jax``)."""
        base_params = self.base.init(gen)

        def make(_name, leaf, axes):
            a, b = self._factor_shapes(tuple(leaf.shape), axes)
            return {"a": dense_init(gen, a, in_axis_size=a[-2],
                                    dtype=leaf.dtype),
                    "b": torch.zeros(b, dtype=leaf.dtype, device=gen.device)}

        adapters = _walk_targets(self._shapes, self._axes, self.lora, make)
        return {**base_params, ADAPTER_KEY: adapters}

    def param_axes(self) -> Dict[str, Any]:
        def make(_name, _leaf, axes):
            if axes[0] == B.LAYER:
                return {"a": (B.LAYER, axes[1], B.LORA),
                        "b": (B.LAYER, B.LORA) + tuple(axes[2:])}
            return {"a": (axes[0], B.LORA),
                    "b": (B.LORA,) + tuple(axes[1:])}

        adapters = _walk_targets(self._shapes, self._axes, self.lora, make)
        return {**self._axes, ADAPTER_KEY: adapters}

    def merge(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Base-shaped params with the adapters folded in — what every
        forward method (and the merged export) runs on."""
        base_params = {k: v for k, v in params.items() if k != ADAPTER_KEY}
        return merge_tree(base_params, params[ADAPTER_KEY], self.lora.scale)

    # -- forward: merge then delegate --------------------------------------
    def apply(self, params, batch, mesh_ctx=None, storage_axes=()):
        return self.base.apply(self.merge(params), batch, mesh_ctx,
                               storage_axes)

    def prefill(self, params, *args, **kw):
        return self.base.prefill(self.merge(params), *args, **kw)

    def prefill_into(self, params, *args, **kw):
        return self.base.prefill_into(self.merge(params), *args, **kw)

    def prefill_chunk(self, params, *args, **kw):
        return self.base.prefill_chunk(self.merge(params), *args, **kw)

    def decode_step(self, params, *args, **kw):
        return self.base.decode_step(self.merge(params), *args, **kw)

    # cache management carries no params: pure delegation
    def init_cache(self, *args, **kw):
        return self.base.init_cache(*args, **kw)

    def init_paged_cache(self, *args, **kw):
        return self.base.init_paged_cache(*args, **kw)

    def insert_cache(self, *args, **kw):
        return self.base.insert_cache(*args, **kw)

    def supports_paged_cache(self) -> bool:
        return self.base.supports_paged_cache()


def zero_adapters(params: Dict[str, Any]) -> Dict[str, Any]:
    """Params with the adapter subtree zeroed: merged forward == frozen
    base.  The DPO reference policy under LoRA is exactly this tree."""
    zeroed = tree_map(torch.zeros_like, params[ADAPTER_KEY])
    return dict(params, **{ADAPTER_KEY: zeroed})


# ---------------------------------------------------------------------------
# frozen/trainable split
# ---------------------------------------------------------------------------
def _graft(tree, sub):
    """``tree`` with the leaves of ``sub`` (a subtree of it) put in."""
    out = dict(tree)
    for k, v in sub.items():
        out[k] = _graft(tree[k], v) if isinstance(v, dict) else v
    return out


@dataclasses.dataclass
class FrozenBaseOptimizer:
    """Optimizer wrapper enforcing a per-leaf trainable predicate.

    ``update`` computes what JAX's does (frozen gradients zeroed, the inner
    update, frozen params and ``master`` copies pinned back) by running the
    inner update on the trainable leaves alone: the clip norm is the
    trainable gradients' (the norm of JAX's zeroed tree), ``count``
    advances, and the frozen leaves' params, masters and moments are never
    written — their m and v stay the exact zeros ``init`` made, and stay in
    the state, so a checkpoint carries JAX's ``opt/m/...`` and
    ``opt/v/...`` leaves.  ``grads`` may hold the trainable leaves only
    (the train step differentiates those alone, see
    ``train.steps.value_and_grad``) or every leaf."""

    inner: Any
    trainable: Callable[[str], bool] = is_adapter_path

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, opt_state, params):
        keep = self.trainable
        sub_params = tree_select(params, keep)
        # the inner optimizer's state trees mirror the params (m, v,
        # master); its scalars (count) go through whole
        sub_state = {k: tree_select(v, keep) if isinstance(v, dict) else v
                     for k, v in opt_state.items()}
        new_sub, new_sub_state = self.inner.update(
            tree_select(grads, keep), sub_state, sub_params)
        new_state = {k: _graft(opt_state[k], v) if isinstance(v, dict) else v
                     for k, v in new_sub_state.items()}
        return _graft(params, new_sub), new_state

    def __getattr__(self, name):  # lr schedules, betas, ... for introspection
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)


def n_trainable(params: Dict[str, Any],
                trainable: Callable[[str], bool] = is_adapter_path
                ) -> Tuple[int, int]:
    """(trainable, total) param counts — the log line every LoRA run wants
    (``meta`` tensors count too)."""
    from ..ckpt.format import flatten_with_paths

    total = tr = 0
    for path, leaf in flatten_with_paths(params):
        n = math.prod(leaf.shape)
        total += n
        if trainable(path):
            tr += n
    return tr, total


# ---------------------------------------------------------------------------
# adapter checkpoints + merged export
# ---------------------------------------------------------------------------
def save_adapter(ckpt_dir: str, step: int, params: Dict[str, Any],
                 extra: Optional[Dict[str, Any]] = None) -> str:
    """Write an adapter-only checkpoint (just the ``params/lora/...``
    leaves) in the checkpoint format: :func:`load_adapter` and plain
    ``elastic.restore(..., strict=False)`` both read it back, in either
    package.  The leaves come to the host one at a time
    (:func:`_gathered`: under a plan each is gathered on every rank) and
    rank 0 alone writes; every rank returns the committed directory's
    path."""
    from ..ckpt.format import step_dirname, write_checkpoint
    from ..launch.mesh import process_rank

    sub = {ADAPTER_KEY: params[ADAPTER_KEY]}
    arrays = {f"params/{k}": v for k, v in _gathered(sub).items()}
    if process_rank() != 0:
        return os.path.join(ckpt_dir, step_dirname(step))
    return write_checkpoint(ckpt_dir, step, arrays,
                            extra={"adapter_only": True, **(extra or {})})


def load_adapter(params: Dict[str, Any], path: str,
                 shardings: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Restore the adapter subtree from an adapter(-or-full) checkpoint
    into ``params`` (onto its adapters' device), leaving the base
    untouched.  ``shardings`` (a params-shaped tree of
    ``plans.NamedSharding``, as ``plans.param_shardings`` gives it) lays
    the adapters out as DTensors, each rank cutting its block of the
    leaf it read on the host (``ckpt.elastic``)."""
    from ..ckpt import elastic as EL

    like = {ADAPTER_KEY: params[ADAPTER_KEY]}
    sh = ({ADAPTER_KEY: shardings[ADAPTER_KEY]}
          if shardings is not None else None)
    sub = EL.restore(like, path, sh, prefix="params")
    return dict(params, **{ADAPTER_KEY: sub[ADAPTER_KEY]})


def _gathered(tree) -> Dict[str, Any]:
    """``tree`` on the host, a DTensor leaf gathered to its full tensor one
    leaf at a time (``ckpt.engine``'s snapshot): rank 0 keeps each copy,
    the other ranks take part in the gathers and keep nothing (``{}``)."""
    from ..ckpt.format import flatten_with_paths
    from ..launch.mesh import process_rank
    from ..models.base import is_dtensor

    keep = process_rank() == 0
    out: Dict[str, Any] = {}
    for path, leaf in flatten_with_paths(tree):
        leaf = leaf.detach()
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        if keep:
            out[path] = leaf.cpu()
        del leaf
    return out


@torch.no_grad()
def export_merged(model: LoRAModel, params: Dict[str, Any],
                  out_dir: str) -> str:
    """Merge adapters into the base weights and write the flat per-layer
    export (the deploy artifact: serve it like any base checkpoint).
    Under a plan every rank merges its blocks, the merged leaves are
    gathered one at a time and rank 0 alone writes: the files equal the
    one-device run's."""
    from ..ckpt.export import export_flat
    from ..ckpt.format import unflatten_paths
    from ..launch.mesh import process_rank

    merged = model.merge(params)
    like = tree_map(lambda _: None, merged)
    host = _gathered(merged)
    del merged
    if process_rank() != 0:
        return os.path.join(out_dir, "export.npz")
    return export_flat(unflatten_paths(like, host), out_dir)


__all__: List[str] = [
    "ADAPTER_KEY", "LoRAConfig", "LoRAModel", "FrozenBaseOptimizer",
    "merge_tree", "zero_adapters", "is_adapter_path", "n_trainable",
    "save_adapter", "load_adapter", "export_merged",
]
