"""Sharding plans — the paper's parallelization strategies as pluggable
components (FSDP / HSDP / TP / EP and their compositions), port of
``repro.sharding.plans``.

A plan maps each param leaf's *logical axes* (from ``model.param_axes()``)
to mesh axes.  The plan algebra (:class:`ShardingPlan`, the catalog,
:func:`leaf_spec` and its divisibility fallbacks, the warning strings) is
JAX's, rule for rule, and yields JAX's ``PartitionSpec`` per leaf
(:class:`PartitionSpec`, a tuple with JAX's entries: ``None``, an axis name,
or a tuple of axis names).  On a ``torch.distributed.DeviceMesh`` whose dim
names are JAX's axis names (``data``, ``model``, ``pipe``, ``pod``) a spec
becomes DTensor placements: an entry naming axes ``(a, b)`` for tensor dim
``d`` is ``Shard(d)`` on mesh dims ``a`` and ``b``.  DTensor splits a dim
sharded over several mesh dims in mesh-dim order, which is the block
JAX's ``NamedSharding`` gives each device when the entry names its axes in
mesh order, as every catalog plan does; an entry in another order raises.

Leaves are never reshaped by a plan: stored trees keep their
plan-independent ``[L, ...]`` shapes, so a checkpoint restores under any
plan (``repro_torch.ckpt.elastic``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..models import base as B

# logical axes that Megatron-style TP shards over the model axis
TP_AXES = {B.HEADS, B.KV_HEADS, B.D_FF, B.VOCAB, B.D_INNER, B.CONV_DIM,
           B.D_EXPERT}

#: what the rest of the parallelism item brings (LoRA under a plan, MLA,
#: the hybrid, Whisper and LLaVA under a mesh), after the GPipe schedule,
#: expert parallelism and sharded serving
A8B = "ROADMAP A8b (LoRA, MLA and the other archs under a mesh)"


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """A composition of parallelization strategies."""

    name: str
    tp: bool = False                       # tensor parallelism over `model`
    fsdp_axes: Tuple[str, ...] = ()        # param shard axes (largest-dim rule)
    dp_axes: Tuple[str, ...] = ("data",)   # batch shard axes
    ep: bool = False                       # expert parallelism over `model`
    ep_storage_axes: Tuple[str, ...] = ()  # expert-weight storage sharding
    ep_axes: Tuple[str, ...] = ("model",)  # mesh axes the expert dim shards over
    pp: int = 1                            # pipeline stages over `pipe_axis`
    pipe_axis: str = "pipe"                # mesh axis the stage dim shards over
    n_micro: int = 0                       # microbatches (0 -> 2*pp default)

    def describe(self) -> str:
        parts = [f"dp={','.join(self.dp_axes)}"]
        if self.fsdp_axes:
            parts.append(f"fsdp={','.join(self.fsdp_axes)}")
        if self.tp:
            parts.append("tp=model")
        if self.ep:
            parts.append(
                "ep=" + ",".join(self.ep_axes)
                + (f"+storage={','.join(self.ep_storage_axes)}"
                   if self.ep_storage_axes else "")
            )
        if self.pp > 1:
            parts.append(f"pp={self.pp}@{self.pipe_axis}"
                         f"(m={self.n_micro or 2 * self.pp})")
        return f"{self.name}({'; '.join(parts)})"

    def effective_n_micro(self, global_batch: int = 0) -> int:
        """Microbatch count actually used by the schedule: ``n_micro`` (or
        the ``2*pp`` default) reduced to the largest divisor of the global
        batch so every microbatch is equal-sized."""
        from . import pipeline as PIPE

        return PIPE.effective_n_micro(self.n_micro, self.pp, global_batch)


def make_plan(name: str, multi_pod: bool = False) -> ShardingPlan:
    """The built-in strategy catalog (registered as components)."""
    pod = ("pod",) if multi_pod else ()
    dp = pod + ("data",)
    plans = {
        # pure data parallel: params replicated (paper's DDP baseline)
        "ddp": ShardingPlan("ddp", dp_axes=dp),
        # FSDP: fully shard params over ALL data axes (ZeRO-3)
        "fsdp": ShardingPlan("fsdp", fsdp_axes=dp, dp_axes=dp),
        # HSDP: shard within pod, replicate across pods (paper's hybrid)
        "hsdp": ShardingPlan("hsdp", fsdp_axes=("data",), dp_axes=dp),
        # 2D/3D: FSDP × TP
        "fsdp_tp": ShardingPlan("fsdp_tp", tp=True, fsdp_axes=dp, dp_axes=dp),
        "hsdp_tp": ShardingPlan("hsdp_tp", tp=True, fsdp_axes=("data",), dp_axes=dp),
        # MoE: FSDP × TP × EP (experts over model, storage over data)
        "fsdp_tp_ep": ShardingPlan(
            "fsdp_tp_ep", tp=True, fsdp_axes=dp, dp_axes=dp, ep=True,
            ep_storage_axes=("data",),
        ),
        "hsdp_tp_ep": ShardingPlan(
            "hsdp_tp_ep", tp=True, fsdp_axes=("data",), dp_axes=dp, ep=True,
            ep_storage_axes=("data",),
        ),
        # serving plan: no FSDP (no optimizer state at inference) — experts
        # sharded over EVERY chip (EP degree = data x model), dense/attention
        # TP over model
        "serve_ep": ShardingPlan(
            "serve_ep", tp=True, fsdp_axes=(), dp_axes=("data",), ep=True,
            ep_storage_axes=(), ep_axes=pod + ("data", "model"),
        ),
        # 3D: pipeline stages x FSDP (x TP x EP). The stage dim rides the
        # `pipe` mesh axis; FSDP/TP shard each stage's slice as usual.
        "pp2_fsdp": ShardingPlan("pp2_fsdp", fsdp_axes=dp, dp_axes=dp, pp=2),
        "pp2_fsdp_tp": ShardingPlan(
            "pp2_fsdp_tp", tp=True, fsdp_axes=dp, dp_axes=dp, pp=2),
        "pp2_fsdp_tp_ep": ShardingPlan(
            "pp2_fsdp_tp_ep", tp=True, fsdp_axes=dp, dp_axes=dp, ep=True,
            ep_storage_axes=("data",), pp=2,
        ),
    }
    if name not in plans:
        raise ValueError(f"unknown plan {name!r}; available: {sorted(plans)}")
    return plans[name]


#: the catalog's names, in ``make_plan``'s order
CATALOG = ("ddp", "fsdp", "hsdp", "fsdp_tp", "hsdp_tp", "fsdp_tp_ep",
           "hsdp_tp_ep", "serve_ep", "pp2_fsdp", "pp2_fsdp_tp",
           "pp2_fsdp_tp_ep")

_PLAN_FIELDS = {f.name: f for f in dataclasses.fields(ShardingPlan)}
_AXIS_FIELDS = {"fsdp_axes", "dp_axes", "ep_storage_axes", "ep_axes"}


def custom_plan(spec: Dict[str, Any]) -> ShardingPlan:
    """Build a validated :class:`ShardingPlan` from a field mapping — the
    declarative `plan: {tp: true, pp: 2, ...}` form in run YAML.  A bare
    string is a catalog lookup, so sweeps can grid over both forms."""
    if isinstance(spec, str):
        return make_plan(spec)
    if isinstance(spec, ShardingPlan):
        return spec
    if not isinstance(spec, dict):
        raise ValueError(f"plan spec must be a name or mapping, got {type(spec)}")
    kw: Dict[str, Any] = dict(spec)
    unknown = set(kw) - set(_PLAN_FIELDS)
    if unknown:
        raise ValueError(
            f"unknown plan field(s) {sorted(unknown)}; valid: "
            f"{sorted(_PLAN_FIELDS)}")
    for k in _AXIS_FIELDS & set(kw):
        v = kw[k]
        if isinstance(v, str):
            v = (v,)
        if not (isinstance(v, (list, tuple))
                and all(isinstance(a, str) for a in v)):
            raise ValueError(f"plan.{k} must be a list of mesh-axis names, "
                             f"got {kw[k]!r}")
        kw[k] = tuple(v)
    for k in ("tp", "ep"):
        if k in kw and not isinstance(kw[k], bool):
            raise ValueError(f"plan.{k} must be a bool, got {kw[k]!r}")
    for k in ("pp", "n_micro"):
        if k in kw:
            if not isinstance(kw[k], int) or isinstance(kw[k], bool) or kw[k] < 0:
                raise ValueError(f"plan.{k} must be a non-negative int, "
                                 f"got {kw[k]!r}")
    if kw.get("pp", 1) < 1:
        raise ValueError("plan.pp must be >= 1")
    if "pipe_axis" in kw and not isinstance(kw["pipe_axis"], str):
        raise ValueError(f"plan.pipe_axis must be a str, got {kw['pipe_axis']!r}")
    kw.setdefault("name", "custom")
    plan = ShardingPlan(**kw)
    if plan.pp > 1 and plan.pipe_axis in plan.dp_axes + plan.fsdp_axes:
        raise ValueError(
            f"plan.pipe_axis {plan.pipe_axis!r} collides with dp/fsdp axes")
    return plan


def default_plan_for(cfg: B.ArchConfig, multi_pod: bool = False) -> ShardingPlan:
    if cfg.arch_type == "moe":
        return make_plan("fsdp_tp_ep" if not multi_pod else "hsdp_tp_ep", multi_pod)
    return make_plan("fsdp_tp" if not multi_pod else "hsdp_tp", multi_pod)


# ---------------------------------------------------------------------------
# specs and their DTensor placements
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per tensor dim, each ``None``, a
    mesh-axis name, or a tuple of mesh-axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its dim names and shape),
    of a mapping, or of any object whose ``shape`` is such a mapping (a
    stand-in mesh of that shape, as the tests build)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: JAX's ``NamedSharding``, with the DTensor
    ``placements`` it stands for."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> List[Any]:
        return spec_placements(self.mesh, self.spec)


def spec_placements(mesh, spec) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d``'s entry names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} names mesh axes out of the mesh's "
                f"order {tuple(names)}: DTensor shards one tensor dim over "
                f"several mesh dims in mesh order only")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r} uses mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(d)
    return out


def placements_spec(mesh, placements, ndim: int) -> PartitionSpec:
    """The inverse of :func:`spec_placements`: JAX's spec for a DTensor's
    placements (a bare name for one mesh axis, a tuple for several)."""
    from torch.distributed.tensor import Shard

    entries: List[Any] = [None] * ndim
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            d = p.dim % ndim
            cur = entries[d]
            entries[d] = name if cur is None else (
                (cur if isinstance(cur, tuple) else (cur,)) + (name,))
    return P(*entries)


# ---------------------------------------------------------------------------
# param specs
# ---------------------------------------------------------------------------
def _axes_size(mesh: Dict[str, int], axes: Tuple[str, ...]) -> int:
    return math.prod(mesh[a] for a in axes)


def _norm_axes(axes: Tuple[str, ...]):
    """Singleton axis tuples become bare names: newer PartitionSpec no longer
    normalizes ("data",) -> "data" itself, and the two spell the same
    sharding."""
    return axes if len(axes) > 1 else axes[0]


def leaf_spec(plan: ShardingPlan, mesh, shape: Tuple[int, ...],
              logical: Tuple[Any, ...], warnings: Optional[List[str]] = None,
              path: str = "") -> PartitionSpec:
    """JAX's ``leaf_spec``, rule for rule, over ``mesh``'s axis sizes
    (:func:`axis_sizes`)."""
    assert len(shape) == len(logical), f"{path}: {shape} vs {logical}"
    sizes = axis_sizes(mesh)
    spec: List[Any] = [None] * len(shape)
    tp_size = sizes.get("model", 1)

    # pipeline stages: the stacked LAYER dim is split into `pp` contiguous
    # chunks over the pipe axis, while the stored tree keeps its
    # plan-independent [L, ...] shape
    if plan.pp > 1 and plan.pipe_axis in sizes and B.LAYER in logical:
        l_dim = logical.index(B.LAYER)
        pp_size = sizes[plan.pipe_axis]
        if shape[l_dim] % pp_size == 0 and shape[l_dim] >= pp_size:
            spec[l_dim] = plan.pipe_axis
        elif warnings is not None:
            warnings.append(
                f"{path}: layers {shape[l_dim]} !% pp {pp_size} -> unstaged")

    is_expert = B.EXPERTS in logical
    if plan.ep and is_expert:
        e_dim = logical.index(B.EXPERTS)
        ep_size = _axes_size(sizes, plan.ep_axes)
        if shape[e_dim] % ep_size == 0:
            spec[e_dim] = _norm_axes(plan.ep_axes)
        elif warnings is not None:
            warnings.append(f"{path}: experts {shape[e_dim]} !% ep {ep_size}")
        if plan.ep_storage_axes and B.D_MODEL in logical:
            d_dim = logical.index(B.D_MODEL)
            if shape[d_dim] % _axes_size(sizes, plan.ep_storage_axes) == 0:
                spec[d_dim] = _norm_axes(plan.ep_storage_axes)
        return P(*spec)

    if plan.tp:
        for i, (n, ax) in enumerate(zip(shape, logical)):
            if ax in TP_AXES:
                if n % tp_size == 0:
                    spec[i] = "model"
                    break  # one TP axis per tensor
                elif warnings is not None:
                    warnings.append(f"{path}: {ax}={n} !% model {tp_size} -> replicated")

    if plan.fsdp_axes:
        fs = _axes_size(sizes, plan.fsdp_axes)
        # largest unassigned, non-layer dim divisible by the fsdp extent
        cands = [
            (n, i)
            for i, (n, ax) in enumerate(zip(shape, logical))
            if spec[i] is None and ax is not B.LAYER and n % fs == 0 and n >= fs
        ]
        if cands:
            _, i = max(cands)
            spec[i] = _norm_axes(plan.fsdp_axes)
        elif warnings is not None and max(shape, default=0) > 1024:
            warnings.append(f"{path}: no dim divisible by fsdp {fs} in {shape}")
    return P(*spec)


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` in JAX's flatten order (dict keys sorted);
    paths spelled as ``jax.tree_util.keystr`` spells them."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    return [(path, tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` (a dict tree) holding ``leaves`` in JAX's
    flatten order, its dicts in ``like``'s own key order."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            filled = {k: fill(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        return next(it)

    return fill(like)


def param_specs(plan: ShardingPlan, mesh, param_shapes,
                param_axes) -> Tuple[Any, List[str]]:
    """A tree of :class:`PartitionSpec` for the param tree (leaves: tensors,
    on ``meta`` or anywhere, or shape tuples) + divisibility warnings, in
    JAX's order."""
    warnings: List[str] = []
    leaves = _flatten(param_shapes)
    axes = [a for _, a in _flatten_axes(param_axes)]
    assert len(leaves) == len(axes), (
        f"param/axes tree mismatch: {len(leaves)} vs {len(axes)}")
    specs = [leaf_spec(plan, mesh, _shape(leaf), logical, warnings, path)
             for (path, leaf), logical in zip(leaves, axes)]
    return _unflatten(param_shapes, specs), warnings


def _flatten_axes(tree, path: str = ""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_axes(tree[k], f"{path}[{k!r}]")
        return out
    assert isinstance(tree, tuple), f"{path}: axes leaf {tree!r} is no tuple"
    return [(path, tree)]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, (tuple, list)) else tuple(leaf.shape)


def param_shardings(plan: ShardingPlan, mesh, param_shapes,
                    param_axes) -> Tuple[Any, List[str]]:
    """Tree of :class:`NamedSharding` for the param tree + divisibility
    warnings."""
    specs, warnings = param_specs(plan, mesh, param_shapes, param_axes)
    return _map_specs(lambda s: NamedSharding(mesh, s), specs), warnings


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------
def batch_shardings(plan: ShardingPlan, mesh, batch_shapes) -> Any:
    """A :class:`NamedSharding` per batch leaf: the batch dim over the plan's
    dp axes when it divides, else (long-context decode) the sequence dim
    over ``data``."""
    sizes = axis_sizes(mesh)
    dp = plan.dp_axes
    dp_size = _axes_size(sizes, dp)

    def spec(leaf):
        shape = _shape(leaf)
        bdim = shape[0] if shape else 0
        s: List[Any] = [None] * len(shape)
        if bdim and bdim % dp_size == 0:
            s[0] = dp
        elif len(shape) >= 2:
            if shape[1] % sizes.get("data", 1) == 0 and shape[1] > 1:
                s[1] = "data"
        return NamedSharding(mesh, P(*s))

    return _map_specs(spec, batch_shapes)


# ---------------------------------------------------------------------------
# cache specs (serving)
# ---------------------------------------------------------------------------
def cache_specs(plan: ShardingPlan, mesh, cache_shapes,
                paged: bool = False) -> Any:
    """A :class:`PartitionSpec` per cache leaf: JAX's ``cache_shardings``
    rule, leaf by leaf (the caches are stacked ``[L, B, ...]`` in both
    packages).  The batch (slot, or paged block) dim goes over the plan's
    dp axes when it divides; an attention leaf ``[L, B, S, K, dh]`` has its
    KV-head dim over ``model`` when that divides, else its sequence dim;
    when the batch does not divide, the sequence dim goes over ``data``
    too (``("data", "model")`` where it already names ``model``).  A
    ``conv`` leaf ``[L, B, W-1, conv_dim]`` shards its last dim over
    ``model`` and an ``ssm`` leaf ``[L, B, H, P, N]`` its head dim, where
    they divide.

    ``paged``: the leaves are the port's block pool ``[L, n_blocks + 1,
    block_len, K, dh]``, whose last block is the scratch block that takes
    suppressed writes (``models.attention``); JAX's pool has ``n_blocks``.
    The rule is applied to the ``n_blocks`` real pages, so they are laid
    out as JAX lays out its pool, and the scratch block is kept on every
    rank: see :func:`pool_zeros`."""
    sizes = axis_sizes(mesh)
    dp = plan.dp_axes
    dp_size = _axes_size(sizes, dp)
    tp = sizes.get("model", 1)
    data = sizes.get("data", 1)

    def spec(path, shape):
        shape = list(shape)
        if paged and len(shape) >= 2:
            shape[1] -= 1
        s: List[Any] = [None] * len(shape)
        b_dim = 1 if len(shape) >= 2 else 0
        batch_ok = shape[b_dim] % dp_size == 0
        if batch_ok:
            s[b_dim] = _norm_axes(dp)
        if "conv" in path:
            if shape[-1] % tp == 0:
                s[-1] = "model"
            return P(*s)
        if "ssm" in path:
            if len(shape) >= 3 and shape[2] % tp == 0:
                s[2] = "model"
            return P(*s)
        seq_dim = 2 if len(shape) >= 3 else None
        kv_dim = 3 if len(shape) >= 5 else None
        if kv_dim is not None and shape[kv_dim] % tp == 0:
            s[kv_dim] = "model"
        elif seq_dim is not None and shape[seq_dim] % tp == 0:
            s[seq_dim] = "model"
        if not batch_ok and seq_dim is not None:
            cur = s[seq_dim]
            if shape[seq_dim] % (data * (tp if cur == "model" else 1)) == 0:
                s[seq_dim] = ("data", "model") if cur == "model" else "data"
        return P(*s)

    leaves = _flatten(cache_shapes)
    return _unflatten(cache_shapes,
                      [spec(path, _shape(leaf)) for path, leaf in leaves])


def cache_shardings(plan: ShardingPlan, mesh, cache_shapes,
                    batch_size: int = 0, paged: bool = False) -> Any:
    """A :class:`NamedSharding` per cache leaf (:func:`cache_specs`;
    ``batch_size`` is JAX's argument, which its rule does not read)."""
    return _map_specs(lambda s: NamedSharding(mesh, s),
                      cache_specs(plan, mesh, cache_shapes, paged))


def pool_zeros(shapes, shardings, device, paged: bool = False):
    """A zeroed cache laid out as ``shardings`` (:func:`cache_shardings`),
    each rank allocating only its block: DTensors whose placements stay
    what ``shardings`` says for the life of the pool (every cache write is
    made in place on a rank's own block, ``models.base.local_cache_call``).

    ``paged``: each rank's block of the pool is its share of the
    ``n_blocks`` real pages (the block :func:`cache_specs` gives them) and
    then one scratch block of its own, so a split that is even over the
    real pages stays even: with the block dim over ``dp`` ranks the
    DTensor's global block dim is ``n_blocks + dp`` and rank ``r`` holds
    real pages ``[r * n_blocks / dp, (r + 1) * n_blocks / dp)``; with it
    not sharded, ``n_blocks + 1`` as with no mesh."""
    import torch
    from torch.distributed.tensor import DTensor

    def make(shape_like, sh):
        shape = list(_shape(shape_like))
        if paged:
            shape[1] -= 1
        meta = torch.empty(shape, device="meta")
        local = list(local_block(meta, sh.mesh, sh.placements).shape)
        if paged:
            local[1] += 1
        t = torch.zeros(local, dtype=shape_like.dtype, device=device)
        return DTensor.from_local(t, sh.mesh, sh.placements, run_check=False)

    if isinstance(shapes, dict):
        return {k: pool_zeros(v, shardings[k], device, paged)
                for k, v in shapes.items()}
    return make(shapes, shardings)


# ---------------------------------------------------------------------------
# spec serialization (checkpoint manifests record every leaf's layout)
# ---------------------------------------------------------------------------
def spec_to_json(spec) -> List[Any]:
    """PartitionSpec -> JSON-able list: each entry None | axis | [axes...]."""
    out: List[Any] = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry])
        else:
            out.append(str(entry))
    return out


def spec_from_json(obj: Optional[List[Any]]) -> PartitionSpec:
    """The inverse of :func:`spec_to_json` (None -> fully replicated)."""
    if not obj:
        return P()
    entries = [tuple(e) if isinstance(e, list) else e for e in obj]
    return P(*entries)


# ---------------------------------------------------------------------------
# full-train-state shardings (the gym's layout; elastic restore re-derives
# the same tree for a DIFFERENT plan/mesh than a checkpoint was saved on)
# ---------------------------------------------------------------------------
def train_state_shardings(plan: ShardingPlan, mesh, model,
                          optimizer, seed: int = 0) -> Tuple[Any, List[str]]:
    """``({"params", "opt", "step"} sharding tree, warnings)``; shapes come
    from the model and optimizer on ``meta`` (JAX's ``eval_shape``)."""
    from ..device import MetaGenerator
    from ..train import steps as ST

    pshapes = model.init(MetaGenerator().manual_seed(seed))
    pspecs, warnings = param_shardings(plan, mesh, pshapes, model.param_axes())
    rep = NamedSharding(mesh, P())
    opt_shapes = optimizer.init(pshapes)
    return {
        "params": pspecs,
        "opt": ST.opt_state_shardings(opt_shapes, pspecs, rep),
        "step": rep,
    }, warnings


def local_block(t, mesh, placements):
    """This rank's block of the full tensor ``t`` under ``placements`` on
    ``mesh``, cut where ``t`` lies (a view): DTensor's own split, each
    ``Shard(d)`` mesh dim in mesh order cutting dim ``d`` into
    ``torch.chunk``'s pieces, an empty block for a coordinate past the
    last piece."""
    import torch
    from torch.distributed.tensor import Shard

    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d = p.dim % t.ndim
        pieces = torch.chunk(t, mesh.size(i), dim=d)
        coord = mesh.get_local_rank(i)
        t = pieces[coord] if coord < len(pieces) else t.narrow(d, 0, 0)
    return t


def distribute(tree, shardings):
    """Lay ``tree``'s tensors out as DTensors under ``shardings`` (a
    matching tree of :class:`NamedSharding`, or None leaves: left as they
    are).  Every rank holds the same full tensor and keeps its own block:
    no data moves between ranks."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, sh):
        if sh is None:
            return t
        return distribute_tensor(t, sh.mesh, sh.placements,
                                 src_data_rank=None)

    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k] if shardings is not None
                              else None) for k, v in tree.items()}
    return put(tree, shardings)


def mesh_context(plan: ShardingPlan, mesh) -> B.MeshContext:
    """The model's view of ``plan`` on ``mesh`` (JAX's ``mesh_context``).
    The pipeline is active only when the mesh carries the plan's pipe axis
    (a pp plan on a ``data x model`` mesh runs its unpipelined core, as TP
    and EP degrade on a 1-wide model axis); on a ``DeviceMesh`` the context
    then holds the pipe axis's handles (``launch.mesh.pipe_of``)."""
    sizes = axis_sizes(mesh)
    pp = 1
    if plan.pp > 1 and plan.pipe_axis in sizes:
        pp = sizes[plan.pipe_axis]
        if pp != plan.pp:
            raise ValueError(
                f"plan {plan.name!r} wants pp={plan.pp} but mesh axis "
                f"{plan.pipe_axis!r} has {pp} devices")
    pipe = None
    if pp > 1 and hasattr(mesh, "get_group"):
        from ..launch.mesh import pipe_of

        pipe = pipe_of(mesh, plan.pipe_axis)
    return B.MeshContext(
        mesh=mesh,
        dp_axes=plan.dp_axes,
        tp_axis="model" if (plan.tp or plan.ep) else None,
        ep_enabled=plan.ep,
        ep_axes=plan.ep_axes,
        pp=pp,
        pipe_axis=plan.pipe_axis if pp > 1 else None,
        n_micro=plan.n_micro,
        pipe=pipe,
    )


def pipeline_info(plan: ShardingPlan, mesh=None,
                  global_batch: int = 0) -> Dict[str, Any]:
    """Analytic pipeline telemetry for results/BENCH rows: stage count,
    effective microbatches, and the GPipe bubble fraction."""
    from . import pipeline as PIPE

    pp = plan.pp
    if mesh is None or plan.pipe_axis not in axis_sizes(mesh):
        pp = 1
    m = plan.effective_n_micro(global_batch) if pp > 1 else 1
    return {
        "pp": pp,
        "pipe_axis": plan.pipe_axis if pp > 1 else None,
        "n_micro": m,
        "bubble_fraction": PIPE.bubble_fraction(pp, m),
    }
