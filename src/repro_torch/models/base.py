"""Model IF and the unified architecture config (port of ``repro.models.base``).

The config dataclasses are copied field for field, so a YAML graph that
builds a config for the JAX package builds the same config here.  Params are
plain nested dicts of tensors in the JAX package's layout (stacked ``[L, ...]``
layer leaves, einsum-shaped projections), which is what ``repro_torch.bridge``
carries across.
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# ---------------------------------------------------------------------------
# Logical axis names of param leaves (``Model.param_axes``), which a sharding
# plan maps onto mesh axes (``repro_torch.sharding.plans``); LoRA reads the
# ``LAYER`` axis to tell stacked leaves from unstacked ones.
# ---------------------------------------------------------------------------
LAYER = "layer"          # stacked-layer dim (never sharded; scan dim)
VOCAB = "vocab"
D_MODEL = "d_model"      # residual stream
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
D_FF = "d_ff"            # MLP hidden
EXPERTS = "experts"      # MoE expert dim
D_EXPERT = "d_expert"    # MoE expert hidden
D_INNER = "d_inner"      # SSM inner dim
D_STATE = "d_state"      # SSM state dim
CONV_DIM = "conv_dim"
LORA = "lora"            # MLA latent dims and LoRA ranks
NONE = None              # unsharded (biases, norms, scalars)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int              # per-expert FFN hidden dim
    n_dense_layers: int = 0    # leading layers that use a dense FFN instead
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25  # slack for EP fixed-capacity select


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    head_dim_nope: int = 128
    head_dim_rope: int = 64
    head_dim_v: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "silu"               # silu (gated) | gelu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: every `attn_every`-th block is (shared) attention, rest SSM
    attn_every: int = 0
    shared_attn_block: bool = False
    # sliding-window attention (0 = full); used by dense archs for long_500k
    window: int = 0
    # enc-dec (audio): encoder depth/frames; frontend is a stub
    n_encoder_layers: int = 0
    encoder_frames: int = 1500
    # learned-position table size (enc-dec decoder)
    max_positions: int = 4096
    # vlm: number of stub image-patch embeddings prepended to the text
    n_patches: int = 0
    # MTP: extra next-next-token prediction head (deepseek-v3)
    mtp: bool = False
    # MLA decode: absorb wkv_b into q/out sides (no per-step KV expansion)
    mla_absorb: bool = False
    # route prefill self-attention through the hand-written CUDA flash
    # kernel (its plain PyTorch version for tensors on the CPU)
    use_flash_kernel: bool = False
    # FSDP unit size: layers per scan step (all-gather message granularity)
    scan_block_size: int = 1
    # activation-remat policy for scanned layer groups:
    # none | full | selective (dots_saveable)
    remat: str = "full"
    # source citation for the config
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class MeshContext:
    """Axis names the model needs when running distributed (None on 1
    device).  ``mesh`` is a ``torch.distributed.DeviceMesh`` whose dim
    names are JAX's axis names."""
    mesh: Any = None
    dp_axes: Tuple[str, ...] = ()      # batch axes, e.g. ("pod", "data")
    tp_axis: Optional[str] = None      # "model" (None => no TP / no EP)
    ep_enabled: bool = False           # route MoE through the EP path
    ep_axes: Tuple[str, ...] = ("model",)  # mesh axes experts shard over
    pp: int = 1                        # pipeline stage count (1 => unpipelined)
    pipe_axis: Optional[str] = None    # mesh axis the stage dim shards over
    n_micro: int = 0                   # microbatches (0 => 2*pp default)
    # the pipe axis's group, this rank's stage and the stage submesh
    # (``launch.mesh.pipe_of``); None with pp > 1 runs every stage here
    pipe: Any = None

    def stage_context(self) -> "MeshContext":
        """The context a pipeline stage's body runs under: no pipe axis,
        and in the pipe-sharded mode the submesh of the other dims."""
        mesh = self.mesh if self.pipe is None else self.pipe.stage_mesh
        return dataclasses.replace(self, mesh=mesh, pp=1, pipe_axis=None,
                                   pipe=None)

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or a tuple)."""
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        if isinstance(axes, str):
            return sizes[axes]
        return math.prod(sizes[a] for a in axes)

    @property
    def dp_size(self) -> int:
        if self.mesh is None or not self.dp_axes:
            return 1
        return self.axis_size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.axis_size(self.tp_axis)

    @property
    def ep_size(self) -> int:
        if self.mesh is None or not self.ep_axes:
            return 1
        return self.axis_size(self.ep_axes)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, mesh_ctx: Optional[MeshContext], *rest):
    """Lay out an activation whose dim 0 is batch (JAX's
    ``with_sharding_constraint``, here a ``redistribute`` to the same spec).

    ``rest`` entries are mesh-axis names (or None) for the remaining dims;
    entries are dropped when the dim isn't divisible.  No-op without a
    mesh.  A partial sum (a contraction over a sharded dim) is reduced
    here, where JAX's constraint makes XLA reduce it.  The gradient is laid
    out the same way in the backward, as JAX's constraint constrains the
    cotangent: DTensor alone would carry a partial-sum gradient on into
    the layer below, which then gathers its weights rather than reduce it.
    """
    if mesh_ctx is None or mesh_ctx.mesh is None:
        return x
    from ..sharding.plans import P, spec_placements

    spec = [None] * x.ndim
    dp = mesh_ctx.dp_axes
    # a batch of one stays replicated: on a mesh dim of size 1 the two are
    # the same block, and DTensor cannot reshape a sharded dim of size 1
    # (the einsums' views of a one-request admission)
    if dp and x.shape[0] % mesh_ctx.dp_size == 0 and x.shape[0] > 1:
        spec[0] = dp
    for i, ax in enumerate(rest[: x.ndim - 1], start=1):
        if ax is None:
            continue
        size = mesh_ctx.axis_size(ax)
        if x.shape[i] % size == 0 and x.shape[i] >= size:
            spec[i] = ax
    placements = spec_placements(mesh_ctx.mesh, P(*spec))
    return _ConstrainGrad.apply(x.redistribute(mesh_ctx.mesh, placements),
                                tuple(placements))


class _ConstrainGrad(torch.autograd.Function):
    """Identity forward; the backward lays the gradient out like the
    forward's output (``constrain``)."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.mesh, ctx.placements = t.device_mesh, placements
        return t

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None


def gather_fsdp(tree, mesh_ctx: Optional[MeshContext]):
    """The FSDP all-gather of a param tree: every leaf redistributed to
    ``Replicate`` on all mesh dims but the TP axis, where it keeps its
    shard.  Its backward reduce-scatters the gradient back to the leaf's
    layout (ZeRO-3's schedule)."""
    if mesh_ctx is None or mesh_ctx.mesh is None:
        return tree
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_ctx.mesh.mesh_dim_names

    def gather(t):
        keep = [p if (isinstance(p, Shard) and name == mesh_ctx.tp_axis)
                else Replicate() for name, p in zip(names, t.placements)]
        if list(keep) == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, keep)

    if isinstance(tree, dict):
        return {k: gather_fsdp(v, mesh_ctx) for k, v in tree.items()}
    return gather(tree)


def replicate_like(t, ref):
    """A plain tensor ``t`` as a replicated DTensor on ``ref``'s mesh (a
    constant that meets DTensor activations); ``t`` itself when ``ref`` is
    a plain tensor or ``t`` a DTensor already."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def contiguous_grad(t):
    """``t``, whose gradient leaves contiguous: a DTensor takes a local
    tensor's layout on trust (``local_call``'s ``from_local``), so a later
    view of a block whose gradient came back permuted fails (attention's
    backwards return such)."""
    return _ContiguousGrad.apply(t)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn, args, in_placements, grad_placements, out_placements):
    """``fn`` on each rank's local blocks of the DTensors ``args``, through
    ``torch.distributed.tensor.experimental.local_map``: a hand-written
    kernel runs on local tensors, never on a DTensor.

    Each argument is redistributed to its ``in_placements`` first.  Its
    ``grad_placements`` say what its local gradient is: a replicated input
    that every rank reads for its own rows or heads has a partial-sum
    gradient (``Partial()``).  ``out_placements`` is one list of
    placements, or a tuple of them for several outputs.  ``fn``'s local
    gradients must be contiguous (:func:`contiguous_grad`)."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=tuple(grad_placements),
                     device_mesh=args[0].device_mesh,
                     redistribute_inputs=True)(*args)


def shard_roles(t, roles: Dict[int, str], all_dims: bool = False) -> List:
    """Per mesh dim of the DTensor ``t``: ``roles[d]`` where that mesh dim
    shards tensor dim ``d`` (a name the caller gives each dim), else None.
    A mesh dim of size 1 holds the whole tensor whatever its placement,
    so it has no role unless ``all_dims``."""
    from torch.distributed.tensor import Shard

    out: List = []
    for i, p in enumerate(t.placements):
        big = all_dims or t.device_mesh.size(i) > 1
        out.append(roles.get(p.dim % t.ndim) if big and isinstance(p, Shard)
                   else None)
    return out


def mesh_coord(mesh, dims) -> Tuple[int, int]:
    """(this rank's index, the count) of the blocks that the mesh dims
    ``dims`` (indices, in mesh order) cut one tensor dim into: DTensor
    splits a dim over several mesh dims major to minor, in mesh order."""
    c, n = 0, 1
    for i in dims:
        c, n = c * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
    return c, n


def local_cache_call(fn, cache: Sequence[Any], args: Sequence[Any],
                     in_placements, out_placements):
    """``fn(*cache_blocks, *arg_blocks)`` on each rank: a decode core that
    writes the cache in place, on each rank's own block of it.

    ``cache`` are DTensors (cache leaves, or layer views of them) passed
    as their local blocks, never redistributed: the blocks are views of
    the cache's storage, so ``fn``'s in-place writes land in the cache and
    its placements are the same after the call as before.  ``args`` are
    redistributed to ``in_placements`` first (as :func:`local_call` does),
    and the outputs come back as DTensors with ``out_placements`` (one
    list, or a tuple of them)."""
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(list(c.placements) for c in cache) + tuple(in_placements)
    return local_map(fn, out_placements=out_placements, in_placements=pl,
                     in_grad_placements=pl, device_mesh=cache[0].device_mesh,
                     redistribute_inputs=True)(*cache, *args)


def put_slot(c, n, slot: int) -> None:
    """Write a batch=1 request's cache leaf ``n`` ``[L, 1, ...]`` into slot
    ``slot`` of the pool leaf ``c`` ``[L, n_slots, ...]``, in place.  Under
    a mesh (``c`` a DTensor laid out by ``plans.cache_shardings``) the rank
    whose block holds the slot writes it into its block, the request's rows
    cut as the pool's other dims are; the others write nothing."""
    if not is_dtensor(c):
        c[:, slot] = n[:, 0].to(c.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = c.device_mesh
    rows = [i for i, p in enumerate(c.placements)
            if isinstance(p, Shard) and p.dim % c.ndim == 1]
    want = [Replicate() if i in rows else p
            for i, p in enumerate(c.placements)]
    n = replicate_like(n, c).redistribute(mesh, want)
    local = c.to_local()
    coord, _ = mesh_coord(mesh, rows)
    lo = coord * local.shape[1]
    if lo <= slot < lo + local.shape[1]:
        local[:, slot - lo] = n.to_local()[:, 0].to(local.dtype)


class Model(abc.ABC):
    """The model IF: params are a nested dict of tensors, methods are plain
    functions of (params, inputs)."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    @abc.abstractmethod
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params, made on ``gen.device`` from ``gen``."""

    @abc.abstractmethod
    def param_axes(self) -> Dict[str, Any]:
        """A tree like ``init``'s with a tuple of logical axis names per
        leaf."""

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> Any:
        raise NotImplementedError(f"{self.cfg.name}: no decode path")

    def decode_step(self, params, cache, tokens, positions, mesh_ctx=None):
        raise NotImplementedError(f"{self.cfg.name}: no decode path")

    def supports_paged_cache(self) -> bool:
        return False

    def insert_cache(self, cache: Any, request_cache: Any, slot: int) -> Any:
        """Write a batch=1 request cache into one slot of a slot-pool cache.

        Every leaf of ``cache`` is ``[L, n_slots, ...]``; the whole slot row is
        overwritten, so no stale state survives a slot's reuse.  In place:
        where JAX donated the pool and returned a new one, the port writes
        into the pool's storage and returns the same tree; under a mesh on
        the rank that holds the slot (:func:`put_slot`).
        """
        _tree_zip(lambda c, n: put_slot(c, n, slot), cache, request_cache)
        return cache


def _tree_zip(fn, a, b):
    """Apply ``fn(leaf_a, leaf_b)`` over two dicts of the same structure."""
    if isinstance(a, dict):
        for key in a:
            _tree_zip(fn, a[key], b[key])
    else:
        fn(a, b)
