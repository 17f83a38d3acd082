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
from typing import Any, Dict, Optional

import torch

# ---------------------------------------------------------------------------
# Logical axis names of param leaves (``Model.param_axes``).  The port trains
# on one device, so no plan maps them onto a mesh yet (ROADMAP A8); LoRA reads
# the ``LAYER`` axis to tell stacked leaves from unstacked ones.
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

    def decode_step(self, params, cache, tokens, positions):
        raise NotImplementedError(f"{self.cfg.name}: no decode path")

    def supports_paged_cache(self) -> bool:
        return False

    def insert_cache(self, cache: Any, request_cache: Any, slot: int) -> Any:
        """Write a batch=1 request cache into one slot of a slot-pool cache.

        Every leaf of ``cache`` is ``[L, n_slots, ...]``; the whole slot row is
        overwritten, so no stale state survives a slot's reuse.  In place:
        where JAX donated the pool and returned a new one, the port writes
        into the pool's storage and returns the same tree.
        """
        def put(c, n):
            c[:, slot] = n[:, 0].to(c.dtype)

        _tree_zip(put, cache, request_cache)
        return cache


def _tree_zip(fn, a, b):
    """Apply ``fn(leaf_a, leaf_b)`` over two dicts of the same structure."""
    if isinstance(a, dict):
        for key in a:
            _tree_zip(fn, a[key], b[key])
    else:
        fn(a, b)
