"""Shared building blocks: norms, rotary embeddings, parameter init
(port of ``repro.models.common``)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Sequence[int],
               in_axis_size: Optional[int] = None, dtype=torch.float32):
    """Truncated-normal (±3σ) fan-in init, std ``1/sqrt(fan_in)``.

    Made on ``gen.device`` from ``gen``; the same seed gives other numbers
    than ``jax.random`` (tests carry JAX's params across instead).  Scaled
    in place: a full-width MoE stack's expert leaf is 20 GB in f32, and a
    second copy of it would not fit on the card beside the others."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return out.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype=torch.float32):
    out = torch.randn(tuple(shape), dtype=torch.float32, device=gen.device,
                      generator=gen)
    return (out * 0.02).to(dtype)


def embed_lookup(table, tokens, dtype):
    """The rows of ``table`` at ``tokens`` in ``dtype``.  JAX casts the
    whole table, then gathers.  Gathering first gives the same numbers
    without casting the ``[vocab, D]`` table every call, which serving
    does; when the table takes a gradient, it is cast whole as in JAX, so
    that its gradient is summed in ``dtype`` there too.

    Under a mesh (a DTensor table) each rank gathers its own tokens' rows
    from the whole table (``base.local_call``), the same gather as on one
    device: the table's gradient is then a partial sum over the mesh dims
    the tokens are split over."""
    from .base import is_dtensor

    if is_dtensor(table):
        return _local_lookup(table, tokens, dtype)
    if table.requires_grad and torch.is_grad_enabled():
        return table.to(dtype)[tokens]
    return table[tokens].to(dtype)


def _local_lookup(table, tokens, dtype):
    from torch.distributed.tensor import Partial, Replicate, Shard

    from .base import local_call

    rows = [p if isinstance(p, Shard) else Replicate()
            for p in tokens.placements]
    whole = [Replicate()] * len(rows)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    return local_call(lambda t, i: embed_lookup(t, i, dtype), (table, tokens),
                      (whole, rows), (grad, rows), rows)


# ---------------------------------------------------------------------------
# norms (computed in f32, cast back to the input dtype)
# ---------------------------------------------------------------------------
def rmsnorm(x, weight, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def layernorm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * weight.float() + bias.float()
    return out.to(dtype)


def norm_params(cfg, device=None):
    p = {"scale": torch.ones((cfg.d_model,), dtype=torch.float32, device=device)}
    if cfg.norm_type != "rmsnorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=device)
    return p


def norm_axes(cfg):
    from . import base as B

    if cfg.norm_type == "rmsnorm":
        return {"scale": (B.D_MODEL,)}
    return {"scale": (B.D_MODEL,), "bias": (B.D_MODEL,)}


def apply_norm(cfg, p, x):
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary: half-split (not interleaved), computed in f32
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, dh]; positions: [..., S] absolute positions."""
    from .base import replicate_like

    dh = x.shape[-1]
    # positions laid out on a mesh (a dryrun's decode step) meet the
    # frequencies as a replicated constant
    freqs = replicate_like(rope_freqs(dh, theta, x.device), positions)
    angles = positions[..., None].float() * freqs            # [..., S, dh/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, dh/2]
    sin = torch.sin(angles)[..., None, :]
    # under a mesh (a DTensor ``x``) the tables are replicated constants
    cos, sin = replicate_like(cos, x), replicate_like(sin, x)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# losses (f32)
# ---------------------------------------------------------------------------
def _masked_mean(nll, mask):
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def sharded_cross_entropy(logits, labels, mask=None):
    """Mean token NLL in f32. logits [B,S,V], labels [B,S], mask [B,S].

    JAX takes the gold logit with a one-hot einsum, which stays a partial sum
    over a vocab-sharded logits tensor under SPMD, and XLA reduces the
    log-sum-exp over the shards.  So does the port where the vocab dim is
    actually sharded (a DTensor split over a mesh dim of
    size > 1): the one-hot is the labels compared with a vocab index
    sharded like the logits, and its sum over the vocab a partial sum per
    rank.  Elsewhere that one-hot would be an f32 ``[B, S, V]`` tensor of
    the whole vocab (5.0 GB for Qwen at batch 8 × 1024); for finite logits
    a ``gather`` picks out exactly the same f32 value (the one-hot sum adds
    zeros to it), so it is used there.
    """
    if not _vocab_sharded(logits):
        return softmax_cross_entropy(logits, labels, mask)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    lf = logits.float()
    # logsumexp as max + log-sum-exp of the shifted logits: DTensor reduces
    # the max and the sum over the vocab shards as partials (one small
    # all-reduce each), where ``torch.logsumexp`` would gather the whole
    # vocab onto every rank
    m = lf.detach().amax(dim=-1)
    logz = m + torch.log(torch.exp(lf - m[..., None]).sum(dim=-1))
    vocab = [Shard(0) if isinstance(p, Shard) and p.dim % 3 == 2
             else Replicate() for p in logits.placements]
    index = distribute_tensor(torch.arange(logits.shape[-1], device=lf.device),
                              logits.device_mesh, vocab, src_data_rank=None)
    onehot = (labels.long()[..., None] == index).float()
    gold = torch.einsum("bsv,bsv->bs", lf, onehot)
    return _masked_mean(logz - gold, mask)


def _vocab_sharded(logits) -> bool:
    """Is ``logits`` a DTensor whose last dim is split over a mesh dim of
    size > 1?"""
    from torch.distributed.tensor import Shard

    from .base import is_dtensor

    return is_dtensor(logits) and any(
        isinstance(p, Shard) and p.dim % logits.ndim == logits.ndim - 1
        and size > 1
        for p, size in zip(logits.placements, logits.device_mesh.shape))


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean token NLL in f32. logits [B,S,V], labels [B,S], mask [B,S]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)
