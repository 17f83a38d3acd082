"""MFU / goodput accounting (port of ``repro.telemetry.accounting``).

Definitions, as in JAX:

``model FLOPs/step``
    The classic 6·N_active·D training estimate (2·N_active·D per token
    for inference), with N_active discounting inactive routed experts
    for MoE configs.  N is counted on the ``meta`` device (the port's
    ``jax.eval_shape``): no parameter memory is allocated, and a tied
    embedding is one leaf, counted once.
``mfu``
    model FLOPs/step ÷ (measured step seconds × peak FLOP/s × devices).
    The peak is the port's card, :data:`repro_torch.device.PEAK_FLOPS_BF16`
    (H100 SXM5 dense bf16); on a host without a card the value is a
    *modeled* utilization against it — tiny but nonzero, and comparable
    across commits because numerator and denominator are both
    deterministic.
``goodput``
    productive steps ÷ dispatched steps.  Rollback replays, anomaly
    skips, and steps discarded by preemption all dispatch work that
    never advances the optimizer, so they discount goodput; a clean run
    scores exactly 1.0.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

from ..device import PEAK_FLOPS_BF16, MetaGenerator
from ..tree import tree_leaves


def count_param_leaves(params) -> int:
    """Total element count over a tree of tensors (``meta`` ones too)."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(params))


def active_params(cfg, n_total: int) -> int:
    """Discount inactive routed experts: only ``top_k`` of ``n_routed``
    expert MLPs run per token in a MoE layer."""
    if not getattr(cfg, "moe", None):
        return n_total
    per_layer_routed = 3 * cfg.d_model * cfg.moe.d_expert * cfg.moe.n_routed
    n_moe_layers = cfg.n_layers - cfg.moe.n_dense_layers
    active_frac = cfg.moe.top_k / cfg.moe.n_routed
    return n_total - int(per_layer_routed * n_moe_layers * (1 - active_frac))


def _abstract_params(model):
    return model.init(MetaGenerator())


def model_flops(cfg, shape) -> Tuple[float, int, int]:
    """6·N_active·D (training) or 2·N_active·D (per-token inference) for
    one global step of ``shape``.  Returns (flops, n_total, n_active)."""
    from ..models import build_model

    n_total = count_param_leaves(_abstract_params(build_model(cfg)))
    n_active = active_params(cfg, n_total)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens, n_total, n_active
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens, n_total, n_active
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens, n_total, n_active


def flops_per_train_step(model, loader,
                         grad_accum: int = 1) -> Optional[float]:
    """Model FLOPs for one optimizer step of a live gym: 6·N_active ×
    (global_batch × seq_len).  Returns None when the loader does not
    expose its token geometry (custom loaders) or the model has no
    ArchConfig.  ``grad_accum`` microbatching does not change the token
    count per optimizer step, so it does not appear here."""
    cfg = getattr(model, "cfg", None)
    gb = getattr(loader, "global_batch", None)
    seq = getattr(getattr(loader, "dataset", None), "seq_len", None)
    if cfg is None or not gb or not seq:
        return None
    try:
        params = _abstract_params(model)
    except Exception:
        return None
    n_active = active_params(cfg, count_param_leaves(params))
    return 6.0 * n_active * float(gb) * float(seq)


def mfu(flops_per_step: float, step_s: float, n_devices: int = 1,
        peak_flops: float = PEAK_FLOPS_BF16) -> float:
    """Model-FLOPs utilization of ``n_devices`` cards."""
    if step_s <= 0 or n_devices <= 0 or peak_flops <= 0:
        return 0.0
    return flops_per_step / (step_s * peak_flops * n_devices)


def goodput(productive_steps: int, dispatched_steps: int) -> float:
    """Productive ÷ dispatched step ratio in [0, 1]; 1.0 when idle."""
    if dispatched_steps <= 0:
        return 1.0
    return max(0.0, min(1.0, productive_steps / dispatched_steps))


def tokens_per_s(global_batch: Any, seq_len: Any,
                 step_s: float) -> Optional[float]:
    if not global_batch or not seq_len or step_s <= 0:
        return None
    return float(global_batch) * float(seq_len) / step_s
