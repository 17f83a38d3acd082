"""The GPipe schedule's arithmetic (port of the part of
``repro.sharding.pipeline`` that :func:`repro_torch.sharding.plans.pipeline_info`
reports).

Layers stacked ``[L, ...]`` split into S stages run ``S + M - 1`` ticks for
M microbatches, so the schedule idles ``(S-1)/(S+M-1)`` of the time.  The
schedule itself (JAX's ``gpipe_apply``, ``pipeline_apply`` and
``microbatch`` under a pipe axis) comes with ROADMAP A8b: a plan with
``pp > 1`` on a mesh that carries its pipe axis is refused by
``plans.mesh_context``.
"""
from __future__ import annotations


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule; 0 for the S=1 degenerate case."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_stages == 1:
        return 0.0
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    return (n_stages - 1) / (n_stages + n_micro - 1)


def effective_n_micro(n_micro: int, n_stages: int, global_batch: int = 0) -> int:
    """The microbatch count the schedule actually uses: ``n_micro`` (or the
    ``2 * n_stages`` GPipe default) reduced to the largest divisor of the
    global batch so every microbatch is equal-sized."""
    m = n_micro or 2 * n_stages
    if global_batch:
        m = min(m, global_batch)
        while global_batch % m:
            m -= 1
    return max(m, 1)
