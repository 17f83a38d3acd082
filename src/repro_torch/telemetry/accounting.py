"""Goodput accounting (port of the part of ``repro.telemetry.accounting``
the training slice reports).

``goodput`` is productive steps ÷ dispatched steps: rollback replays and
steps discarded by preemption dispatch work that never advances the
optimizer.  A clean run scores exactly 1.0.  ``mfu`` and its H100 peak come
with the profiler (ROADMAP A5).
"""
from __future__ import annotations


def goodput(productive_steps: int, dispatched_steps: int) -> float:
    """Productive ÷ dispatched step ratio in [0, 1]; 1.0 when idle."""
    if dispatched_steps <= 0:
        return 1.0
    return max(0.0, min(1.0, productive_steps / dispatched_steps))

