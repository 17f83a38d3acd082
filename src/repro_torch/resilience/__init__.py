"""Fault tolerance of the port (``repro.resilience`` counterpart): anomaly
rollback, graceful preemption, retrying IO, and deterministic fault
injection.

- :mod:`.sentinel` — :class:`StepSentinel` watches the gym's flushed
  metrics windows for NaN/Inf loss and loss-spike z-scores; the gym rolls
  back to the last committed checkpoint *before* the anomaly and replays.
- :mod:`.preempt` — :class:`PreemptionGuard` turns SIGTERM/SIGINT into a
  request for one final synchronous checkpoint at the next step boundary
  and a distinct resumable exit (75).
- :mod:`.retry` — :class:`RetryPolicy` / :func:`call_with_retry`: bounded
  exponential backoff with deterministic jitter and exception-class
  filters, applied to the checkpoint writer's IO.
- :mod:`.faults` — :class:`FaultInjector`: a registry component that
  fires configured faults (NaN params, checkpoint-IO OSErrors, simulated
  SIGTERM, serve-tick stalls) at exact step/call indices.

Wired through the run API as a ``resilience:`` block of ``run.train`` and
``faults`` of ``run.serve``.
"""
from .faults import KNOWN_FAULTS, FaultInjector, FaultSpec
from .preempt import PREEMPTED_EXIT_CODE, PreemptionGuard
from .retry import (
    TRANSIENT_EXCEPTIONS,
    RetryError,
    RetryPolicy,
    call_with_retry,
    classify_failure,
)
from .sentinel import AnomalyError, StepSentinel

__all__ = [
    "AnomalyError",
    "FaultInjector",
    "FaultSpec",
    "KNOWN_FAULTS",
    "PREEMPTED_EXIT_CODE",
    "PreemptionGuard",
    "RetryError",
    "RetryPolicy",
    "StepSentinel",
    "TRANSIENT_EXCEPTIONS",
    "call_with_retry",
    "classify_failure",
]
