"""Training anomaly detection over the gym's flushed metrics windows (port
of ``repro.resilience.sentinel``, a copy: the event dicts are JAX's key for
key).

The gym's metrics are fetched one ``log_every`` window late (the fetch
must never block dispatch), so the sentinel sees step ``k``'s loss around
step ``k + log_every`` — *after* a checkpoint of the corrupted state may
already have committed.  That latency is why the gym's rollback restores
the newest checkpoint strictly *before* the anomaly step, not merely the
latest (see ``Gym.run``).

Two trips:

- **non-finite**: the watched metric is NaN/Inf — always fatal training
  state (a NaN loss means NaN grads poisoned the params one step later).
- **spike**: z-score of the new value against a rolling window of recent
  history exceeds ``spike_zscore`` (0 disables).  Guarded by
  ``min_history`` so the noisy first steps never trip, and by a degenerate
  -std floor so a flat curve does not divide by ~0.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, Optional


class AnomalyError(RuntimeError):
    """Unrecoverable training anomaly (rollback budget exhausted, or no
    checkpoint to roll back to).  Carries the triggering event."""

    def __init__(self, msg: str, event: Optional[Dict[str, Any]] = None):
        super().__init__(msg)
        self.event = event or {}


@dataclasses.dataclass
class StepSentinel:
    """Checks each flushed metric point; remembers recent clean history.

    ``check`` returns an *event dict* (step/reason/value/...) when the
    point is anomalous and ``None`` when it is clean — clean points are
    absorbed into the rolling spike window.  After a rollback the gym
    calls :meth:`reset` so replayed history is not double-counted.
    """

    metric: str = "loss"
    nan: bool = True                  # trip on NaN/Inf
    spike_zscore: float = 0.0         # 0 disables the spike detector
    window: int = 32                  # rolling stats window (clean points)
    min_history: int = 8              # spike needs this many points first

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")
        if self.min_history < 2:
            raise ValueError(f"min_history must be >= 2, "
                             f"got {self.min_history}")
        if self.spike_zscore < 0:
            raise ValueError(f"spike_zscore must be >= 0, "
                             f"got {self.spike_zscore}")
        self._recent: deque = deque(maxlen=self.window)

    def reset(self) -> None:
        """Forget rolling history (after a rollback: the replayed steps
        re-observe their values)."""
        self._recent.clear()

    def check(self, step: int,
              metrics: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Inspect one flushed metric point.  Returns the anomaly event or
        None; clean values are absorbed into the spike window."""
        value = metrics.get(self.metric)
        if value is None:
            return None
        value = float(value)
        if self.nan and not math.isfinite(value):
            return {"kind": "anomaly", "reason": "non_finite",
                    "metric": self.metric, "step": int(step), "value": value}
        if self.spike_zscore > 0 and len(self._recent) >= self.min_history:
            mean = sum(self._recent) / len(self._recent)
            var = sum((v - mean) ** 2 for v in self._recent) / len(self._recent)
            # floor the std at 1% of |mean|: a perfectly flat window must
            # not turn epsilon wiggles into infinite z-scores
            std = max(math.sqrt(var), abs(mean) * 1e-2, 1e-8)
            z = (value - mean) / std
            if z > self.spike_zscore:
                return {"kind": "anomaly", "reason": "spike",
                        "metric": self.metric, "step": int(step),
                        "value": value, "zscore": round(z, 3),
                        "window_mean": round(mean, 6)}
        self._recent.append(value)
        return None
