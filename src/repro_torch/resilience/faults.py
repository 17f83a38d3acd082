"""Deterministic fault injection: scheduled failures for testing recovery
(port of ``repro.resilience.faults``: the schedule is a copy, the
``nan_params`` effect works on torch tensors).

A :class:`FaultInjector` holds :class:`FaultSpec` rows — *what* to break
(``kind``), *when* (``at``: a train step for step-indexed kinds, a 0-based
call index for call-indexed kinds), and *how often* (``times``, default
once; 0 = every match).  The subsystems consult it at their injection
points and the injector records every firing, so a chaos test can assert
both that the fault fired and that recovery followed:

===============  ===========  ================================================
kind             indexed by   effect at the injection point
===============  ===========  ================================================
``nan_loss``     train step   the flushed loss for step ``at`` becomes NaN
                              (metrics-only corruption; state stays clean)
``nan_params``   train step   float param leaves are multiplied by NaN in
                              place, on their device, *before* step ``at``
                              (real state corruption — checkpoints after
                              ``at`` are poisoned too)
``ckpt_io``      write call   ``OSError`` inside the checkpoint writer's IO
``preempt``      train step   simulated SIGTERM at the step-``at`` boundary
``serve_stall``  engine tick  the fused tick sleeps ``seconds`` (trips the
                              serve watchdog)
===============  ===========  ================================================

Because specs default to firing once, a rollback's replay runs clean —
which is exactly what the curve-equality chaos tests need.  Registered as
the ``fault_injector`` registry component (variant ``schedule``) so a run
document can declare its chaos in YAML.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence

KNOWN_FAULTS = ("nan_loss", "nan_params", "ckpt_io", "preempt", "serve_stall")

#: kinds matched by an internal per-kind call counter, not a train step
CALL_INDEXED = ("ckpt_io", "serve_stall")


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    ``at``: the step (step-indexed kinds) or 0-based call index
    (call-indexed kinds) of the FIRST firing; -1 = any.  ``times``: how
    many matching opportunities fire (consecutive from the first match;
    0 = every one).  ``seconds``: stall duration for ``serve_stall``.
    """

    kind: str
    at: int = -1
    times: int = 1
    seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in KNOWN_FAULTS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {sorted(KNOWN_FAULTS)}")
        if self.times < 0:
            raise ValueError(f"fault times must be >= 0, got {self.times}")
        if self.seconds < 0:
            raise ValueError(f"fault seconds must be >= 0, "
                             f"got {self.seconds}")
        self._fired = 0

    def _matches(self, index: int) -> bool:
        if self.times and self._fired >= self.times:
            return False
        if self.at < 0:
            return True
        # consecutive firings from the first match: at, at+1, ... (call-
        # indexed faults hit every retry attempt while armed, which is how
        # one spec makes N attempts fail)
        return self.at <= index < self.at + (self.times or (1 << 30))


class FaultInjector:
    """Consults specs at injection points; records every firing."""

    def __init__(self, faults: Sequence[Any] = ()):
        self.specs: List[FaultSpec] = [
            f if isinstance(f, FaultSpec) else FaultSpec(**dict(f))
            for f in (faults or ())
        ]
        self.events: List[Dict[str, Any]] = []
        self._counters: Dict[str, int] = {}
        # the checkpoint writer's thread fires ckpt_io while the gym's
        # thread fires the step-indexed kinds
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, faults: Any = ()) -> "FaultInjector":
        """YAML grammar: a list of ``{kind, at, times, seconds}`` rows."""
        if faults is None:
            faults = ()
        if isinstance(faults, dict):
            faults = [faults]
        return cls(faults)

    def fire(self, kind: str,
             index: Optional[int] = None) -> Optional[FaultSpec]:
        """Should fault ``kind`` fire now?  ``index`` is the train step for
        step-indexed kinds; call-indexed kinds pass None and an internal
        per-kind counter advances on every query.  Returns the matched
        spec (recording the event) or None."""
        with self._lock:
            if index is None:
                index = self._counters.get(kind, 0)
                self._counters[kind] = index + 1
            for spec in self.specs:
                if spec.kind == kind and spec._matches(index):
                    spec._fired += 1
                    self.events.append({"kind": "fault", "fault": kind,
                                        "index": int(index),
                                        "firing": spec._fired})
                    return spec
            return None

    def pending(self, kind: Optional[str] = None) -> int:
        """How many firings remain armed (times=0 specs count as 1)."""
        n = 0
        for spec in self.specs:
            if kind is not None and spec.kind != kind:
                continue
            n += max((spec.times or spec._fired + 1) - spec._fired, 0)
        return n

    # -- the nan_params effect (shared by the gym and the tests) -----------
    @staticmethod
    def corrupt_params(state: Dict[str, Any]) -> Dict[str, Any]:
        """Multiply every float param leaf by NaN — the injected analogue
        of a blown-up gradient step.  JAX corrupts new arrays on the host;
        the port's step updates its state in place, so the leaves are
        corrupted in place on their own device, on the current stream:
        copies a checkpoint already queued there (``AsyncCheckpointer``'s
        non-blocking snapshot) read the clean values first.  Returns a new
        state dict over the same tensors."""
        import torch

        from ..tree import tree_leaves

        with torch.no_grad():
            for leaf in tree_leaves(state["params"]):
                if leaf.is_floating_point():
                    leaf.mul_(float("nan"))
        return dict(state)
