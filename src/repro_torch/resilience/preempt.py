"""Graceful preemption: SIGTERM/SIGINT -> one final checkpoint -> exit 75
(port of ``repro.resilience.preempt``, a copy).

Cluster schedulers send a soft kill (SIGTERM) and a grace window before
the SIGKILL; resume from the last committed checkpoint survives the hard
kill, and this module makes the soft path *cheap*: the handler only
flips a flag, the gym notices at the next step boundary, saves one
synchronous checkpoint, and the run exits with a distinct resumable
status (``result.json`` ``status: preempted``; CLI exit code
:data:`PREEMPTED_EXIT_CODE` = 75, BSD's EX_TEMPFAIL).  ``resume: auto``
then continues step-for-step.

The guard chains to any previously-installed handler (so an outer
framework's SIGINT behavior survives) and degrades to a no-op flag
holder off the main thread (CPython only installs handlers there) —
fault injection's simulated SIGTERM calls :meth:`PreemptionGuard.request`
directly, same code path, no process machinery.
"""
from __future__ import annotations

import signal
import threading
from typing import Any, Dict, List, Optional, Tuple

#: Distinct exit status for "preempted but resumable" — EX_TEMPFAIL.
PREEMPTED_EXIT_CODE = 75

DEFAULT_SIGNALS: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)


class PreemptionGuard:
    """Latches a preemption request; the training loop polls ``requested``
    at step boundaries.

    Use as a context manager (``with guard:``) or via
    :meth:`install`/:meth:`uninstall`.  :meth:`request` sets the flag
    programmatically — the deterministic-fault path.
    """

    def __init__(self, signals: Tuple[int, ...] = DEFAULT_SIGNALS):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._previous: List[Tuple[int, Any]] = []
        self._installed = False
        self.received: Optional[int] = None   # signum, when OS-delivered

    # -- the flag -----------------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, signum: Optional[int] = None) -> None:
        """Flag a preemption (the handler body; also the injection path)."""
        if signum is not None:
            self.received = int(signum)
        self._event.set()

    def clear(self) -> None:
        self._event.clear()
        self.received = None

    # -- signal wiring -------------------------------------------------------
    def _handler(self, signum, frame):
        self.request(signum)
        # chain: an outer handler (e.g. a launcher's own cleanup) still runs
        for sig, prev in self._previous:
            if sig == signum and callable(prev):
                prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            # handlers only install on the main thread; stay a flag holder
            # (request() still works — injection and cross-thread signaling)
            self._installed = True
            return self
        for sig in self.signals:
            try:
                self._previous.append((sig, signal.signal(sig, self._handler)))
            except (ValueError, OSError):
                pass  # unsupported signal on this platform
        self._installed = True
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous:
            try:
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        self._previous = []
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    def event(self, step: int) -> Dict[str, Any]:
        """The event-log record for a preemption honored at ``step``."""
        return {"kind": "preempt", "step": int(step),
                "signal": self.received, "resumable": True}
