"""The phases of a train step, marked on the host and timed on the device.

``make_train_step`` opens ``step/forward``, ``step/backward``,
``step/exchange`` (under a mesh) and ``step/optimizer`` through
:func:`mark`; the SSD scan's recompute backward opens
``step/ssd_backward`` inside the open backward (``nested=True``).  The
marks find the running gym's :class:`StepPhases` through one module-level
"current" object, which ``Gym.run`` sets for its length and clears at its
end.  With none set, a mark costs one ``None`` check: no event, no
``torch.profiler.record_function`` range, no row.

With a recorder, each mark

- opens a ``record_function`` range of its name, so a ``torch.profiler``
  trace (``telemetry.profile``) carries it;
- writes a host span row of its name: a mark on the gym loop's thread at
  once, nested by the recorder's stack under ``gym/step``; a nested mark
  made on another thread (autograd's device thread runs a CUDA backward)
  is queued and written by :meth:`StepPhases.flush`, parented by the phase
  it ran in;
- on a card, records a timing event at its start and at its end on the
  current stream.  :meth:`StepPhases.flush` turns the completed pairs into
  ``device/<phase>`` rows (``device/forward`` parented by ``step/forward``,
  ``device/ssd_backward`` by its ``device/backward``) on the host clock:
  an anchor event recorded on an idle card as the run starts is the
  anchor's host time, and an event lies ``anchor.elapsed_time(event)``
  after it.  ``flush`` reads only events that have completed, and is
  called where the gym already waits for the card (its metrics copy and
  its final read of the step counter), so the marks add no
  synchronisation.

Rows are written from the gym loop's thread alone.  On the CPU no
``device/*`` row is written: a CPU run reports no device time.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, List, Optional

import torch

#: the running gym's phases; None outside ``Gym.run`` and with spans off
_current: Optional["StepPhases"] = None
_NO_MARK = contextlib.nullcontext()


def set_current(phases: Optional["StepPhases"]) -> None:
    global _current
    _current = phases


def mark(name: str, nested: bool = False):
    """A context manager around one phase of the running train step.  A
    ``nested`` mark, or one made off the gym loop's thread, marks only
    inside an open phase (a kernel's backward, which other callers of
    autograd run too)."""
    phases = _current
    return _NO_MARK if phases is None else phases.mark(name, nested)


def cuda_events(device) -> Optional[Callable[[], Any]]:
    """The factory of timing events on ``device``'s card; None on the
    CPU."""
    if torch.device(device).type != "cuda":
        return None
    return lambda: torch.cuda.Event(enable_timing=True)


class _Phase:
    __slots__ = ("name", "step", "sid", "t0", "t1", "ev0", "ev1", "parts",
                 "listed")

    def __init__(self, name: str, step: Optional[int]) -> None:
        self.name, self.step = name, step
        self.sid: Optional[int] = None        # its host row's span id
        self.t0 = self.t1 = 0.0
        self.ev0 = self.ev1 = None
        self.parts: List["_Phase"] = []       # nested phases, in close order
        self.listed = False                   # host rows of its parts written


class StepPhases:
    """The marks of one ``Gym.run``: host rows through ``recorder``, device
    rows from the events ``event()`` makes (None: host rows alone).  The
    anchor is recorded here, so build this where the card is idle."""

    def __init__(self, recorder, event: Optional[Callable[[], Any]] = None
                 ) -> None:
        self.rec = recorder
        self.event = event
        self.step: Optional[int] = None       # the step the gym is issuing
        self._loop = threading.get_ident()
        self._open: Optional[_Phase] = None   # innermost phase on the loop
        self._done: List[_Phase] = []         # closed outer phases, in order
        self._anchor = None
        if event is not None:
            self._anchor = event()
            self._anchor.record()
            self._anchor_t = time.perf_counter()

    @contextlib.contextmanager
    def mark(self, name: str, nested: bool = False):
        on_loop = threading.get_ident() == self._loop
        parent = self._open
        if parent is None and (nested or not on_loop):
            yield       # outside the step's phases: nothing to mark
            return
        ph = _Phase(name, self.step)
        span = None
        if on_loop:
            span = self.rec.span(name, step=self.step)
            ph.sid = span.__enter__()
            self._open = ph
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        if self.event is not None:
            ph.ev0 = self.event()
            ph.ev0.record()
        ph.t0 = time.perf_counter()
        try:
            yield
        finally:
            ph.t1 = time.perf_counter()
            if self.event is not None:
                ph.ev1 = self.event()
                ph.ev1.record()
            rf.__exit__(None, None, None)
            if on_loop:
                self._open = parent
                span.__exit__(None, None, None)
            if parent is None:
                self._done.append(ph)
            else:
                parent.parts.append(ph)

    def flush(self) -> None:
        """On the loop's thread: the host rows of phases marked on other
        threads, then the device rows of closed phases whose events have
        completed, in order."""
        for ph in self._done:
            if not ph.listed:
                for part in ph.parts:
                    if part.sid is None:
                        part.sid = self.rec.span_row(
                            part.name, part.t0, part.t1, step=part.step,
                            parent=ph.sid)
                ph.listed = True
        if self.event is None:
            self._done.clear()
            return
        n = 0
        for ph in self._done:
            if not all(e.query() for p in (ph, *ph.parts)
                       for e in (p.ev0, p.ev1)):
                break
            sid = self._device_row(ph, ph.sid)
            for part in ph.parts:
                self._device_row(part, sid)
            n += 1
        del self._done[:n]

    def _device_row(self, ph: _Phase, parent: Optional[int]) -> int:
        a, t = self._anchor, self._anchor_t
        return self.rec.span_row(
            "device/" + ph.name.split("/", 1)[-1],
            t + 1e-3 * a.elapsed_time(ph.ev0),
            t + 1e-3 * a.elapsed_time(ph.ev1), step=ph.step, parent=parent)
