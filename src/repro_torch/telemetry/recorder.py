"""The telemetry recorder: the one writer every pillar emits through.

A :class:`TelemetryRecorder` stamps the envelope (run name, kind,
fingerprint, monotonic ``t_s``, sequence number) onto every row and
hands it to the configured sink.  Three emission surfaces:

- ``metric(step, values)`` — a windowed scalar observation.
- ``event(name, step=..., **attrs)`` — a point occurrence.
- ``span(name)`` (context manager) / ``span_row(name, t0, t1)`` —
  timed intervals.  Span ids come from a per-recorder counter assigned
  in *open* order and ``parent_id``/``depth`` from the recorder's open
  stack, so two identical executions produce the identical span tree
  (names, ids, parents, depths, seq order) even though wall times vary.

Emission never touches the computation being measured: the recorder
reads already-computed values and timestamps only, which is what makes
telemetry-on vs. telemetry-off runs bitwise identical.

The port's own copy of ``repro.telemetry.recorder`` (plain Python): the
rows it writes follow the same schema.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from .events import SCHEMA_VERSION
from .sinks import ListSink, TelemetrySink


def _clean_attrs(attrs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    out = {k: v for k, v in attrs.items() if v is not None}
    return out or None


class TelemetryRecorder:
    def __init__(self, sink: Optional[TelemetrySink] = None, *,
                 run: str = "", kind: str = "", fingerprint: str = "",
                 spans: bool = True) -> None:
        self.sink = sink if sink is not None else ListSink()
        self.run = run
        self.kind = kind
        self.fingerprint = fingerprint
        self.spans = bool(spans)
        self.t0 = time.perf_counter()
        self.counts: Dict[str, int] = {"metric": 0, "span": 0, "event": 0}
        self._seq = 0
        self._next_span_id = 0
        # (span_id, name, t_open) for spans opened via the context manager
        self._stack: List[Tuple[int, str, float]] = []
        self._depths: Dict[int, int] = {}  # span_id -> ancestor count
        self._closed = False

    # -- envelope -----------------------------------------------------------
    def now(self) -> float:
        """Seconds since the recorder was created (full precision)."""
        return time.perf_counter() - self.t0

    def _emit(self, rtype: str, payload: Dict[str, Any],
              step: Optional[int], t_s: Optional[float] = None) -> None:
        row: Dict[str, Any] = {
            "v": SCHEMA_VERSION,
            "type": rtype,
            "seq": self._seq,
            "run": self.run,
            "kind": self.kind,
            "fingerprint": self.fingerprint,
            "t_s": self.now() if t_s is None else t_s,
        }
        if step is not None:
            row["step"] = int(step)
        row.update(payload)
        self._seq += 1
        self.counts[rtype] += 1
        self.sink.write(row)

    # -- metric rows --------------------------------------------------------
    def metric(self, step: Optional[int], values: Dict[str, Any],
               **attrs: Any) -> None:
        data = {}
        for k, v in values.items():
            if isinstance(v, bool):
                data[k] = int(v)
            elif isinstance(v, (int, str)) or v is None:
                data[k] = v
            else:
                data[k] = float(v)
        payload: Dict[str, Any] = {"data": data}
        a = _clean_attrs(attrs)
        if a:
            payload["attrs"] = a
        self._emit("metric", payload, step)

    # -- event rows ---------------------------------------------------------
    def event(self, name: str, step: Optional[int] = None,
              **attrs: Any) -> None:
        payload: Dict[str, Any] = {"name": name}
        a = _clean_attrs(attrs)
        if a:
            payload["attrs"] = a
        self._emit("event", payload, step)

    # -- span rows ----------------------------------------------------------
    def span_row(self, name: str, t0: float, t1: float, *,
                 step: Optional[int] = None, parent: Optional[int] = None,
                 **attrs: Any) -> int:
        """Record an already-measured interval.  ``t0``/``t1`` are
        ``time.perf_counter()`` readings; stored relative to the recorder
        epoch.  Returns the span id (usable as ``parent`` of children)."""
        sid = self._next_span_id
        self._next_span_id += 1
        if parent is None and self._stack:
            parent = self._stack[-1][0]
        depth = 0 if parent is None else self._depths.get(parent, 0) + 1
        self._depths[sid] = depth
        payload: Dict[str, Any] = {
            "name": name,
            "span_id": sid,
            "parent_id": parent,
            "depth": depth,
            "t0_s": t0 - self.t0,
            "t1_s": t1 - self.t0,
            "dur_s": t1 - t0,
        }
        a = _clean_attrs(attrs)
        if a:
            payload["attrs"] = a
        self._emit("span", payload, step, t_s=t1 - self.t0)
        return sid

    @contextmanager
    def span(self, name: str, step: Optional[int] = None, **attrs: Any):
        """Open a nested span; the row is emitted when the block exits
        (children close first; ids still reflect open order)."""
        sid = self._next_span_id
        self._next_span_id += 1
        parent = self._stack[-1][0] if self._stack else None
        depth = 0 if parent is None else self._depths.get(parent, 0) + 1
        self._depths[sid] = depth
        t_open = time.perf_counter()
        self._stack.append((sid, name, t_open))
        try:
            yield sid
        finally:
            self._stack.pop()
            t_close = time.perf_counter()
            payload: Dict[str, Any] = {
                "name": name,
                "span_id": sid,
                "parent_id": parent,
                "depth": depth,
                "t0_s": t_open - self.t0,
                "t1_s": t_close - self.t0,
                "dur_s": t_close - t_open,
            }
            a = _clean_attrs(attrs)
            if a:
                payload["attrs"] = a
            self._emit("span", payload, step, t_s=t_close - self.t0)

    # -- lifecycle ----------------------------------------------------------
    @property
    def rows(self) -> List[Dict[str, Any]]:
        """In-memory rows when the sink is a ListSink (tests)."""
        return getattr(self.sink, "rows", [])

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "rows": self._seq,
            "metric_rows": self.counts["metric"],
            "span_rows": self.counts["span"],
            "event_rows": self.counts["event"],
        }
        path = getattr(self.sink, "path", None)
        if path:
            out["file"] = path
        return out

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.sink.close()
