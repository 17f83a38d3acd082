"""Unified telemetry of the port (``repro.telemetry`` counterpart): typed
metric/span/event rows through one recorder into one sink per run, the
phases of a train step on the host and the card (:mod:`.phases`), the
``torch.profiler`` window (``telemetry.profile``, :class:`ProfilerHook`)
and the ``mfu``/``goodput`` accounting (:mod:`.accounting`)."""
from __future__ import annotations

import os
from typing import Any, Optional

from .events import SCHEMA_VERSION, SchemaError, validate_row, validate_rows
from .profiler import ProfilerHook
from .recorder import TelemetryRecorder
from .sinks import (CsvSink, JsonlSink, ListSink, MultiSink, StdoutSink,
                    TelemetrySink, read_csv, read_jsonl)

__all__ = [
    "SCHEMA_VERSION", "SchemaError", "validate_row", "validate_rows",
    "TelemetryRecorder", "TelemetrySink", "JsonlSink", "CsvSink",
    "StdoutSink", "MultiSink", "ListSink", "read_jsonl",
    "read_csv", "build_recorder", "build_sink", "ProfilerHook",
]

_FILE_SINKS = {"jsonl": (JsonlSink, "telemetry.jsonl"),
               "csv": (CsvSink, "telemetry.csv")}


def build_sink(variant: str = "jsonl", *, path: str = "", prefix: str = "",
               sinks: Any = (), output_dir: str = "",
               write: bool = True) -> TelemetrySink:
    """A sink from its declarative description.  ``write=False``, or a file
    sink with neither a ``path`` nor an ``output_dir``, gives an in-memory
    :class:`ListSink`: rows are recorded and summarized, not persisted."""
    if not write:
        return ListSink()
    if variant in _FILE_SINKS:
        cls, default_name = _FILE_SINKS[variant]
        p = path or (os.path.join(output_dir, default_name)
                     if output_dir else "")
        return cls(p) if p else ListSink()
    if variant == "stdout":
        return StdoutSink(prefix)
    if variant == "memory":
        return ListSink()
    if variant == "multi":
        subs = []
        for sub in (sinks or ()):
            if isinstance(sub, str):
                sub = {"sink": sub}
            if not isinstance(sub, dict):
                raise ValueError(f"telemetry multi-sink entries must be "
                                 f"mappings or names, got {sub!r}")
            subs.append(build_sink(sub.get("sink", "jsonl"),
                                   path=sub.get("path", ""),
                                   prefix=sub.get("prefix", ""),
                                   sinks=sub.get("sinks", ()),
                                   output_dir=output_dir, write=write))
        if not subs:
            raise ValueError("telemetry sink 'multi' needs a non-empty "
                             "'sinks' list")
        return MultiSink(subs)
    raise ValueError(f"unknown telemetry sink {variant!r} "
                     f"(known: jsonl, csv, stdout, multi, memory)")


def build_recorder(settings: Any = None, *, output_dir: str = "",
                   run: str = "", kind: str = "", fingerprint: str = "",
                   write: bool = True,
                   log=None) -> Optional[TelemetryRecorder]:
    """The run's recorder from a ``TelemetrySettings``-shaped object (None
    for the defaults); None when telemetry is disabled."""
    if settings is not None and not getattr(settings, "enabled", True):
        return None
    variant = (getattr(settings, "sink", "") or "jsonl") if settings else \
        "jsonl"
    sink = build_sink(
        variant,
        path=getattr(settings, "path", "") if settings else "",
        prefix=getattr(settings, "prefix", "") if settings else "",
        sinks=getattr(settings, "sinks", ()) if settings else (),
        output_dir=output_dir, write=write,
    )
    rec = TelemetryRecorder(
        sink, run=run, kind=kind, fingerprint=fingerprint,
        spans=bool(getattr(settings, "spans", True)) if settings else True,
    )
    if log and getattr(sink, "path", None):
        log(f"[telemetry] sink/{variant} -> {sink.path}")
    return rec
