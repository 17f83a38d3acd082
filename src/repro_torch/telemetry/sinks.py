"""Telemetry sinks: where validated event rows go.

A sink is anything with ``write(row)`` and ``close()``.  Sinks are
registry components (``sink/jsonl``, ``sink/csv``, ``sink/stdout``,
``sink/multi``, ``sink/memory``) so a run document picks one
declaratively.

The CSV sink flattens every row into one fixed-width table — nested
``data``/``attrs`` payloads are JSON-encoded in their column, so a row
round-trips losslessly (see ``read_csv``).

The port's own copy of ``repro.telemetry.sinks`` (plain Python): the
rows it writes follow the same schema.
"""
from __future__ import annotations

import csv
import io
import json
import os
import sys
from typing import Any, Dict, List, Optional

from .events import validate_row

# fixed CSV column order; payload mappings are JSON-encoded in-cell
CSV_COLUMNS = ("v", "type", "seq", "run", "kind", "fingerprint", "step",
               "t_s", "name", "span_id", "parent_id", "depth", "t0_s",
               "t1_s", "dur_s", "data", "attrs")
_JSON_COLUMNS = ("data", "attrs")
_INT_COLUMNS = ("v", "seq", "step", "span_id", "parent_id", "depth")
_FLOAT_COLUMNS = ("t_s", "t0_s", "t1_s", "dur_s")


class TelemetrySink:
    """Base sink: receives schema-valid rows; subclasses persist them."""

    def write(self, row: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class ListSink(TelemetrySink):
    """In-memory sink — the default when a run has no output directory."""

    def __init__(self) -> None:
        self.rows: List[Dict[str, Any]] = []

    def write(self, row: Dict[str, Any]) -> None:
        self.rows.append(row)


class JsonlSink(TelemetrySink):
    """One JSON object per line.  The file handle stays open across writes
    (a run emits thousands of rows); ``close()`` flushes and releases it."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: Optional[io.TextIOWrapper] = open(self.path, "w")

    def write(self, row: Dict[str, Any]) -> None:
        if self._f is None:
            raise RuntimeError(f"JsonlSink({self.path}) is closed")
        self._f.write(json.dumps(row, default=float) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


class CsvSink(TelemetrySink):
    """Fixed-schema CSV table; ``data``/``attrs`` cells hold JSON."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: Optional[io.TextIOWrapper] = open(self.path, "w", newline="")
        self._w = csv.writer(self._f)
        self._w.writerow(CSV_COLUMNS)

    def write(self, row: Dict[str, Any]) -> None:
        if self._f is None:
            raise RuntimeError(f"CsvSink({self.path}) is closed")
        out = []
        for col in CSV_COLUMNS:
            v = row.get(col)
            if v is None:
                out.append("")
            elif col in _JSON_COLUMNS:
                out.append(json.dumps(v, default=float))
            else:
                out.append(v)
        self._w.writerow(out)

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


class StdoutSink(TelemetrySink):
    """Human-facing line stream (JSONL to stdout, optional prefix)."""

    def __init__(self, prefix: str = "", stream=None) -> None:
        self.prefix = prefix
        self.stream = stream if stream is not None else sys.stdout

    def write(self, row: Dict[str, Any]) -> None:
        print(self.prefix + json.dumps(row, default=float),
              file=self.stream, flush=True)


class MultiSink(TelemetrySink):
    """Fan one row out to several sinks (e.g. jsonl on disk + stdout)."""

    def __init__(self, sinks) -> None:
        self.sinks = list(sinks)

    def write(self, row: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.write(row)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


# ---------------------------------------------------------------------------
# readers — used by tests/CI to round-trip and validate what sinks wrote

def read_jsonl(path: str, validate: bool = True) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            rows.append(validate_row(row) if validate else row)
    return rows


def read_csv(path: str, validate: bool = True) -> List[Dict[str, Any]]:
    rows = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        for rec in reader:
            row: Dict[str, Any] = {}
            for col, raw in rec.items():
                if raw == "" or raw is None:
                    continue
                if col in _JSON_COLUMNS:
                    row[col] = json.loads(raw)
                elif col in _INT_COLUMNS:
                    row[col] = int(raw)
                elif col in _FLOAT_COLUMNS:
                    row[col] = float(raw)
                else:
                    row[col] = raw
            # parent_id of a root span serializes as "" — restore the null
            if row.get("type") == "span" and "parent_id" not in row:
                row["parent_id"] = None
            rows.append(validate_row(row) if validate else row)
    return rows
