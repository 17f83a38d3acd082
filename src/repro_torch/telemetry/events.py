"""The telemetry event schema: one typed row format for every pillar.

Every row a sink receives is a flat JSON-able mapping with a common
envelope plus per-type payload.  Three row types cover everything the
framework emits:

``metric``
    Windowed scalar observations — the gym's flushed training metrics,
    eval points, bench windows, sweep trial objectives, serve headline
    numbers.  Payload: ``data`` (name -> float).
``span``
    A named timed interval — per-step phase breakdown in the gym
    (data-wait / step dispatch / metrics flush / ckpt snapshot), per-
    request lifecycle in the serve engine (queued / prefill / decode).
    Payload: ``name``, ``span_id``, ``parent_id``, ``depth``, ``t0_s``,
    ``t1_s``, ``dur_s`` and free-form ``attrs``.  Span ids are assigned
    in *open* order from a per-recorder counter, so the tree structure
    is deterministic even though the emission order is close-order.
``event``
    A point occurrence — rollback, preemption, fault firing, admission,
    retirement, profiler start/stop.  Payload: ``name`` + ``attrs``.

Envelope (every row): ``v`` (schema version), ``type``, ``seq`` (a
monotonic per-recorder counter — the total order), ``run`` (run name),
``kind`` (run kind), ``fingerprint`` (resolved-config fingerprint),
``t_s`` (monotonic seconds since the recorder was created, full
precision), and optional ``step``.

:func:`validate_row` is the contract tests and CI check files against.

The port's own copy of ``repro.telemetry.events`` (plain Python): the
rows it writes follow the same schema.
"""
from __future__ import annotations

from typing import Any, Dict

SCHEMA_VERSION = 1

ROW_TYPES = ("metric", "span", "event")

#: envelope fields present on every row (``step`` is optional)
ENVELOPE_REQUIRED = ("v", "type", "seq", "run", "kind", "t_s")
ENVELOPE_OPTIONAL = ("step", "fingerprint")

#: per-type required payload fields
PAYLOAD_REQUIRED = {
    "metric": ("data",),
    "span": ("name", "span_id", "parent_id", "depth", "t0_s", "t1_s",
             "dur_s"),
    "event": ("name",),
}
PAYLOAD_OPTIONAL = {
    "metric": ("attrs",),
    "span": ("attrs",),
    "event": ("attrs",),
}


class SchemaError(ValueError):
    """A telemetry row violates the event schema."""


def _require_number(row_desc: str, field: str, value: Any) -> None:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise SchemaError(f"{row_desc}: field {field!r} must be a number, "
                          f"got {type(value).__name__}")


def validate_row(row: Any) -> Dict[str, Any]:
    """Validate one telemetry row against the schema; returns the row.

    Raises :class:`SchemaError` with a field-level message on violation —
    the check CI runs over every line of a ``telemetry.jsonl``.
    """
    if not isinstance(row, dict):
        raise SchemaError(f"row must be a mapping, got {type(row).__name__}")
    rtype = row.get("type")
    if rtype not in ROW_TYPES:
        raise SchemaError(f"row type must be one of {ROW_TYPES}, "
                          f"got {rtype!r}")
    desc = f"{rtype} row (seq={row.get('seq')!r})"
    for field in ENVELOPE_REQUIRED:
        if field not in row:
            raise SchemaError(f"{desc}: missing envelope field {field!r}")
    if row["v"] != SCHEMA_VERSION:
        raise SchemaError(f"{desc}: schema version {row['v']!r} != "
                          f"{SCHEMA_VERSION}")
    if not isinstance(row["seq"], int) or isinstance(row["seq"], bool):
        raise SchemaError(f"{desc}: 'seq' must be an int")
    _require_number(desc, "t_s", row["t_s"])
    if "step" in row and row["step"] is not None:
        if not isinstance(row["step"], int) or isinstance(row["step"], bool):
            raise SchemaError(f"{desc}: 'step' must be an int")
    for name in ("run", "kind"):
        if not isinstance(row[name], str):
            raise SchemaError(f"{desc}: {name!r} must be a string")

    allowed = set(ENVELOPE_REQUIRED) | set(ENVELOPE_OPTIONAL) \
        | set(PAYLOAD_REQUIRED[rtype]) | set(PAYLOAD_OPTIONAL[rtype])
    unknown = set(row) - allowed
    if unknown:
        raise SchemaError(f"{desc}: unknown fields {sorted(unknown)}")
    for field in PAYLOAD_REQUIRED[rtype]:
        if field not in row:
            raise SchemaError(f"{desc}: missing {field!r}")

    if rtype == "metric":
        data = row["data"]
        if not isinstance(data, dict) or not data:
            raise SchemaError(f"{desc}: 'data' must be a non-empty mapping")
        for k, v in data.items():
            if not isinstance(k, str):
                raise SchemaError(f"{desc}: metric names must be strings")
            if v is not None and not isinstance(v, (int, float, str)):
                raise SchemaError(f"{desc}: metric {k!r} must be a "
                                  f"number/string/null")
    elif rtype == "span":
        if not isinstance(row["name"], str) or not row["name"]:
            raise SchemaError(f"{desc}: span 'name' must be a non-empty "
                              f"string")
        for field in ("span_id", "depth"):
            if not isinstance(row[field], int) or isinstance(row[field], bool):
                raise SchemaError(f"{desc}: {field!r} must be an int")
        pid = row["parent_id"]
        if pid is not None and (not isinstance(pid, int)
                                or isinstance(pid, bool)):
            raise SchemaError(f"{desc}: 'parent_id' must be an int or null")
        for field in ("t0_s", "t1_s", "dur_s"):
            _require_number(desc, field, row[field])
        if row["depth"] < 0:
            raise SchemaError(f"{desc}: 'depth' must be >= 0")
    else:  # event
        if not isinstance(row["name"], str) or not row["name"]:
            raise SchemaError(f"{desc}: event 'name' must be a non-empty "
                              f"string")
    attrs = row.get("attrs")
    if attrs is not None and not isinstance(attrs, dict):
        raise SchemaError(f"{desc}: 'attrs' must be a mapping")
    return row


def validate_rows(rows) -> int:
    """Validate an iterable of rows; returns how many were checked."""
    n = 0
    for row in rows:
        validate_row(row)
        n += 1
    return n
