"""Sweep aggregation: ranked comparison tables + best-trial selection (port
of ``repro.sweep.report``).

Operates on the runner's JSONL records (in memory or re-loaded from the sweep
directory), so reports can be regenerated at any time without re-running a
single trial.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from .runner import RECORDS_FILE
from .spec import SweepError, SweepSpec


def load_records(output_dir: str) -> List[Dict[str, Any]]:
    """Re-load the per-trial JSONL records written by the runner."""
    path = os.path.join(output_dir, RECORDS_FILE)
    if not os.path.exists(path):
        raise SweepError(f"no sweep records at {path}; run the sweep first")
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def metric_value(record: Dict[str, Any], metric: str) -> Optional[float]:
    """Look up a metric by name in a record's ``metrics`` mapping."""
    metrics = record.get("metrics") or {}
    value = metrics.get(metric)
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    return None


def rank(records: Sequence[Dict[str, Any]], metric: str,
         mode: str = "min") -> List[Dict[str, Any]]:
    """Completed trials sorted best-first by ``metric``; trials without the
    metric (failed / skipped) sort last, in trial order."""
    if mode not in ("min", "max"):
        raise SweepError(f"rank mode must be 'min' or 'max', got {mode!r}")
    sign = 1.0 if mode == "min" else -1.0

    def key(rec: Dict[str, Any]):
        v = metric_value(rec, metric)
        return (v is None, sign * v if v is not None else 0.0,
                rec.get("index", 0))

    return sorted(records, key=key)


def best_trial(records: Sequence[Dict[str, Any]], metric: str,
               mode: str = "min") -> Optional[Dict[str, Any]]:
    """The winning record, or None if no trial produced the metric."""
    ranked = rank(records, metric, mode)
    if ranked and metric_value(ranked[0], metric) is not None:
        return ranked[0]
    return None


def _fmt(value: Any) -> str:
    if isinstance(value, bool) or value is None:
        return str(value)
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


def comparison_table(records: Sequence[Dict[str, Any]], metric: str,
                     mode: str = "min",
                     columns: Optional[Sequence[str]] = None) -> str:
    """Aligned text table of all trials, ranked best-first.

    ``columns`` picks extra metric columns; defaults to every metric key that
    appears in any record (objective first), capped at 6 for readability.
    """
    ranked = rank(records, metric, mode)
    if columns is None:
        seen: List[str] = [metric]
        for rec in ranked:
            for k in (rec.get("metrics") or {}):
                if k not in seen:
                    seen.append(k)
        columns = seen[:6]
    else:
        columns = list(columns)

    header = ["rank", "trial", *columns, "status"]
    rows = [header]
    for pos, rec in enumerate(ranked, start=1):
        cells = [str(pos), rec.get("trial_id", "?")]
        for col in columns:
            v = (rec.get("metrics") or {}).get(col)
            cells.append(_fmt(v) if v is not None else "-")
        cells.append(rec.get("status", "?"))
        rows.append(cells)
    widths = [max(len(r[c]) for r in rows) for c in range(len(header))]
    lines = []
    for i, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def summarize(records: Sequence[Dict[str, Any]], metric: str,
              mode: str = "min") -> Dict[str, Any]:
    """Machine-readable report: counts, ranking, and the winner."""
    ranked = rank(records, metric, mode)
    by_status: Dict[str, int] = {}
    by_error: Dict[str, int] = {}
    for rec in records:
        by_status[rec.get("status", "?")] = by_status.get(rec.get("status", "?"), 0) + 1
        if rec.get("status") == "failed":
            key = rec.get("error_type") or "?"
            if rec.get("failure_kind"):
                key = f"{key} ({rec['failure_kind']})"
            by_error[key] = by_error.get(key, 0) + 1
    best = best_trial(records, metric, mode)
    return {
        "objective": {"metric": metric, "mode": mode},
        "n_trials": len(records),
        "by_status": by_status,
        **({"failures_by_type": by_error} if by_error else {}),
        "best": None if best is None else {
            "trial_id": best["trial_id"],
            "patches": best.get("patches", {}),
            "seed": best.get("seed"),
            "value": metric_value(best, metric),
        },
        "ranking": [
            {"trial_id": rec["trial_id"],
             "value": metric_value(rec, metric),
             "status": rec.get("status")}
            for rec in ranked
        ],
    }


def write_report(spec: SweepSpec,
                 records: Optional[Sequence[Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
    """Write ``report.json`` + ``report.txt`` into the sweep directory and
    return the summary dict."""
    if not spec.output_dir:
        raise SweepError("write_report needs a sweep with an output_dir")
    if records is None:
        records = load_records(spec.output_dir)
    metric, mode = spec.objective_metric, spec.objective_mode
    summary = summarize(records, metric, mode)
    summary["sweep"] = spec.name
    table = comparison_table(records, metric, mode)
    with open(os.path.join(spec.output_dir, "report.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    with open(os.path.join(spec.output_dir, "report.txt"), "w") as f:
        f.write(f"sweep: {spec.name}  objective: {mode}({metric})\n\n")
        f.write(table + "\n")
    return summary
