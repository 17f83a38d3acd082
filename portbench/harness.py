"""One run of one cell, found by name: the cell in ``BENCHMARK.json``,
its configuration, traffic and limits, the module of its traffic's kind
(``kinds/<kind>.py``) that runs it, and the metric readers
(``metrics/<metric>.py``) that make its result line.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

from . import trace as TRACE
from . import traffic as TRAFFIC

#: the JAX package and what it stands on: none may be loaded
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """The run cannot measure what it was asked to."""


def root_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_cell(root: str, name: str) -> Dict[str, Any]:
    """The cell's entry in ``BENCHMARK.json`` with its configuration,
    traffic, limits and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                         f"({', '.join(sorted(cells))})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    limits_path = os.path.join(root, "portbench", "limits", f"{name}.json")
    limits = None
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)["limits"]

    def applies(m, e2e_names):
        if "workloads" in m:
            return name in m["workloads"]
        return e2e_names is None or m.get("moves") in e2e_names

    e2e = [m for m in bench["end_to_end"] if applies(m, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, names)]
    return {"name": name, "chips": cell["chips"], "config": config,
            "traffic": TRAFFIC.load(root, cell["traffic"]),
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


def load_reader(root: str, metric: str) -> Callable:
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package
    (compared whole: ``repro_torch`` is not ``repro``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc``."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_kind(kind: str):
    """The module that runs cells of traffic ``kind``:
    ``kinds/<kind>.py``, with ``run_cell`` and ``judge``."""
    return importlib.import_module(f"{__package__}.kinds.{kind}")


def run_cell(cell, seed: int, seconds, trace: bool, **kw) -> Dict[str, Any]:
    """Run ``cell`` once through its kind's module; returns the run's
    record, which :func:`result_line` and the metric readers read."""
    return load_kind(cell["traffic"]["kind"]).run_cell(cell, seed, seconds,
                                                       trace, **kw)


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------
def result_line(record, trace: bool, root: Optional[str] = None,
                limits=None, device_info=None) -> Dict[str, Any]:
    """The contract's last line from a run record."""
    root = root or root_dir()
    cell = record["cell"]
    limits = limits if limits is not None else cell["limits"]
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        value = load_reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks, ok = load_kind(cell["traffic"]["kind"]).judge(record, limits)
    out: Dict[str, Any] = {
        "correct": bool(ok and record["failed"] == 0),
        "attempted": record["attempted"],
        "failed": record["failed"],
        "metrics": metrics,
        "device": dict(device_info or {}),
    }
    out["device"]["memory_peak_bytes"] = record["peak_bytes"]
    prof = record["profile"]
    if trace and prof and prof["busy_s"] is not None:
        out["device"]["busy_s"] = prof["busy_s"]
        out["device"]["window_s"] = prof["t1"] - prof["t0"]
        out["breakdown"] = TRACE.breakdown(prof, record["spans"])
    out["checks"] = checks
    return out
