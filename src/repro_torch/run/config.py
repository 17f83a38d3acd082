"""Run documents of the port (the ``train`` and ``serve`` kinds of
``repro.run.config``).

A run document is a YAML mapping with a ``run:`` header naming the kind and
a per-kind settings section; everything else is the component graph the
resolver builds.  ``train`` drives the resolved gym for ``steps`` steps with
its telemetry; ``serve`` runs the static-batch shim (``batch``,
``prompt_len``, ``gen``, ``seed``).  The JAX package's other kinds and
settings are recognised and refused with the slice that will bring them,
so a document never runs with settings ignored.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

#: settings of ``run.serve`` that only the continuous-batching engine reads
ENGINE_FIELDS = ("n_slots", "max_len", "eos_id", "block_len", "n_blocks",
                 "prefill_chunk", "prefix_cache", "sampling", "workload",
                 "compare_static", "bench_dir", "deadline_s", "watchdog_s",
                 "faults", "telemetry")
_ENGINE_SLICE = ("the continuous-batching engine (paged KV cache, sampling, "
                 "workloads) comes with the paged-engine and sampling slices "
                 "of the port")


#: the JAX package's other run kinds, and the slice of the port that brings
#: each
OTHER_KINDS = {
    "bench": "the bench kind comes with the port's benchmarks (ROADMAP A9); "
             "its JAX counterpart writes BENCH_<name>.json at the repo root",
    "sft": "post-training comes with its slice of the port (ROADMAP A6)",
    "dpo": "post-training comes with its slice of the port (ROADMAP A6)",
    "warmstart": "warmstart comes with the checkpoint slice of the port "
                 "(ROADMAP A4)",
    "dryrun": "dryrun, trace and sweeps come with ROADMAP A9",
    "trace": "dryrun, trace and sweeps come with ROADMAP A9",
    "sweep": "dryrun, trace and sweeps come with ROADMAP A9",
}


class RunError(Exception):
    pass


@dataclasses.dataclass
class TelemetrySettings:
    """``run.<kind>.telemetry``: the unified observability block, on by
    default.  ``telemetry: false`` disables it; ``sink`` picks a sink
    variant; ``spans: false`` keeps metric and event rows but drops the
    per-step phase spans.  ``profile`` (the profiler window) comes with
    ROADMAP A5 and is refused."""

    enabled: bool = True
    sink: str = "jsonl"
    path: str = ""                # file sinks; default <output_dir>/telemetry.*
    prefix: str = ""              # stdout sink
    sinks: Any = ()               # multi sink: nested {sink, path, prefix} rows
    spans: bool = True
    profile: Any = None

    _KNOWN_SINKS = ("jsonl", "csv", "stdout", "multi", "memory")

    def __post_init__(self):
        if self.sink not in self._KNOWN_SINKS:
            raise RunError(f"telemetry.sink must be one of "
                           f"{list(self._KNOWN_SINKS)}, got {self.sink!r}")
        if self.sink == "multi":
            if not isinstance(self.sinks, (list, tuple)) or not self.sinks:
                raise RunError("telemetry.sink 'multi' needs a non-empty "
                               "'sinks' list")
            self.sinks = [s if isinstance(s, dict) else {"sink": str(s)}
                          for s in self.sinks]
        else:
            self.sinks = list(self.sinks or ())
        if self.profile is not None:
            raise NotImplementedError(
                "telemetry.profile: the profiler window (and mfu) comes with "
                "the telemetry slice of the port (ROADMAP A5)")


def _coerce_telemetry(kind: str, value: Any) -> TelemetrySettings:
    """absent/None/true => defaults (on); false => disabled."""
    if isinstance(value, TelemetrySettings):
        return value
    if value is None or value is True:
        return TelemetrySettings()
    if value is False:
        return TelemetrySettings(enabled=False)
    if not isinstance(value, dict):
        raise RunError(f"run.{kind}.telemetry must be a mapping or a bool")
    fields = {f.name for f in dataclasses.fields(TelemetrySettings)}
    unknown = set(value) - fields
    if unknown:
        raise RunError(f"run.{kind}.telemetry: unknown keys {sorted(unknown)}; "
                       f"accepted: {sorted(fields)}")
    return TelemetrySettings(**value)


@dataclasses.dataclass
class TrainSettings:
    """``run.train``: drive the resolved gym for ``steps`` steps.
    ``resume``/``warmstart`` (ROADMAP A4) and ``resilience`` (A5) are
    refused."""

    steps: int = 100
    resume: Any = False
    warmstart: Any = None
    gym_key: str = "gym"          # top-level graph entry that is the gym
    resilience: Any = None
    telemetry: Any = None         # mapping/bool -> TelemetrySettings

    def __post_init__(self):
        if self.resume or self.warmstart is not None:
            raise NotImplementedError(
                "run.train.resume/warmstart: checkpoints come with the "
                "checkpoint slice of the port (ROADMAP A4)")
        if self.resilience is not None:
            raise NotImplementedError(
                "run.train.resilience: the sentinel, preemption and fault "
                "injection come with ROADMAP A5")
        if self.steps < 0:
            raise RunError(f"run.train.steps must be >= 0, got {self.steps}")
        self.telemetry = _coerce_telemetry("train", self.telemetry)


@dataclasses.dataclass
class ServeSettings:
    """``run.serve``: the static-batch shim — ``batch`` greedy requests of
    ``prompt_len`` random tokens, ``gen`` tokens each."""

    batch: int = 4
    prompt_len: int = 32
    gen: int = 16
    ckpt: str = ""
    seed: int = 0
    engine: bool = False

    def __post_init__(self):
        if self.engine:
            raise NotImplementedError(f"run.serve.engine: {_ENGINE_SLICE}")
        if min(self.batch, self.prompt_len, self.gen) < 1:
            raise RunError(f"run.serve: batch/prompt_len/gen must be >= 1, got "
                           f"{self.batch}/{self.prompt_len}/{self.gen}")


@dataclasses.dataclass
class RunConfig:
    kind: str
    name: str
    output_dir: str
    settings: Any
    graph: Dict[str, Any]


_SETTINGS = {"train": TrainSettings, "serve": ServeSettings}


def parse_run_doc(doc: Dict[str, Any], *, kind: Optional[str] = None) -> RunConfig:
    if not isinstance(doc, dict):
        raise RunError("run document must be a mapping")
    doc = dict(doc)
    run_sec = dict(doc.pop("run", None) or {})
    doc_kind = run_sec.get("kind") or kind
    if kind is not None and doc_kind != kind:
        raise RunError(f"document declares kind {doc_kind!r} but was "
                       f"launched as {kind!r}")
    if doc_kind in OTHER_KINDS:
        raise NotImplementedError(f"run kind {doc_kind!r}: "
                                  f"{OTHER_KINDS[doc_kind]}")
    if doc_kind not in _SETTINGS:
        raise RunError(f"unknown run kind {doc_kind!r}; the port runs "
                       f"{sorted(_SETTINGS)}")
    unknown = set(run_sec) - {"kind", "name", "output_dir", doc_kind}
    if unknown:
        raise RunError(f"run section has unknown keys {sorted(unknown)}")
    section = dict(run_sec.get(doc_kind) or {})
    if doc_kind == "serve":
        engine_only = sorted(set(section) & set(ENGINE_FIELDS))
        if engine_only:
            raise NotImplementedError(f"run.serve {engine_only}: "
                                      f"{_ENGINE_SLICE}")
    cls = _SETTINGS[doc_kind]
    fields = {f.name for f in dataclasses.fields(cls)}
    if set(section) - fields:
        raise RunError(f"run.{doc_kind}: unknown settings "
                       f"{sorted(set(section) - fields)}; accepted: "
                       f"{sorted(fields)}")
    name = str(run_sec.get("name") or "run")
    output_dir = str(run_sec.get("output_dir")
                     or os.path.join("results", "runs", name))
    return RunConfig(kind=doc_kind, name=name, output_dir=output_dir,
                     settings=cls(**section), graph=doc)
