"""Run documents of the port (the ``serve`` kind of ``repro.run.config``).

A run document is a YAML mapping with a ``run:`` header naming the kind and
a per-kind settings section; everything else is the component graph the
resolver builds.  This slice runs ``serve`` with its static settings
(``batch``, ``prompt_len``, ``gen``, ``seed``): the static-batch shim.  The
JAX package's engine settings are recognised and refused with the slice
that will bring them, so a document never runs with settings ignored.
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


class RunError(Exception):
    pass


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


def parse_run_doc(doc: Dict[str, Any], *, kind: Optional[str] = None) -> RunConfig:
    if not isinstance(doc, dict):
        raise RunError("run document must be a mapping")
    doc = dict(doc)
    run_sec = dict(doc.pop("run", None) or {})
    doc_kind = run_sec.get("kind") or kind
    if kind is not None and doc_kind != kind:
        raise RunError(f"document declares kind {doc_kind!r} but was "
                       f"launched as {kind!r}")
    if doc_kind != "serve":
        raise NotImplementedError(
            f"run kind {doc_kind!r}: the port runs 'serve' so far; training "
            f"kinds come with the training slice")
    unknown = set(run_sec) - {"kind", "name", "output_dir", "serve"}
    if unknown:
        raise RunError(f"run section has unknown keys {sorted(unknown)}")
    section = dict(run_sec.get("serve") or {})
    engine_only = sorted(set(section) & set(ENGINE_FIELDS))
    if engine_only:
        raise NotImplementedError(f"run.serve {engine_only}: {_ENGINE_SLICE}")
    fields = {f.name for f in dataclasses.fields(ServeSettings)}
    if set(section) - fields:
        raise RunError(f"run.serve: unknown settings "
                       f"{sorted(set(section) - fields)}; accepted: "
                       f"{sorted(fields)}")
    name = str(run_sec.get("name") or "run")
    output_dir = str(run_sec.get("output_dir")
                     or os.path.join("results", "runs", name))
    return RunConfig(kind="serve", name=name, output_dir=output_dir,
                     settings=ServeSettings(**section), graph=doc)
