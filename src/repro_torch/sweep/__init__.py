"""Declarative sweep orchestration (port of ``repro.sweep``; paper §2:
ablation studies as config).

A sweep is itself a declarative YAML document: a *base* config plus a set of
*axes* (``grid`` / ``zip`` / ``list``) whose expansion deep-patches the base
into concrete trial configs, optionally replicated across seeds.  The runner
executes trials in one process through a pluggable backend (``gym`` trains
on the device the sweep runs on; ``dryrun`` traces each trial's step on a
fake world of its mesh's size), persists one JSONL record per trial, and resumes by skipping trials
whose records already exist.  The report layer ranks completed trials by
the sweep objective.  Trial ids, records and reports are the JAX package's.
"""
from .report import best_trial, comparison_table, load_records, rank, write_report
from .runner import SweepRunner
from .spec import SweepError, SweepSpec, Trial, set_path

__all__ = [
    "SweepError",
    "SweepSpec",
    "SweepRunner",
    "Trial",
    "best_trial",
    "comparison_table",
    "load_records",
    "rank",
    "set_path",
    "write_report",
]
