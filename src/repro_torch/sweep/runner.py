"""Sweep execution: one process, pluggable backends, resumable JSONL records
(port of ``repro.sweep.runner``).

All trials of a campaign run in the same Python process (no per-trial
subprocess): the ``gym`` backend re-resolves the object graph per trial and
trains it on the device the sweep was started with (``device=None`` is the
card, and with no card the sweep stops before its first record; a trial
never goes on quietly on the CPU).  Every finished trial appends one JSON
line to ``<output_dir>/records.jsonl``; a rerun of the same sweep loads
that file first and skips every trial whose record already exists (failed
trials are retried), so an interrupted campaign resumes where it stopped.
The ``dryrun`` backend traces each trial's step on a fake world of its
mesh's size (``repro_torch.launch.dryrun``), with no card.

Failure records carry the exception class in a structured ``error_type``
field plus a ``failure_kind`` transient/deterministic classification
(:func:`repro_torch.resilience.retry.classify_failure`); ``retry_failed``
restricts a resume to re-running only the transiently-failed trials —
a deterministic failure (bad config, shape error) replays identically,
so burning a retry on it is waste.  A spec-level ``retry:`` block
additionally wraps each trial in bounded in-process backoff before its
failure is ever recorded.  A backend factory takes the spec, and the
runner's ``device`` where its signature names one.
"""
from __future__ import annotations

import gc
import inspect
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from .spec import SweepSpec, Trial

RECORDS_FILE = "records.jsonl"
SPEC_FILE = "spec.json"


# ---------------------------------------------------------------------------
# backends — the gym backend drives the declarative Run API
# (repro_torch.run), so every trial materializes a replayable
# resolved-config + fingerprint artifact under <output_dir>/trials/<id>/.
# ---------------------------------------------------------------------------
def _trial_location(spec: SweepSpec, trial: Optional[Trial]):
    """(run name, artifact dir) for one trial; empty => in-memory only."""
    if trial is None or not spec.output_dir:
        return "", ""
    return trial.trial_id, os.path.join(spec.output_dir, "trials",
                                        trial.trial_id)


def _gym_backend(spec: SweepSpec, device: Any = None
                 ) -> Callable[..., Dict[str, Any]]:
    """Patch -> train run document -> Run API (``spec.steps`` steps) on
    ``device`` (the card unless the caller asks for the CPU; resolved here,
    so a sweep with no card stops before its first trial).

    Trials resume elastically: a retried (preempted / previously failed)
    trial runs with ``resume: auto``, so if its gym checkpoints (the
    ``ckpt_every`` knob), it continues from the last committed checkpoint
    under its trial directory instead of restarting from step 0.
    """
    from ..device import resolve_device
    from ..run import api as run_api
    from ..run.legacy import legacy_train_doc

    device = resolve_device(device)

    def execute(doc: Dict[str, Any], out_dir: str) -> Dict[str, Any]:
        try:
            return run_api.execute_doc(doc, device=device,
                                       write_result=bool(out_dir),
                                       log=lambda msg: None)
        finally:
            # the trial's gym, params and optimizer state are garbage now:
            # collect them before the next trial allocates its own
            gc.collect()

    def run(raw: Dict[str, Any], trial: Optional[Trial] = None) -> Dict[str, Any]:
        name, out_dir = _trial_location(spec, trial)
        # (execute_train already lands a checkpointing gym's ckpt_dir under
        # the trial dir — <out_dir>/ckpt — so no doc surgery is needed here)
        doc = legacy_train_doc(raw, steps=spec.steps, gym_key=spec.gym_key,
                               resume="auto" if out_dir else None,
                               name=name, output_dir=out_dir)
        result = execute(doc, out_dir)
        if result.get("resumed_from") and result.get("steps_this_run") == 0:
            # the budget was already met (records.jsonl lost its line, the
            # checkpoints survived): the completed run's result.json was
            # deliberately preserved by the no-op resume — reuse it, and
            # only retrain from scratch when it too is gone
            prior_path = os.path.join(out_dir, "result.json")
            prior = None
            if os.path.exists(prior_path):
                with open(prior_path) as f:
                    prior = json.load(f)
            if prior and "final_loss" in prior:
                result = prior
            else:
                fresh = legacy_train_doc(raw, steps=spec.steps,
                                         gym_key=spec.gym_key, resume=False,
                                         name=name, output_dir=out_dir)
                result = execute(fresh, out_dir)
        out = {
            key: result[key]
            for key in ("final_loss", "first_loss", "tokens_per_s", "steps",
                        "wall_s", "final_margin", "first_margin",
                        "final_reward_accuracy", "mfu", "goodput")
            if key in result
        }
        if result.get("resumed_from") is not None:
            out["resumed_from"] = result["resumed_from"]
        return out

    run.accepts_trial = True
    return run


_DRYRUN_KEEP = (
    "arch", "shape", "mesh", "plan", "chips", "dominant_term",
    "compute_term_s", "memory_term_s", "collective_term_s",
    "hlo_flops_per_dev", "hlo_bytes_per_dev", "collective_bytes_per_dev",
    "collective_counts", "useful_flops_ratio", "n_params", "n_params_active",
    "lower_s", "compile_s",
)


def _dryrun_backend(spec: SweepSpec, device: Any = None
                    ) -> Callable[..., Dict[str, Any]]:
    """Trace the trial's step on a fake world and report roofline terms.

    The base config is either a full dryrun *run document* (``run:`` section
    plus ``arch``/``shape``/``mesh``/``plan``/``precision`` component graph)
    or the historic flat ``dryrun()`` kwarg mapping (``arch``, ``shape`` plus
    any of ``plan_name``, ``scan_block``, ``multi_pod``, ...), which is
    converted to a run document per trial; patch paths address whichever form
    the base uses.  Each trial builds (and ends) its own fake world; the
    card is never touched, but ``device`` resolves as for every run (the
    card unless the caller asks for the CPU).
    """
    import copy

    from ..device import resolve_device
    from ..run import api as run_api
    from ..run.legacy import legacy_dryrun_doc

    device = resolve_device(device)

    def run(raw: Dict[str, Any], trial: Optional[Trial] = None) -> Dict[str, Any]:
        name, out_dir = _trial_location(spec, trial)
        if "run" in raw:
            doc = copy.deepcopy(raw)
            run_sec = dict(doc.get("run") or {})
            run_sec["kind"] = "dryrun"
            if name:
                run_sec["name"] = name
            if out_dir:
                run_sec["output_dir"] = out_dir
            doc["run"] = run_sec
        else:
            doc = legacy_dryrun_doc(raw, name=name)
            if out_dir:
                doc["run"]["output_dir"] = out_dir
        res = run_api.execute_doc(doc, device=device,
                                  write_result=bool(out_dir),
                                  log=lambda msg: None)
        if "skipped" in res:
            return {"skipped": res["skipped"]}
        metrics = {k: res[k] for k in _DRYRUN_KEEP if k in res}
        metrics["roofline_step_s"] = max(
            res["compute_term_s"], res["memory_term_s"],
            res["collective_term_s"],
        )
        return metrics

    run.accepts_trial = True
    return run


BACKENDS: Dict[str, Callable[[SweepSpec], Callable]] = {
    "gym": _gym_backend,
    "dryrun": _dryrun_backend,
}


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------
class SweepRunner:
    """Executes every trial of a spec, persisting + resuming via JSONL."""

    def __init__(self, spec: SweepSpec,
                 log: Optional[Callable[[str], None]] = None,
                 telemetry: Any = None, device: Any = None) -> None:
        self.spec = spec
        self.log = log or (lambda msg: None)
        # sweep-level TelemetryRecorder (repro_torch.telemetry): one
        # metric/event row per trial record, alongside the per-trial runs'
        # own files
        self.telemetry = telemetry
        # where the gym backend trains every trial (None: the card)
        self.device = device

    def backend(self) -> Callable:
        """The spec's backend: a missing card raises here, before the
        runner writes a file."""
        factory = BACKENDS[self.spec.backend]
        params = inspect.signature(factory).parameters
        return factory(self.spec, **({"device": self.device}
                                     if "device" in params else {}))

    # -- persistence --------------------------------------------------------
    def _records_path(self) -> Optional[str]:
        if not self.spec.output_dir:
            return None
        return os.path.join(self.spec.output_dir, RECORDS_FILE)

    def _load_existing(self) -> Dict[str, Dict[str, Any]]:
        path = self._records_path()
        if not path or not os.path.exists(path):
            return {}
        existing: Dict[str, Dict[str, Any]] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                existing[rec["trial_id"]] = rec
        return existing

    def _append(self, record: Dict[str, Any]) -> None:
        path = self._records_path()
        if not path:
            return
        with open(path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")

    def _write_spec_snapshot(self) -> None:
        if not self.spec.output_dir:
            return
        os.makedirs(self.spec.output_dir, exist_ok=True)
        snap = {
            "name": self.spec.name,
            "backend": self.spec.backend,
            "objective": {"metric": self.spec.objective_metric,
                          "mode": self.spec.objective_mode},
            "n_trials": len(self.spec.trials()),
            "axes": self.spec.axes,
            "seeds": self.spec.seeds,
            "steps": self.spec.steps,
        }
        with open(os.path.join(self.spec.output_dir, SPEC_FILE), "w") as f:
            json.dump(snap, f, indent=2, default=str)

    # -- execution ----------------------------------------------------------
    def run(self, resume: bool = True, max_trials: int = 0,
            retry_failed: bool = False) -> List[Dict[str, Any]]:
        """Run (or resume) the sweep; returns one record per trial, in trial
        order.  ``max_trials`` > 0 caps how many *new* trials execute (the
        resume workflow for budgeted sessions).  ``retry_failed`` narrows
        which failed priors are re-run: only the transiently-failed ones
        (``failure_kind != "deterministic"``; legacy records without the
        field get the benefit of the doubt) — a deterministic failure
        replays identically, so its record is carried forward instead."""
        spec = self.spec
        trials = spec.trials()
        backend = self.backend()  # a refused backend writes nothing
        self._write_spec_snapshot()
        records_path = self._records_path()
        if not resume and records_path and os.path.exists(records_path):
            os.remove(records_path)  # full redo starts a fresh record log
        existing = self._load_existing() if resume else {}

        records: List[Dict[str, Any]] = []
        ran = 0
        for trial in trials:
            prior = existing.get(trial.trial_id)
            if prior is not None and prior.get("status") != "failed":
                prior = dict(prior, resumed=True)
                records.append(prior)
                self.log(f"[{trial.index + 1}/{len(trials)}] "
                         f"{trial.trial_id}: already done, skipping")
                continue
            if prior is not None and retry_failed and \
                    prior.get("failure_kind") == "deterministic":
                records.append(dict(prior, resumed=True))
                self.log(f"[{trial.index + 1}/{len(trials)}] "
                         f"{trial.trial_id}: deterministic failure "
                         f"({prior.get('error_type', '?')}), not retried")
                continue
            if max_trials and ran >= max_trials:
                self.log(f"[{trial.index + 1}/{len(trials)}] "
                         f"{trial.trial_id}: deferred (max_trials reached)")
                continue
            ran += 1
            records.append(self._run_one(backend, trial, len(trials)))
        return records

    def _run_one(self, backend: Callable, trial: Trial,
                 total: int) -> Dict[str, Any]:
        spec = self.spec
        self.log(f"[{trial.index + 1}/{total}] {trial.trial_id}: running")
        record: Dict[str, Any] = {
            "sweep": spec.name,
            "trial_id": trial.trial_id,
            "index": trial.index,
            "patches": trial.patches,
            "seed": trial.seed,
            "backend": spec.backend,
        }
        _, run_dir = _trial_location(spec, trial)
        if run_dir and getattr(backend, "accepts_trial", False):
            record["run_dir"] = os.path.join("trials", trial.trial_id)
        t0 = time.time()
        try:
            def attempt():
                if getattr(backend, "accepts_trial", False):
                    return backend(spec.trial_config(trial), trial=trial)
                # historic single-argument backends (tests, plugins)
                return backend(spec.trial_config(trial))

            policy = self._retry_policy()
            if policy is None:
                metrics = attempt()
            else:
                from ..resilience.retry import call_with_retry

                def note(n, exc):
                    record["trial_retries"] = \
                        record.get("trial_retries", 0) + 1
                    self.log(f"  transient failure (attempt {n}): "
                             f"{type(exc).__name__}: {exc} — retrying")

                metrics = call_with_retry(attempt, policy=policy,
                                          on_retry=note)
            if "skipped" in metrics:
                record["status"] = "skipped"
                record["skip_reason"] = metrics["skipped"]
            else:
                record["status"] = "ok"
                record["metrics"] = metrics
        except Exception as e:  # record the failure, keep sweeping
            from ..resilience.retry import RetryError, classify_failure

            # an exhausted retry budget wraps the real failure: classify
            # and report the underlying exception, not the wrapper
            cause = e.__cause__ if isinstance(e, RetryError) \
                and e.__cause__ is not None else e
            record["status"] = "failed"
            record["error"] = f"{type(cause).__name__}: {cause}"
            record["error_type"] = type(cause).__name__
            record["failure_kind"] = classify_failure(cause)
            record["traceback"] = traceback.format_exc(limit=8)
            self.log(f"  FAILED ({record['failure_kind']}): "
                     f"{record['error']}")
        record["wall_s"] = round(time.time() - t0, 2)
        self._append(record)
        self._record_telemetry(trial, record)
        return record

    def _record_telemetry(self, trial: Trial,
                          record: Dict[str, Any]) -> None:
        tel = self.telemetry
        if tel is None:
            return
        status = record.get("status", "?")
        if status == "ok":
            # scalar metrics only (dryrun metrics carry nested mappings)
            data = {k: v for k, v in (record.get("metrics") or {}).items()
                    if isinstance(v, (int, float, str)) and
                    not isinstance(v, bool)}
            data["trial_wall_s"] = record["wall_s"]
            tel.metric(trial.index, data, trial_id=trial.trial_id,
                       status=status)
        else:
            tel.event(f"trial_{status}", step=trial.index,
                      trial_id=trial.trial_id,
                      error=record.get("error"),
                      failure_kind=record.get("failure_kind"),
                      skip_reason=record.get("skip_reason"))

    def _retry_policy(self):
        """The spec-level ``retry:`` block as a RetryPolicy (None = off)."""
        r = getattr(self.spec, "retry", None)
        if not r:
            return None
        from ..resilience.retry import RetryPolicy

        if isinstance(r, RetryPolicy):
            return r
        return RetryPolicy(**dict(r))


def run_sweep(spec: SweepSpec, resume: bool = True,
              log: Optional[Callable[[str], None]] = None,
              max_trials: int = 0, retry_failed: bool = False,
              device: Any = None) -> List[Dict[str, Any]]:
    """One-call convenience: execute a sweep spec and return its records."""
    return SweepRunner(spec, log=log, device=device).run(
        resume=resume, max_trials=max_trials, retry_failed=retry_failed)
