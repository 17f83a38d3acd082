"""The port's declarative entry point:

  python -m repro_torch train     --config run.yaml [--set path=value ...] [--device cuda|cpu]
  python -m repro_torch warmstart --config run.yaml [--source DIR] [--set ...] [--device ...]
  python -m repro_torch serve     --config run.yaml [--set ...] [--device ...]
  python -m repro_torch sft       --config run.yaml [--set ...] [--device ...]
  python -m repro_torch dpo       --config run.yaml [--set ...] [--device ...]
  python -m repro_torch bench     --config run.yaml [--set ...] [--device ...]
  python -m repro_torch dryrun    --config run.yaml [--set ...] [--json out.json] [--device ...]
  python -m repro_torch trace     --config run.yaml [--set ...] [--device ...]
  python -m repro_torch sweep     --config sweep.yaml [--list|--report-only|--redo|
                                  --max-trials N|--retry-failed|--output-dir D]
                                  [--set ...] [--device ...]
  python -m repro_torch replay    <run_dir> [--device ...]
  python -m repro_torch validate  <yaml-or-dir> [...]

A run runs on the card unless ``--device cpu`` is given; with no card and
no ``--device cpu`` it stops with an error.  A document whose gym names a
``mesh_provider`` and a ``sharding_plan`` trains under that plan:
``torchrun --standalone --nproc-per-node N -m repro_torch train --config
DOC [--device cpu]`` runs one process per device (NCCL on the card, gloo
on the CPU), and rank 0 alone prints and writes the run's files.  Every run writes
``resolved.yaml``, ``manifest.json`` and ``result.json`` into its output
directory; ``replay`` re-executes such a directory (of either package).
``bench`` times the resolved gym's hot path and writes
``BENCH_<name>.json`` into the run's output directory (never the JAX
package's tracked files at the repo root).  ``dryrun`` traces one step of
the document's arch, shape, mesh and plan on a fake world of the mesh's
size (no card is touched) and prints JAX's result keys (``--json`` also
writes them); ``trace`` prints its collective schedule.  ``sweep`` runs
(or resumes) a declarative ablation, every trial on the sweep's device (a
``dryrun`` sweep's trials each on a fake world), and ranks the trials in
``report.txt``; ``--list`` only expands the trials.
``validate`` checks documents without building anything: ``ok`` for a
document the port runs, ``skip`` (naming the ROADMAP item) for one of a
later slice, ``FAIL`` for a broken one (exit 1).  A train run stopped by
SIGTERM/SIGINT (with ``run.train.resilience``) or an injected ``preempt``
commits a final checkpoint, prints the resume hint and exits 75
(``PREEMPTED_EXIT_CODE``); the same command with ``run.train.resume=auto``
continues it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import List, Optional


def _add_kind_parser(sub, kind: str, help_text: str):
    p = sub.add_parser(kind, help=help_text)
    p.add_argument("--config", required=True, help="run document (YAML)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE", help="override a document entry")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_kind_parser(sub, "train", "resolve the graph and drive the gym")
    w = _add_kind_parser(sub, "warmstart",
                         "train from another run's checkpoint")
    w.add_argument("--source", default="",
                   help="checkpoint dir (shorthand for "
                        "--set run.warmstart.source=...)")
    _add_kind_parser(sub, "sft",
                     "supervised finetuning: loss-masked prompt/response "
                     "batches, optionally through LoRA adapters")
    _add_kind_parser(sub, "dpo",
                     "direct preference optimization against a frozen "
                     "reference (static pairs or on-policy sampling)")
    _add_kind_parser(sub, "serve",
                     "continuous-batching engine / static-batch shim")
    _add_kind_parser(sub, "bench",
                     "hot-path timing: first step, steady ms/step, tok/s")
    d = _add_kind_parser(sub, "dryrun",
                         "per-device cost of one step traced on a fake "
                         "world (the roofline terms)")
    d.add_argument("--json", default="",
                   help="also write the result JSON here")
    _add_kind_parser(sub, "trace",
                     "the collective schedule of one traced step")
    s = _add_kind_parser(sub, "sweep", "run a declarative ablation sweep")
    s.add_argument("--output-dir", default="",
                   help="override the spec's sweep directory")
    s.add_argument("--list", action="store_true",
                   help="print the expanded trials and exit (no execution)")
    s.add_argument("--report-only", action="store_true",
                   help="regenerate report from existing records and exit")
    s.add_argument("--redo", action="store_true",
                   help="ignore existing records, rerun every trial")
    s.add_argument("--max-trials", type=int, default=0,
                   help="cap how many new trials run this invocation")
    s.add_argument("--retry-failed", action="store_true",
                   help="on resume, re-run only transiently-failed trials "
                        "(IO/timeout); deterministic failures keep their "
                        "records")
    r = sub.add_parser("replay",
                       help="re-execute a run from its resolved.yaml artifact")
    r.add_argument("run_dir", help="directory holding resolved.yaml + "
                                   "manifest.json")
    r.add_argument("--device", default=None, help="cuda (default) or cpu")
    v = sub.add_parser("validate",
                       help="schema + registry validation only, no execution")
    v.add_argument("paths", nargs="+",
                   help="run YAML files or directories of them")
    return ap


def _print_result(kind: str, result) -> None:
    if kind in ("train", "warmstart", "sft", "dpo"):
        if "first_loss" in result:
            print(f"done: {result['logged_points']} logged points; first loss "
                  f"{result['first_loss']:.4f} -> last "
                  f"{result['final_loss']:.4f}, {result['tokens_per_s']} "
                  f"tok/s", flush=True)
        else:
            print(f"done: {result['steps_this_run']} steps, no logged points",
                  flush=True)
        if "final_margin" in result:
            print(f"dpo: margin {result['first_margin']:.4f} -> "
                  f"{result['final_margin']:.4f}, reward accuracy "
                  f"{result['final_reward_accuracy']:.3f}", flush=True)
    elif kind == "bench":
        print(f"bench artifact: {result.get('bench_file', '(disabled)')}",
              flush=True)
    elif kind in ("dryrun", "trace"):
        if "skipped" in result:
            print(f"skipped: {result['arch']} x {result['shape']}: "
                  f"{result['skipped']}", flush=True)
        else:
            print(f"done: {result['arch']} x {result['shape']} on "
                  f"{result['mesh']} ({result['plan']}): "
                  f"{result['hlo_flops_per_dev']:.4e} flops/device, "
                  f"dominant {result['dominant_term']}, traced in "
                  f"{result['compile_s']}s", flush=True)
    elif "bench_file" in result:
        print(f"done: {result['completed']}/{result['n_requests']} requests, "
              f"{result['tok_s']} tok/s, decode {result['decode_tok_s']} "
              f"tok/s, prefix-cache hit rate "
              f"{result['prefill_cache_hit_rate']}; bench: "
              f"{result['bench_file']}", flush=True)
    else:
        print(f"done: {result['batch']} requests x {result['gen']} tokens, "
              f"prefill {result['prefill_tok_s']} tok/s, decode "
              f"{result['decode_tok_s']} tok/s", flush=True)


def _sweep_config(args):
    """The sweep's run config: ``--set`` patches the normalized document
    (JAX's), ``--output-dir`` moves the sweep and its run artifact."""
    from ..config.resolver import load_yaml
    from .config import parse_run_doc
    from .overrides import apply_overrides, parse_overrides

    stem = os.path.splitext(os.path.basename(args.config))[0]
    config_dir = os.path.dirname(os.path.abspath(args.config))
    cfg = parse_run_doc(load_yaml(args.config) or {}, kind="sweep",
                        default_name=stem, config_dir=config_dir)
    sets = parse_overrides(args.overrides)
    if sets:
        cfg = parse_run_doc(apply_overrides(cfg.doc, sets), kind="sweep",
                            default_name=stem, config_dir=config_dir)
    if args.output_dir:
        cfg.output_dir = args.output_dir
        cfg.doc["run"]["output_dir"] = args.output_dir
    return cfg


def _cmd_sweep(args) -> int:
    from .kinds import build_sweep_spec

    cfg = _sweep_config(args)
    if args.list:
        spec = build_sweep_spec(cfg, args.output_dir)
        trials = spec.trials()
        print(f"sweep {spec.name!r}: backend={spec.backend} "
              f"trials={len(trials)}")
        for t in trials:
            patches = dict(t.patches)
            if t.seed is not None:
                patches["<seed>"] = t.seed
            print(f"  [{t.index}] {t.trial_id}: {json.dumps(patches)}")
        return 0
    if args.report_only:
        from ..sweep.report import write_report

        spec = build_sweep_spec(cfg, args.output_dir)
        summary = write_report(spec)  # SweepError without records: exit 2
        _print_report(spec.output_dir, summary.get("best"),
                      spec.objective_mode, spec.objective_metric)
        return 0

    from ..sweep.runner import SweepRunner
    from . import api

    # a missing card stops here, before the run writes its artifacts
    SweepRunner(build_sweep_spec(cfg, args.output_dir),
                device=args.device).backend()
    options = {"redo": args.redo, "max_trials": args.max_trials,
               "retry_failed": args.retry_failed}
    if args.output_dir:
        options["output_dir"] = args.output_dir
    result = api.execute(cfg, device=args.device, write_result=True,
                         options=options,
                         log=lambda msg: print(msg, flush=True))
    _print_report(result["sweep_output_dir"], result.get("best"),
                  result["objective_mode"], result["objective_metric"])
    return 1 if result.get("n_failed") else 0


def _print_report(output_dir, best, mode, metric) -> None:
    with open(os.path.join(output_dir, "report.txt")) as f:
        print(f.read())
    if best:
        print(f"best trial: {best['trial_id']} "
              f"({mode} {metric} = {best['value']:.6g})")
    print(f"report: {os.path.join(output_dir, 'report.json')}")


def _iter_yaml_paths(paths: List[str]):
    for p in paths:
        if os.path.isdir(p):
            for fn in sorted(os.listdir(p)):
                if fn.endswith((".yaml", ".yml")):
                    yield os.path.join(p, fn)
        else:
            yield p


def validate_path(path: str) -> str:
    """Validate one document; returns a human summary, raises on problems
    (``NotImplementedError`` for a document of a later slice)."""
    from ..config.resolver import load_yaml, validate_config
    from ..core.components import register_all
    from .config import parse_run_doc
    from .fingerprint import materialize

    register_all()
    doc = load_yaml(path) or {}
    stem = os.path.splitext(os.path.basename(path))[0]
    cfg = parse_run_doc(doc, default_name=stem,
                        config_dir=os.path.dirname(os.path.abspath(path)))
    if cfg.kind == "sweep":
        from ..sweep.spec import SweepSpec

        spec = SweepSpec.from_dict(cfg.settings, config_dir=cfg.config_dir)
        n = len(spec.trials())
        if isinstance(spec.base, dict) \
                and ("gym" in spec.base or "run" in spec.base):
            validate_config({k: v for k, v in spec.base.items()
                             if k != "run"})
        return f"kind=sweep backend={spec.backend} trials={n}"
    counts = validate_config(cfg.graph)
    materialize(cfg.doc)  # defaults must be expressible / variants known
    return (f"kind={cfg.kind} components={counts['components']} "
            f"top_level={counts['top_level']}")


def _cmd_validate(paths: List[str]) -> int:
    failures = 0
    for path in _iter_yaml_paths(paths):
        try:
            info = validate_path(path)
        except NotImplementedError as e:
            item = re.search(r"ROADMAP (A\d[\w.]*)", str(e))
            print(f"skip {path} (not ported: ROADMAP "
                  f"{item.group(1) if item else '?'})")
            continue
        except Exception as e:
            failures += 1
            print(f"FAIL {path}: {type(e).__name__}: {e}")
            continue
        print(f"ok   {path}  ({info})")
    if failures:
        print(f"{failures} config(s) failed validation", file=sys.stderr)
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "validate":
        return _cmd_validate(args.paths)

    if args.command == "sweep":
        from ..config.resolver import ConfigError
        from ..sweep.spec import SweepError
        from .config import RunError

        try:
            return _cmd_sweep(args)
        except (RunError, ConfigError, SweepError, FileNotFoundError,
                NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    from . import api

    if args.command == "replay":
        result = api.replay(args.run_dir, device=args.device)
        print(f"replayed {result['kind']} run: fingerprint "
              f"{result['fingerprint']}", flush=True)
        return 0
    if args.command == "warmstart" and args.source:
        args.overrides.append(f"run.warmstart.source={args.source}")
    result = api.execute_file(args.config, kind=args.command,
                              overrides=args.overrides, device=args.device,
                              write_result=True,
                              options={"verbose": args.command == "dryrun"})
    if args.command == "dryrun" and args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2, default=str)
    from ..launch.mesh import process_rank, shutdown

    shutdown()   # a one-rank group the run's mesh started
    if process_rank() == 0:
        _print_result(args.command, result)
    if result.get("status") == "preempted":
        # distinct resumable status (EX_TEMPFAIL): the scheduler should
        # relaunch this exact command with resume intact
        from ..resilience import PREEMPTED_EXIT_CODE

        print(f"preempted: resume with the same command "
              f"(exit {PREEMPTED_EXIT_CODE})", flush=True)
        return PREEMPTED_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
