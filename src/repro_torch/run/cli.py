"""The port's declarative entry point:

  python -m repro_torch train     --config run.yaml [--set path=value ...] [--device cuda|cpu]
  python -m repro_torch warmstart --config run.yaml [--source DIR] [--set ...] [--device ...]
  python -m repro_torch serve     --config run.yaml [--set ...] [--device ...]
  python -m repro_torch sft       --config run.yaml [--set ...] [--device ...]
  python -m repro_torch dpo       --config run.yaml [--set ...] [--device ...]
  python -m repro_torch bench     --config run.yaml [--set ...] [--device ...]
  python -m repro_torch replay    <run_dir> [--device ...]
  python -m repro_torch validate  <yaml-or-dir> [...]

A run runs on the card unless ``--device cpu`` is given; with no card and
no ``--device cpu`` it stops with an error.  Every run writes
``resolved.yaml``, ``manifest.json`` and ``result.json`` into its output
directory; ``replay`` re-executes such a directory (of either package).
``bench`` times the resolved gym's hot path and writes
``BENCH_<name>.json`` into the run's output directory (never the JAX
package's tracked files at the repo root).
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
            item = re.search(r"ROADMAP (A[\d.]*\d)", str(e))
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
                              write_result=True)
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
