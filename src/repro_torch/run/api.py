"""Run API of the port: run document -> resolved graph -> result.

    from repro_torch.run import api
    result = api.execute_doc(doc, device="cpu")
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence

from .config import RunError, parse_run_doc
from .overrides import apply_overrides, parse_overrides


def _resolve_graph(graph: Dict[str, Any]) -> Dict[str, Any]:
    from ..config.resolver import resolve_config
    from ..core.components import register_all

    register_all()
    return resolve_config(graph)


def execute_serve(cfg, *, device=None, log=print) -> Dict[str, Any]:
    graph = _resolve_graph(cfg.graph)
    model = graph.get("model")
    if model is None:
        if "arch" not in graph:
            raise RunError("serve: the graph needs a 'model' or an 'arch' entry")
        from ..models import build_model

        model = build_model(graph["arch"])
    from ..launch.serve import serve_benchmark

    s = cfg.settings
    return serve_benchmark(model, batch=s.batch, prompt_len=s.prompt_len,
                           gen=s.gen, ckpt=s.ckpt, seed=s.seed, device=device,
                           log=log)


def execute_train(cfg, *, device=None, write_files: bool = False,
                  log=print) -> Dict[str, Any]:
    """Resolve the graph and drive its gym for ``run.train.steps`` steps:
    the part of JAX's ``run/kinds.py::_drive_gym`` this slice honours (no
    resume, warmstart, resilience, profiler or ``mfu``).  The result has
    ``first_loss``, ``final_loss``, ``tokens_per_s``, ``goodput`` and the
    flushed ``history``."""
    from ..telemetry import accounting as ACC
    from ..telemetry import build_recorder

    s = cfg.settings
    graph = _resolve_graph(cfg.graph)
    if s.gym_key not in graph:
        raise RunError(f"resolved config has no {s.gym_key!r} entry; "
                       f"top-level entries: {sorted(graph)}")
    gym = graph[s.gym_key]
    gym.device = device
    ev = graph.get("evaluator")
    if ev is not None and gym.eval_fn is None:
        gym.eval_fn = ev
        if not gym.eval_every:
            log("evaluator wired but gym.eval_every is 0 — it will never fire")
    state = gym.setup()
    rec = build_recorder(s.telemetry, output_dir=cfg.output_dir,
                         run=cfg.name, kind=cfg.kind, write=write_files,
                         log=log)
    gym.telemetry = rec
    if rec is not None:
        rec.event("run_start", steps=s.steps, steps_this_run=s.steps)
    t0 = time.time()
    try:
        out = gym.run(s.steps, state=state)
    except BaseException:
        if rec is not None:
            rec.close()
        raise
    wall = time.time() - t0
    hist = out["history"]
    dispatched = int(out["steps_dispatched"])
    result: Dict[str, Any] = {
        "steps": s.steps,
        "wall_s": round(wall, 6),
        "logged_points": len(hist),
        "history": hist,
        "steps_dispatched": dispatched,
        "goodput": ACC.goodput(int(out["productive_steps"]), dispatched),
    }
    losses = [m for m in hist if "loss" in m]
    if losses:
        result["first_loss"] = float(losses[0]["loss"])
        result["final_loss"] = float(losses[-1]["loss"])
    evals = [m for m in hist if any(k.startswith("eval_") for k in m)]
    if evals:
        result["eval_points"] = len(evals)
        result["final_eval"] = {k: v for k, v in evals[-1].items()
                                if k != "step"}
    gb = getattr(gym.loader, "global_batch", None)
    seq = getattr(getattr(gym.loader, "dataset", None), "seq_len", None)
    if gb and seq:
        result["tokens_per_s"] = int(s.steps * gb * seq / wall) \
            if wall > 0 else 0
    if rec is not None:
        rec.event("run_end", goodput=result["goodput"])
        result["telemetry"] = rec.summary()
        rec.close()
    return result


def execute_doc(doc: Dict[str, Any], *, kind: Optional[str] = None,
                overrides: Sequence[str] = (), device=None,
                write_result: bool = False,
                log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Apply ``--set`` overrides, parse, resolve and run one document.
    ``device`` is the card unless the caller asks for the CPU."""
    log = log or (lambda msg: print(msg, flush=True))
    doc = apply_overrides(doc, parse_overrides(overrides))
    cfg = parse_run_doc(doc, kind=kind)
    if cfg.kind == "train":
        result = execute_train(cfg, device=device, write_files=write_result,
                               log=log)
    else:
        result = execute_serve(cfg, device=device, log=log)
    if write_result:
        os.makedirs(cfg.output_dir, exist_ok=True)
        path = os.path.join(cfg.output_dir, "result.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=2, default=str)
            f.write("\n")
        log(f"run artifact: {cfg.output_dir}")
    return result


def execute_file(path: str, **kw) -> Dict[str, Any]:
    from ..config.resolver import load_yaml

    return execute_doc(load_yaml(path), **kw)
