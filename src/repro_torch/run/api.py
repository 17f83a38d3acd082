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


def fingerprint(doc: Dict[str, Any]) -> str:
    """The fingerprint of a normalized run document (``RunConfig.doc``):
    sha256 of its materialized form, factory defaults filled in, as JAX's
    ``run.api.execute`` computes it, so one document has one fingerprint in
    both packages."""
    from ..core.components import register_all
    from .fingerprint import fingerprint as _fingerprint
    from .fingerprint import materialize

    register_all()
    return _fingerprint(materialize(doc))


def execute_serve(cfg, *, device=None, write_files: bool = False,
                  log=print) -> Dict[str, Any]:
    """The ``serve`` kind: the static-batch shim, or with ``engine: true``
    the continuous-batching engine over the workload's seeded trace (JAX's
    ``run/kinds.py::execute_serve``).  The engine run adds the
    ``compare_static`` shim baseline on the same params and, with
    ``write_files``, writes ``BENCH_serve_<name>.json`` into ``bench_dir``,
    where ``"."`` (the default) means the run's ``output_dir`` and ``""``
    writes none, as in JAX.  (JAX reads ``"."`` as the working directory:
    run from the repo root, it overwrites the JAX package's tracked
    ``BENCH_serve_quickstart.json``.)"""
    graph = _resolve_graph(cfg.graph)
    model = graph.get("model")
    if model is None:
        if "arch" not in graph:
            raise RunError("serve: the graph needs a 'model' or an 'arch' entry")
        from ..models import build_model

        model = build_model(graph["arch"])
    from ..launch.serve import serve_benchmark

    s = cfg.settings
    if not s.engine:
        return serve_benchmark(model, batch=s.batch, prompt_len=s.prompt_len,
                               gen=s.gen, ckpt=s.ckpt, seed=s.seed,
                               device=device, log=log)

    from ..serve.engine import ServeEngine, load_params
    from ..serve.workload import (shared_prefix_trace, synthetic_trace,
                                  trace_summary)
    from ..telemetry import build_recorder

    w, samp = s.workload, s.sampling
    longest_prompt = w.prefix_len + max(w.prompt_lens)   # tails when prefixed
    max_len = s.max_len or (longest_prompt + max(w.gen_tokens))
    params = load_params(model, ckpt=s.ckpt, seed=s.seed, device=device)
    rec = build_recorder(s.telemetry, output_dir=cfg.output_dir,
                         run=cfg.name, kind=cfg.kind, write=write_files,
                         log=log)
    engine = ServeEngine(model, params, n_slots=s.n_slots, max_len=max_len,
                         greedy=samp.temperature <= 0,
                         block_len=None if s.block_len < 0 else s.block_len,
                         n_blocks=s.n_blocks, prefill_chunk=s.prefill_chunk,
                         prefix_cache=s.prefix_cache,
                         deadline_s=s.deadline_s, watchdog_s=s.watchdog_s,
                         telemetry=rec, log=log)
    kw = dict(seed=w.seed, rate=w.rate, prompt_lens=w.prompt_lens,
              gen_tokens=w.gen_tokens, temperature=samp.temperature,
              top_k=samp.top_k, top_p=samp.top_p, eos_id=s.eos_id,
              max_len=max_len)
    if w.prefix_len:
        trace = shared_prefix_trace(w.n_requests, model.cfg.vocab,
                                    prefix_len=w.prefix_len,
                                    n_prefixes=w.n_prefixes, **kw)
    else:
        trace = synthetic_trace(w.n_requests, model.cfg.vocab, **kw)
    ts = trace_summary(trace)
    log(f"serve engine: {ts['n_requests']} requests "
        f"({ts['prompt_tokens']} prompt tokens, gen budget "
        f"{ts['gen_budget']}, span {ts['span_s']:.2f}s) over "
        f"{s.n_slots} slots (max_len {max_len}, "
        f"{'paged' if engine.paged else 'dense'} cache)")
    if rec is not None:
        rec.event("run_start", n_requests=ts["n_requests"],
                  n_slots=s.n_slots)
    try:
        result: Dict[str, Any] = engine.run(trace, realtime=w.realtime)
    except BaseException:
        if rec is not None:
            rec.close()
        raise
    result["arch"] = model.cfg.name
    # resilience fields of the BENCH_* schema (serving never rolls back or
    # checkpoints; a clean engine run reports zeros)
    result.update(rollback_count=0, retry_count=0, graceful_exit=False)
    if s.compare_static:
        # equal-footing baseline: the static-batch shim at batch=n_slots and
        # the longest workload shape: continuous batching must not decode
        # slower than a lockstep batch of the same width
        shim = serve_benchmark(model, batch=s.n_slots,
                               prompt_len=longest_prompt,
                               gen=max(w.gen_tokens), seed=s.seed,
                               params=params, device=device, log=log)
        shim.pop("generated_ids", None)
        result["static_shim"] = shim
    if rec is not None:
        rec.event("run_end", completed=result.get("completed"),
                  tok_s=result.get("tok_s"))
        result["telemetry"] = rec.summary()
        rec.close()
    if write_files and s.bench_dir:
        bench_dir = cfg.output_dir if s.bench_dir == "." else s.bench_dir
        os.makedirs(bench_dir, exist_ok=True)
        bench = {k: v for k, v in result.items() if k != "requests"}
        path = os.path.join(bench_dir, f"BENCH_serve_{cfg.name}.json")
        with open(path, "w") as f:
            json.dump({**bench, "name": cfg.name,
                       "fingerprint": fingerprint(cfg.doc)}, f, indent=2,
                      default=str)
            f.write("\n")
        result["bench_file"] = path
    return result


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
        result = execute_serve(cfg, device=device, write_files=write_result,
                               log=log)
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
