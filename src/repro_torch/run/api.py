"""Run API of the port: run document -> materialize -> fingerprint ->
resolved graph -> result (JAX's ``repro.run.api`` and the train, warmstart,
serve, sft and dpo kinds of ``repro.run.kinds``).

    from repro_torch.run import api
    result = api.execute_doc(doc, device="cpu")

With ``write_result`` every run writes ``resolved.yaml`` + ``manifest.json``
(the replay artifact, byte-equal to JAX's) and ``result.json`` into its
output directory; :func:`replay` re-executes a run directory of either
package.  Every result carries the run's ``fingerprint`` and
``output_dir``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence

from .config import (RunError, TrainSettings, WarmstartSettings,
                     parse_run_doc)
from .overrides import apply_overrides, parse_overrides

RESULT_FILE = "result.json"


def _register() -> None:
    from ..core.components import register_all

    register_all()


def _resolve_graph(graph: Dict[str, Any]) -> Dict[str, Any]:
    from ..config.resolver import resolve_config

    _register()
    return resolve_config(graph)


def fingerprint(doc: Dict[str, Any]) -> str:
    """The fingerprint of a normalized run document (``RunConfig.doc``):
    sha256 of its materialized form, factory defaults filled in, as JAX's
    ``run.api.execute`` computes it, so one document has one fingerprint in
    both packages."""
    from .fingerprint import fingerprint as _fingerprint
    from .fingerprint import materialize

    _register()
    return _fingerprint(materialize(doc))


def execute_serve(cfg, *, device, write_files: bool, log,
                  fp: str) -> Dict[str, Any]:
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
    fault_injector = None
    if s.faults:
        from ..resilience import FaultInjector

        fault_injector = FaultInjector.from_config(s.faults)
    rec = build_recorder(s.telemetry, output_dir=cfg.output_dir,
                         run=cfg.name, kind=cfg.kind, fingerprint=fp,
                         write=write_files, log=log)
    engine = ServeEngine(model, params, n_slots=s.n_slots, max_len=max_len,
                         greedy=samp.temperature <= 0,
                         block_len=None if s.block_len < 0 else s.block_len,
                         n_blocks=s.n_blocks, prefill_chunk=s.prefill_chunk,
                         prefix_cache=s.prefix_cache,
                         deadline_s=s.deadline_s, watchdog_s=s.watchdog_s,
                         fault_injector=fault_injector, telemetry=rec,
                         log=log)
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
                       "fingerprint": fp}, f, indent=2, default=str)
            f.write("\n")
        result["bench_file"] = path
    return result


# ---------------------------------------------------------------------------
# train-shaped kinds: checkpoint dir, resume, warmstart, the total budget
# ---------------------------------------------------------------------------
def _strip_new_adapters(tree, donor_keys, prefix=""):
    """Drop LoRA adapter subtrees the donor checkpoint does not carry.

    A LoRA-wrapped gym has ``lora`` subtrees in its params (and mirrored
    through AdamW's m/v/master) that a *base* pretraining checkpoint
    cannot know about.  Like the derivable ``opt.master`` leaves, these
    are exempted from warmstart strictness rather than forcing
    ``strict: false`` everywhere: they keep their fresh init (factors from
    ``LoRAModel.init``, zeroed optimizer moments).  Returns the stripped
    tree plus ``{path: subtree}`` for :func:`_reattach`; a donor that DOES
    carry the adapters (warmstarting from a previous SFT run) strips
    nothing and restores them strictly."""
    from ..posttrain.lora import ADAPTER_KEY

    removed = {}

    def walk(node, pfx):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            p = f"{pfx}/{k}" if pfx else k
            if k == ADAPTER_KEY and isinstance(v, dict) and not any(
                    dk == p or dk.startswith(p + "/") for dk in donor_keys):
                removed[p] = v
                continue
            out[k] = walk(v, p)
        return out

    return walk(tree, prefix), removed


def _reattach(tree, removed, prefix=""):
    """Put stripped subtrees back into a freshly-restored tree."""
    for path, sub in removed.items():
        rel = path[len(prefix) + 1:] if prefix else path
        parts = rel.split("/")
        node = tree
        for part in parts[:-1]:
            node = node[part]
        node[parts[-1]] = sub
    return tree


def _apply_warmstart(state, ws: WarmstartSettings, cfg, log) -> Any:
    """Init params (and with ``carry`` the optimizer state) from another
    run's checkpoint.  The step counter stays 0: a warmstart is a new run,
    not a resume.  A relative ``source`` that does not exist from the
    working directory is read relative to the run document.  Adapter
    subtrees the donor does not carry keep their fresh init
    (:func:`_strip_new_adapters`); a donor with adapters restores them
    strictly."""
    from ..ckpt import elastic as EL

    source = ws.source
    if not os.path.isabs(source) and not os.path.exists(source):
        cand = os.path.join(cfg.config_dir, source)
        if os.path.exists(cand):
            source = cand
    donor_keys = EL.manifest_keys(source)
    if ws.optimizer == "carry":
        # params + optimizer state restore in ONE call, so f32 master
        # copies correctly suppress the compute params' lossy-cast warning
        donor_has_masters = any(k.startswith("opt/master/")
                                for k in donor_keys)
        opt_like = state["opt"]
        if not donor_has_masters and "master" in opt_like:
            # masters are derivable from the restored params — exempt them
            # from strictness instead of forcing strict: false everywhere
            opt_like = {k: v for k, v in opt_like.items() if k != "master"}
        like, removed = _strip_new_adapters(
            {"params": state["params"], "opt": opt_like}, donor_keys)
        sub = _reattach(EL.restore(like, source, strict=ws.strict), removed)
        state = dict(state, params=sub["params"],
                     opt=dict(state["opt"], **sub["opt"]))
        if not donor_has_masters:
            # the target's masters kept their random init: rebase them
            state = _rebase_master(state)
    else:
        like, removed = _strip_new_adapters(state["params"], donor_keys,
                                            prefix="params")
        params = _reattach(EL.restore(like, source, prefix="params",
                                      strict=ws.strict),
                           removed, prefix="params")
        state = _rebase_master(dict(state, params=params))
    if removed:
        log(f"warmstart: donor has no adapters — keeping fresh init "
            f"for {sorted(removed)}")
    log(f"warmstart: params from {source} "
        f"(optimizer={ws.optimizer}, strict={ws.strict})")
    return state


def _rebase_master(state):
    """Point a master-weights optimizer's f32 copies at the (re)stored
    params — AdamW derives params from ``opt.master`` every update, so a
    stale random-init master would silently undo a warmstart at step 1."""
    from ..tree import tree_map

    opt = state["opt"]
    if "master" not in opt:
        return state
    master = tree_map(lambda p, m: p.to(m.dtype, copy=True),
                      state["params"], opt["master"])
    return dict(state, opt=dict(opt, master=master))


def _prepare_gym(cfg, s, gym, resolved: Dict[str, Any]) -> None:
    """Checkpoint-dir defaulting and fingerprint stamping."""
    from .fingerprint import fingerprint as _fp

    # a run that checkpoints but names no directory lands in the run dir —
    # and a resuming run looks there even when IT doesn't checkpoint
    if (gym.ckpt_every or s.resume) and not gym.ckpt_dir and cfg.output_dir:
        gym.ckpt_dir = os.path.join(cfg.output_dir, "ckpt")
    if not gym.run_fingerprint:
        # stamped into ckpt manifests and compared on restore: the
        # fingerprint of the COMPONENT GRAPH only, since run settings
        # (steps, resume) change across a legitimate resume
        gym.run_fingerprint = _fp(
            {k: v for k, v in resolved.items() if k != "run"})


def _wire_resilience(s, gym, log) -> None:
    """Build the gym's resilience collaborators from the settings'
    ``resilience:`` block (no-op when absent)."""
    r = getattr(s, "resilience", None)
    if r is None:
        return
    from ..resilience import (FaultInjector, PreemptionGuard, RetryPolicy,
                              StepSentinel)

    if r.sentinel is not None and gym.sentinel is None:
        sn = r.sentinel
        gym.sentinel = StepSentinel(
            metric=sn.metric, nan=sn.nan, spike_zscore=sn.spike_zscore,
            window=sn.window, min_history=sn.min_history)
        log(f"resilience: sentinel on {sn.metric!r} "
            f"(nan={sn.nan}, spike_zscore={sn.spike_zscore})")
    gym.max_rollbacks = r.max_rollbacks
    gym.skip_window = r.skip_window
    if r.ckpt_retry is not None and gym.ckpt_retry is None:
        cr = r.ckpt_retry
        gym.ckpt_retry = RetryPolicy(
            max_attempts=cr.max_attempts, base_delay_s=cr.base_delay_s,
            max_delay_s=cr.max_delay_s, jitter=cr.jitter)
    if r.faults and gym.fault_injector is None:
        gym.fault_injector = FaultInjector.from_config(r.faults)
        log(f"resilience: {len(r.faults)} scheduled fault(s) armed")
    if r.preemption and gym.preempt_guard is None:
        # the handlers install on the main thread only (off it the guard
        # holds the flag alone)
        gym.preempt_guard = PreemptionGuard().install()


def _build_profiler(cfg, s, rec, *, device, write_files: bool, log):
    """ProfilerHook from ``telemetry.profile`` (None when unset, or when the
    run writes no files: a trace is a filesystem artifact)."""
    p = getattr(s.telemetry, "profile", None)
    if p is None or not write_files:
        return None
    out_dir = p.dir or (os.path.join(cfg.output_dir, "profile")
                        if cfg.output_dir else "")
    if not out_dir:
        log("[telemetry] profile requested but the run has no output_dir "
            "and no telemetry.profile.dir — skipping")
        return None
    from ..telemetry import ProfilerHook

    return ProfilerHook(p.start_step, p.num_steps, out_dir, recorder=rec,
                        log=log, device=device)


def _drive_gym(cfg, s, gym, *, device, write_files: bool, log, fp: str,
               resolved: Dict[str, Any], before_run=None) -> Dict[str, Any]:
    """Setup -> warmstart/resume -> run -> result dict (JAX's
    ``_drive_gym``), shared by train/warmstart/sft/dpo.  ``before_run(state,
    resumed_from) -> state`` hooks in after restore but before training
    (the DPO reference, on-policy pairs); the final train state is the
    result's ``_state``, which each executor pops.  The result carries
    the resilience record (``rollback_count``,
    ``retry_count``, ``graceful_exit``, ``events`` and ``events.jsonl``,
    ``status: preempted`` with ``completed_steps``), ``goodput``,
    ``model_flops_per_step`` and ``mfu`` against the card's peak
    (:data:`repro_torch.device.PEAK_FLOPS_BF16`), and ``profile_trace``."""
    from ..telemetry import accounting as ACC
    from ..telemetry import build_recorder

    gym.device = device
    _prepare_gym(cfg, s, gym, resolved)
    state = gym.setup()
    resumed_from = None
    if s.warmstart is not None:
        state = _apply_warmstart(state, s.warmstart, cfg, log)
    elif s.resume:
        state, resumed_from = gym.restore(state)
        if resumed_from is not None:
            log(f"resume: continuing from committed step {resumed_from}")
        else:
            log("resume: no committed checkpoint found, starting from step 0")
    if before_run is not None:
        state = before_run(state, resumed_from)
    # `steps` is the TOTAL budget: a resumed run trains only the remainder,
    # so interrupted + resumed reproduces the uninterrupted loss curve
    steps = max(0, s.steps - (resumed_from or 0))
    rec = build_recorder(s.telemetry, output_dir=cfg.output_dir,
                         run=cfg.name, kind=cfg.kind, fingerprint=fp,
                         write=write_files, log=log)
    gym.telemetry = rec
    prof = None
    if rec is not None:
        prof = gym.profiler = _build_profiler(
            cfg, s, rec, device=device, write_files=write_files, log=log)
        rec.event("run_start", steps=s.steps, steps_this_run=steps,
                  resumed_from=resumed_from)
    _wire_resilience(s, gym, log)
    t0 = time.time()
    try:
        out = gym.run(steps, state=state)
    except BaseException:
        if rec is not None:
            rec.close()
        raise
    finally:
        if gym.preempt_guard is not None:
            # a later run in this process must not inherit the handlers
            gym.preempt_guard.uninstall()
    wall = time.time() - t0
    hist = out["history"]
    dispatched = int(out["steps_dispatched"])
    result: Dict[str, Any] = {
        "steps": s.steps,
        "steps_this_run": steps,
        "wall_s": round(wall, 6),
        "logged_points": len(hist),
        "history": hist,
        # productive steps over everything dispatched (rollback replays
        # discount it)
        "steps_dispatched": dispatched,
        "goodput": ACC.goodput(int(out["productive_steps"]), dispatched),
        # resilience accounting (zero/False on clean runs by construction)
        "rollback_count": int(out["rollbacks"]),
        "retry_count": int(getattr(gym.checkpointer, "retry_count", 0) or 0),
        "graceful_exit": bool(out["preempted"]),
        "_state": out["state"],
    }
    if steps > 0 and wall > 0:
        flops = ACC.flops_per_train_step(gym.model, gym.loader,
                                         gym.grad_accum)
        if flops:
            result["model_flops_per_step"] = flops
            result["mfu"] = ACC.mfu(flops, wall / dispatched
                                    if dispatched else wall / steps)
    saves = getattr(gym.checkpointer, "saves", None)
    if saves:
        result["ckpt_saves"] = list(saves)
    events = list(getattr(gym.fault_injector, "events", None) or [])
    events += out["events"]
    if out["preempted"]:
        result["status"] = "preempted"
        result["completed_steps"] = int(out["state"]["step"])
        log(f"preempted at step {result['completed_steps']} — final "
            f"checkpoint committed; rerun with resume: auto")
    if events:
        result["events"] = events
        if rec is not None:
            for ev in events:
                attrs = {k: v for k, v in ev.items()
                         if k not in ("step", "name")}
                rec.event("resilience/" + str(ev.get("kind",
                                                     ev.get("reason",
                                                            "event"))),
                          step=ev.get("step"), **attrs)
        if cfg.output_dir and write_files:
            path = os.path.join(cfg.output_dir, "events.jsonl")
            with open(path, "a") as f:
                for ev in events:
                    f.write(json.dumps(ev, default=str) + "\n")
            result["events_file"] = path
    if resumed_from is not None:
        result["resumed_from"] = resumed_from
        if steps == 0:
            # the budget was already met: report the no-op but do NOT
            # overwrite the completed run's result.json (its loss curve is
            # the only record of the finished training)
            result["_no_result_file"] = True
    if s.warmstart is not None:
        result["warmstart"] = dataclasses.asdict(s.warmstart)
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
        result["tokens_per_s"] = int(steps * gb * seq / wall) \
            if wall > 0 else 0
    if prof is not None and prof.artifact:
        result["profile_trace"] = prof.artifact
    if rec is not None:
        rec.event("run_end", goodput=result["goodput"],
                  rollbacks=result["rollback_count"],
                  preempted=result["graceful_exit"])
        result["telemetry"] = rec.summary()
        rec.close()
    return result


def _wire_evaluator(graph, gym, log) -> None:
    """A top-level ``evaluator`` component becomes the gym's eval hook (an
    ``eval_fn`` set programmatically wins)."""
    ev = graph.get("evaluator")
    if ev is not None and gym.eval_fn is None:
        gym.eval_fn = ev
        if not gym.eval_every:
            log("evaluator wired but gym.eval_every is 0 — it will never fire")


def execute_train(cfg, *, device, write_files: bool, log, fp: str,
                  resolved: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve the graph and drive its gym (see :func:`_drive_gym`).  The
    result has ``first_loss``, ``final_loss``, ``tokens_per_s``,
    ``goodput``, the flushed ``history``, and ``resumed_from`` /
    ``warmstart`` / ``ckpt_saves`` where they apply."""
    s = cfg.settings
    graph = _resolve_graph(cfg.graph)
    if s.gym_key not in graph:
        raise RunError(f"resolved config has no {s.gym_key!r} entry; "
                       f"top-level entries: {sorted(graph)}")
    gym = graph[s.gym_key]
    _wire_evaluator(graph, gym, log)
    result = _drive_gym(cfg, s, gym, device=device, write_files=write_files,
                        log=log, fp=fp, resolved=resolved)
    result.pop("_state")
    return result


def execute_warmstart(cfg, **kw) -> Dict[str, Any]:
    """The ``warmstart`` kind: the train kind with ``run.train.warmstart``
    made from the flat settings."""
    s = cfg.settings
    train = TrainSettings(
        steps=s.steps, gym_key=s.gym_key,
        warmstart={"source": s.source, "optimizer": s.optimizer,
                   "strict": s.strict})
    result = execute_train(dataclasses.replace(cfg, settings=train), **kw)
    result["kind"] = "warmstart"
    return result


# ---------------------------------------------------------------------------
# sft / dpo — post-training through the same gym loop
# ---------------------------------------------------------------------------
def _post_gym(graph, s, what: str):
    if s.gym_key not in graph:
        raise RunError(f"{what} run needs a top-level {s.gym_key!r} entry in "
                       f"its component graph; available: {sorted(graph)}")
    return graph[s.gym_key]


def _inject_lora(gym, lora_settings, log):
    """Wrap the resolved gym's model/optimizer for adapter-only training;
    returns the LoRAModel (or None for full fine-tuning)."""
    if lora_settings is None:
        return None
    from ..device import MetaGenerator
    from ..posttrain import lora as LO

    cfg = LO.LoRAConfig(rank=lora_settings.rank, alpha=lora_settings.alpha,
                        targets=tuple(lora_settings.targets))
    gym.model = LO.LoRAModel(gym.model, cfg)
    gym.optimizer = LO.FrozenBaseOptimizer(gym.optimizer)
    tr, total = LO.n_trainable(gym.model.init(MetaGenerator()))
    log(f"lora: rank {cfg.rank} alpha {cfg.alpha} targets "
        f"{list(cfg.targets)} — {tr:,} trainable / {total:,} params "
        f"({100.0 * tr / total:.2f}%)")
    return gym.model


def _save_adapter_artifacts(cfg, s, gym, lora_model, state, result, *,
                            write_files: bool, log) -> None:
    """Adapter-only checkpoint + optional merged export (post-run)."""
    if lora_model is None:
        return
    from ..posttrain import lora as LO

    adapter_dir = s.adapter_dir or (
        os.path.join(cfg.output_dir, "adapter") if cfg.output_dir else "")
    if adapter_dir and write_files:
        path = LO.save_adapter(
            adapter_dir, int(state["step"]), state["params"],
            extra={"rank": lora_model.lora.rank,
                   "alpha": lora_model.lora.alpha,
                   "targets": list(lora_model.lora.targets),
                   "fingerprint": gym.run_fingerprint})
        result["adapter_ckpt"] = path
        log(f"adapter checkpoint: {path}")
    if getattr(s, "export_merged", False) and cfg.output_dir and write_files:
        out = LO.export_merged(lora_model, state["params"],
                               os.path.join(cfg.output_dir, "merged"))
        result["merged_export"] = out
        log(f"merged export: {out}")


def execute_sft(cfg, *, device, write_files: bool, log, fp: str,
                resolved: Dict[str, Any]) -> Dict[str, Any]:
    """Supervised fine-tuning: the train loop over a loss-masked dataset,
    optionally with LoRA adapters (frozen base, adapter-only checkpoint,
    merged deploy export)."""
    s = cfg.settings
    graph = _resolve_graph(cfg.graph)
    gym = _post_gym(graph, s, "sft")
    lora_model = _inject_lora(gym, s.lora, log)
    _wire_evaluator(graph, gym, log)
    result = _drive_gym(cfg, s, gym, device=device, write_files=write_files,
                        log=log, fp=fp, resolved=resolved)
    state = result.pop("_state")
    result["lora"] = (dataclasses.asdict(s.lora)
                      if s.lora is not None else None)
    _save_adapter_artifacts(cfg, s, gym, lora_model, state, result,
                            write_files=write_files, log=log)
    return result


def execute_dpo(cfg, *, device, write_files: bool, log, fp: str,
                resolved: Dict[str, Any]) -> Dict[str, Any]:
    """Direct preference optimization: policy vs. frozen reference on
    chosen/rejected pairs, via :class:`repro_torch.posttrain.dpo.DPOGym`.
    The result adds ``beta``, ``lora``, ``first_margin``, ``final_margin``
    and ``final_reward_accuracy``."""
    import torch

    from ..core.gym import Gym
    from ..posttrain import lora as LO
    from ..posttrain.dpo import (DPOGym, PreferencePairDataset,
                                 sample_onpolicy_pairs)
    from ..tree import tree_map

    s = cfg.settings
    graph = _resolve_graph(cfg.graph)
    base_gym = _post_gym(graph, s, "dpo")
    if not isinstance(base_gym, Gym):
        raise RunError(f"dpo: graph entry {s.gym_key!r} is not a gym")
    # rebuild the resolved gym as a DPOGym: same injected components, the
    # preference step swapped in through the step hooks
    fields = {f.name: getattr(base_gym, f.name)
              for f in dataclasses.fields(Gym)}
    gym = DPOGym(beta=s.beta, **fields)
    lora_model = _inject_lora(gym, s.lora, log)

    def copy_tree(tree):
        return tree_map(lambda x: x.detach().clone(), tree)

    def replace_dataset(loader, dataset):
        if hasattr(loader, "loader"):  # PrefetchLoader wraps the real one
            return dataclasses.replace(
                loader, loader=replace_dataset(loader.loader, dataset))
        return dataclasses.replace(loader, dataset=dataset)

    def before_run(state, resumed_from):
        if s.onpolicy is not None:
            # sample pairs from the (warmstarted/restored) policy through
            # the serve engine, replacing the graph's dataset
            op = s.onpolicy
            if lora_model is not None:
                sample_model = lora_model.base
                with torch.no_grad():
                    sample_params = lora_model.merge(state["params"])
            else:
                sample_model, sample_params = gym.model, state["params"]
            pairs = sample_onpolicy_pairs(
                sample_model, sample_params, vocab=gym.model.cfg.vocab,
                n_prompts=op.n_prompts, prompt_len=op.prompt_len,
                gen_tokens=op.gen_tokens, temperature=op.temperature,
                top_k=op.top_k, top_p=op.top_p, seed=op.seed,
                n_slots=op.n_slots, log=log)
            del sample_params
            seq_len = op.prompt_len + op.gen_tokens - 1
            dataset = PreferencePairDataset(pairs, seq_len=seq_len,
                                            seed=op.seed)
            gym.loader = replace_dataset(gym.loader, dataset)
            log(f"dpo: {len(pairs)} on-policy pairs sampled "
                f"(seq_len {seq_len})")
        # the frozen reference: under LoRA it is the zero-adapter base
        # (reconstructible on resume); full-param DPO copies the freshly
        # warmstarted params.  Copies, never aliases — the step updates
        # the state's tensors in place.
        if lora_model is not None:
            ref = copy_tree(LO.zero_adapters(state["params"]))
        else:
            if resumed_from is not None:
                raise RunError("dpo: cannot resume without lora (the "
                               "reference params are unrecoverable)")
            ref = copy_tree(state["params"])
        gym.ref_params = ref
        return state

    result = _drive_gym(cfg, s, gym, device=device, write_files=write_files,
                        log=log, fp=fp, resolved=resolved,
                        before_run=before_run)
    state = result.pop("_state")
    result["beta"] = s.beta
    result["lora"] = (dataclasses.asdict(s.lora)
                      if s.lora is not None else None)
    hist = [m for m in (result.get("history") or []) if "margin" in m]
    if hist:
        result["first_margin"] = float(hist[0]["margin"])
        result["final_margin"] = float(hist[-1]["margin"])
        result["final_reward_accuracy"] = float(
            hist[-1].get("reward_accuracy", 0.0))
    _save_adapter_artifacts(cfg, s, gym, lora_model, state, result,
                            write_files=write_files, log=log)
    gym.ref_params = None
    return result


_EXECUTORS = {"train": execute_train, "warmstart": execute_warmstart,
              "serve": execute_serve, "sft": execute_sft, "dpo": execute_dpo}


def execute(cfg, *, device=None, write_result: bool = False,
            log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Execute a parsed run config on ``device`` (the card unless the
    caller asks for the CPU).  With ``write_result`` the run writes its
    artifacts first and ``result.json`` last (not for a resumed run that had
    nothing left to train)."""
    from ..device import resolve_device
    from .fingerprint import fingerprint as _fingerprint
    from .fingerprint import materialize, write_artifacts

    log = log or (lambda msg: print(msg, flush=True))
    device = resolve_device(device)
    _register()
    resolved = materialize(cfg.doc)
    fp = _fingerprint(resolved)
    if write_result and cfg.output_dir:
        write_artifacts(cfg.output_dir, resolved, cfg.name, cfg.kind)
    kw = dict(device=device, write_files=write_result, log=log, fp=fp)
    if cfg.kind != "serve":
        kw["resolved"] = resolved
    result = _EXECUTORS[cfg.kind](cfg, **kw)
    result.setdefault("kind", cfg.kind)
    result["fingerprint"] = fp
    result["output_dir"] = cfg.output_dir
    no_file = result.pop("_no_result_file", False)
    if write_result and cfg.output_dir and not no_file:
        os.makedirs(cfg.output_dir, exist_ok=True)
        with open(os.path.join(cfg.output_dir, RESULT_FILE), "w") as f:
            json.dump(result, f, indent=2, default=str)
            f.write("\n")
        log(f"run artifact: {cfg.output_dir}")
    return result


def execute_doc(doc: Dict[str, Any], *, kind: Optional[str] = None,
                overrides: Sequence[str] = (), device=None,
                write_result: bool = False, default_name: str = "run",
                config_dir: str = ".",
                log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Apply ``--set`` overrides, parse and execute one document.
    ``device`` is the card unless the caller asks for the CPU."""
    doc = apply_overrides(doc, parse_overrides(overrides))
    cfg = parse_run_doc(doc, kind=kind, default_name=default_name,
                        config_dir=config_dir)
    return execute(cfg, device=device, write_result=write_result, log=log)


def execute_file(path: str, **kw) -> Dict[str, Any]:
    """:func:`execute_doc` of a YAML file, named by its stem unless the
    document names itself; relative paths in it resolve from its
    directory."""
    from ..config.resolver import load_yaml

    kw.setdefault("default_name", os.path.splitext(os.path.basename(path))[0])
    kw.setdefault("config_dir", os.path.dirname(os.path.abspath(path)))
    return execute_doc(load_yaml(path) or {}, **kw)


def replay(run_dir: str, *, device=None,
           log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Re-execute a run (of either package) from its artifact.

    Loads ``<run_dir>/resolved.yaml``, verifies its fingerprint against the
    manifest, and executes it — the identical run (same resolved config,
    same fingerprint) — writing its artifacts and result again."""
    import yaml

    from .fingerprint import RESOLVED_FILE, read_manifest

    path = os.path.join(run_dir, RESOLVED_FILE)
    if not os.path.exists(path):
        raise RunError(f"no resolved config at {path}; not a run directory?")
    with open(path) as f:
        doc = yaml.safe_load(f)
    manifest = read_manifest(run_dir)
    fp = fingerprint(doc)
    if fp != manifest.get("fingerprint"):
        raise RunError(
            f"fingerprint mismatch: resolved.yaml materializes to {fp} but "
            f"the manifest records {manifest.get('fingerprint')} — the "
            f"artifact was edited or the registry changed"
        )
    return execute_doc(doc, config_dir=run_dir, device=device,
                       write_result=True, log=log)
