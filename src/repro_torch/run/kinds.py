"""The port's run kinds, registered as components (``run_kind`` key), as
JAX's ``repro.run.kinds``: ``train``, ``warmstart``, ``sft``, ``dpo``,
``bench``, ``dryrun``, ``trace``, ``serve`` and ``sweep``.

Each kind is a :class:`RunKind`: a settings schema plus an executor taking
a :class:`repro_torch.run.api.RunContext` (JAX's, plus the ``device`` the
run is on).  New workloads register at runtime — a registry entry plus a
YAML schema, no new script and no edit to the port::

    register_run_kind("eval", EvalSettings, execute_eval)
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Type

from ..config.registry import DEFAULT_REGISTRY as REG
from .config import (BenchSettings, DPOSettings, DryrunSettings, RunError,
                     ServeSettings, SFTSettings, TraceSettings, TrainSettings,
                     WarmstartKindSettings, WarmstartSettings,
                     register_run_settings)


@dataclasses.dataclass(frozen=True)
class RunKind:
    """A registered workload: settings schema + executor."""

    kind: str
    settings_cls: Optional[Type]
    execute: Callable[..., Dict[str, Any]]


def register_run_kind(kind: str, settings_cls: Optional[Type],
                      execute: Callable[..., Dict[str, Any]]) -> RunKind:
    obj = RunKind(kind, settings_cls, execute)
    register_run_settings(kind, settings_cls)
    REG.register("run_kind", kind, (lambda o: (lambda: o))(obj), RunKind)
    return obj


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _writes(ctx) -> bool:
    """Does this run write files (artifacts, bench file, telemetry)?"""
    return bool(ctx.options.get("_write_files", True))


def _resolve_graph(ctx) -> Dict[str, Any]:
    from ..config.resolver import resolve_config

    return resolve_config(ctx.cfg.graph, ctx.registry)


def _graph_get(graph: Dict[str, Any], key: str, what: str) -> Any:
    if key not in graph:
        raise RunError(f"{what} run needs a top-level {key!r} entry in its "
                       f"component graph; available: {sorted(graph)}")
    return graph[key]


def _build_telemetry(ctx, s):
    """The run's telemetry recorder (None when ``telemetry: false``)."""
    from ..telemetry import build_recorder

    return build_recorder(getattr(s, "telemetry", None),
                          output_dir=ctx.cfg.output_dir, run=ctx.cfg.name,
                          kind=ctx.cfg.kind, fingerprint=ctx.fingerprint,
                          write=_writes(ctx), log=ctx.log)


def _bench_dir(ctx, bench_dir: str) -> str:
    """``"."`` (JAX's default, the working directory there) is the run's
    ``output_dir`` in the port, so a run from the repo root never
    overwrites the JAX package's tracked ``BENCH_*.json``."""
    return ctx.cfg.output_dir if bench_dir == "." else bench_dir


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def execute_serve(ctx) -> Dict[str, Any]:
    """The ``serve`` kind: the static-batch shim, or with ``engine: true``
    the continuous-batching engine over the workload's seeded trace (JAX's
    ``execute_serve``).  The engine run adds the ``compare_static`` shim
    baseline on the same params and, when the run writes files, writes
    ``BENCH_serve_<name>.json`` into ``bench_dir`` (see :func:`_bench_dir`;
    ``""`` writes none, as in JAX)."""
    cfg, device, log = ctx.cfg, ctx.device, ctx.log
    graph = _resolve_graph(ctx)
    model = graph.get("model")
    if model is None:
        if "arch" not in graph:
            raise RunError("serve: the graph needs a 'model' or an 'arch' entry")
        from ..models import build_model

        model = build_model(graph["arch"])
    from ..launch.serve import serve_benchmark

    s = cfg.settings
    from ..device import resolve_device

    provider = graph.get("mesh")
    mesh = (provider.build(resolve_device(device).type)
            if provider is not None else None)
    plan = graph.get("plan")
    if plan is not None and mesh is None:
        raise RunError(
            "run.serve: the config names a sharding 'plan' but its 'mesh' "
            "entry is missing or builds no devices (single_device) — the "
            "run would silently serve unsharded; add a device mesh or drop "
            "the plan")
    if not s.engine:
        return serve_benchmark(model, batch=s.batch, prompt_len=s.prompt_len,
                               gen=s.gen, ckpt=s.ckpt, seed=s.seed,
                               device=device, mesh=mesh, plan=plan, log=log)

    from ..serve.engine import ServeEngine, load_params
    from ..serve.workload import (shared_prefix_trace, synthetic_trace,
                                  trace_summary)

    w, samp = s.workload, s.sampling
    longest_prompt = w.prefix_len + max(w.prompt_lens)   # tails when prefixed
    max_len = s.max_len or (longest_prompt + max(w.gen_tokens))
    params = load_params(model, ckpt=s.ckpt, seed=s.seed, device=device)
    fault_injector = None
    if s.faults:
        from ..resilience import FaultInjector

        fault_injector = FaultInjector.from_config(s.faults)
    rec = _build_telemetry(ctx, s)
    engine = ServeEngine(model, params, n_slots=s.n_slots, max_len=max_len,
                         mesh=mesh, plan=plan,
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
    if plan is not None:
        result["plan"] = getattr(plan, "name", str(plan))
    if s.compare_static:
        # equal-footing baseline: the static-batch shim at batch=n_slots and
        # the longest workload shape, under the same mesh and plan:
        # continuous batching must not decode slower than a lockstep batch
        # of the same width and layout
        shim = serve_benchmark(model, batch=s.n_slots,
                               prompt_len=longest_prompt,
                               gen=max(w.gen_tokens), seed=s.seed,
                               params=params, device=device, mesh=mesh,
                               plan=plan, log=log)
        shim.pop("generated_ids", None)
        result["static_shim"] = shim
    if rec is not None:
        rec.event("run_end", completed=result.get("completed"),
                  tok_s=result.get("tok_s"))
        result["telemetry"] = rec.summary()
        rec.close()
    if _writes(ctx) and s.bench_dir:
        bench_dir = _bench_dir(ctx, s.bench_dir)
        os.makedirs(bench_dir, exist_ok=True)
        bench = {k: v for k, v in result.items() if k != "requests"}
        path = os.path.join(bench_dir, f"BENCH_serve_{cfg.name}.json")
        with open(path, "w") as f:
            json.dump({**bench, "name": cfg.name,
                       "fingerprint": ctx.fingerprint}, f, indent=2,
                      default=str)
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


def _refuse_modality_archs(kind: str, gym) -> None:
    """The train-family kinds step on the loader's token batches; the
    audio arch also needs ``frames`` and a VLM ``patch_embeds``, which only
    a stub frontend makes, and only the serve shim and a direct
    ``make_train_step`` call feed one.  Refused here, before the first
    step (JAX's gym raises a ``KeyError`` or a shape error instead)."""
    cfg = getattr(getattr(gym, "model", None), "cfg", None)
    if cfg is None or not (cfg.arch_type == "audio" or cfg.n_patches):
        return
    need = ("'frames' (the encoder's input)" if cfg.arch_type == "audio"
            else f"'patch_embeds' ({cfg.n_patches} image-patch embeddings)")
    raise RunError(
        f"{kind}: {cfg.name} needs {need} in every batch, and the loader "
        f"yields tokens only: the frames or patch embeddings come from a "
        f"stub frontend that only the serve shim and a direct "
        f"train.steps.make_train_step call feed")


def _prepare_gym(ctx, s, gym) -> None:
    """Checkpoint-dir defaulting and fingerprint stamping (``getattr``
    chains: a custom-registry gym need not carry these fields); refuses an
    audio or VLM model (``_refuse_modality_archs``)."""
    from .fingerprint import fingerprint as _fp

    _refuse_modality_archs(ctx.cfg.kind, gym)

    # a run that checkpoints but names no directory lands in the run dir —
    # and a resuming run looks there even when IT doesn't checkpoint
    if (getattr(gym, "ckpt_every", 0) or s.resume) \
            and not getattr(gym, "ckpt_dir", "") and ctx.cfg.output_dir:
        gym.ckpt_dir = os.path.join(ctx.cfg.output_dir, "ckpt")
    if hasattr(gym, "run_fingerprint") and not gym.run_fingerprint:
        # stamped into ckpt manifests and compared on restore: the
        # fingerprint of the COMPONENT GRAPH only, since run settings
        # (steps, resume) change across a legitimate resume
        gym.run_fingerprint = _fp(
            {k: v for k, v in ctx.resolved_doc.items() if k != "run"})


def _wire_resilience(s, gym, log) -> None:
    """Build the gym's resilience collaborators from the settings'
    ``resilience:`` block (no-op when absent, or for a gym without the
    fields)."""
    r = getattr(s, "resilience", None)
    if r is None or not hasattr(gym, "sentinel"):
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


def _build_profiler(ctx, s, rec):
    """ProfilerHook from ``telemetry.profile`` (None when unset, or when the
    run writes no files: a trace is a filesystem artifact)."""
    p = getattr(s.telemetry, "profile", None)
    if p is None or not _writes(ctx):
        return None
    out_dir = p.dir or (os.path.join(ctx.cfg.output_dir, "profile")
                        if ctx.cfg.output_dir else "")
    if not out_dir:
        ctx.log("[telemetry] profile requested but the run has no "
                "output_dir and no telemetry.profile.dir — skipping")
        return None
    from ..telemetry import ProfilerHook

    return ProfilerHook(p.start_step, p.num_steps, out_dir, recorder=rec,
                        log=ctx.log, device=ctx.device)


def _drive_gym(ctx, s, gym, before_run=None) -> Dict[str, Any]:
    """Setup -> warmstart/resume -> run -> result dict (JAX's
    ``_drive_gym``), shared by train/warmstart/sft/dpo.  ``before_run(state,
    resumed_from) -> state`` hooks in after restore but before training
    (the DPO reference, on-policy pairs); the final train state is the
    result's ``_state``, which each executor pops.  The result carries
    the resilience record (``rollback_count``,
    ``retry_count``, ``graceful_exit``, ``events`` and ``events.jsonl``,
    ``status: preempted`` with ``completed_steps``), ``goodput``,
    ``model_flops_per_step`` and ``mfu`` against the card's peak
    (:data:`repro_torch.device.PEAK_FLOPS_BF16`) times the mesh's devices,
    under a sharding plan the ``plan``'s description and its ``pipeline``
    telemetry, and ``profile_trace``.
    A custom-registry gym needs only ``setup`` and ``run``."""
    from ..telemetry import accounting as ACC

    cfg, log = ctx.cfg, ctx.log
    gym.device = ctx.device
    _prepare_gym(ctx, s, gym)
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
    rec = _build_telemetry(ctx, s)
    gym.telemetry = rec
    prof = None
    if rec is not None:
        prof = gym.profiler = _build_profiler(ctx, s, rec)
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
        guard = getattr(gym, "preempt_guard", None)
        if guard is not None:
            # a later run in this process must not inherit the handlers
            guard.uninstall()
    wall = time.time() - t0
    hist = out["history"]
    dispatched = int(out.get("steps_dispatched", steps))
    checkpointer = getattr(gym, "checkpointer", None)
    result: Dict[str, Any] = {
        "steps": s.steps,
        "steps_this_run": steps,
        "wall_s": round(wall, 6),
        "logged_points": len(hist),
        "history": hist,
        # productive steps over everything dispatched (rollback replays
        # discount it)
        "steps_dispatched": dispatched,
        "goodput": ACC.goodput(int(out.get("productive_steps", steps)),
                               dispatched),
        # resilience accounting (zero/False on clean runs by construction)
        "rollback_count": int(out.get("rollbacks", 0)),
        "retry_count": int(getattr(checkpointer, "retry_count", 0) or 0),
        "graceful_exit": bool(out.get("preempted", False)),
        "_state": out["state"],
    }
    loader = getattr(gym, "loader", None)
    if steps > 0 and wall > 0:
        flops = ACC.flops_per_train_step(getattr(gym, "model", None), loader,
                                         getattr(gym, "grad_accum", 1))
        if flops:
            result["model_flops_per_step"] = flops
            result["mfu"] = ACC.mfu(flops, wall / dispatched
                                    if dispatched else wall / steps,
                                    getattr(gym, "n_dev", 1))
    plan = getattr(gym, "plan", None)
    if plan is not None and hasattr(plan, "describe"):
        from ..sharding import plans as PL

        result["plan"] = plan.describe()
        result["pipeline"] = PL.pipeline_info(
            plan, getattr(gym, "_mesh", None),
            int(getattr(loader, "global_batch", 0) or 0))
    saves = getattr(checkpointer, "saves", None)
    if saves:
        result["ckpt_saves"] = list(saves)
    events = list(getattr(getattr(gym, "fault_injector", None), "events",
                          None) or [])
    events += out.get("events") or []
    if out.get("preempted"):
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
        if cfg.output_dir and _writes(ctx):
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
    gb = getattr(loader, "global_batch", None)
    seq = getattr(getattr(loader, "dataset", None), "seq_len", None)
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
    if ev is None or getattr(gym, "eval_fn", None) is not None \
            or not hasattr(gym, "eval_fn"):
        return
    gym.eval_fn = ev
    if not getattr(gym, "eval_every", 0):
        log("evaluator wired but gym.eval_every is 0 — it will never fire")


def execute_train(ctx) -> Dict[str, Any]:
    """Resolve the graph and drive its gym (see :func:`_drive_gym`).  The
    result has ``first_loss``, ``final_loss``, ``tokens_per_s``,
    ``goodput``, the flushed ``history``, and ``resumed_from`` /
    ``warmstart`` / ``ckpt_saves`` where they apply."""
    s = ctx.cfg.settings
    graph = _resolve_graph(ctx)
    if s.gym_key not in graph:
        raise RunError(f"resolved config has no {s.gym_key!r} entry; "
                       f"top-level entries: {sorted(graph)}")
    gym = graph[s.gym_key]
    _wire_evaluator(graph, gym, ctx.log)
    result = _drive_gym(ctx, s, gym)
    result.pop("_state")
    return result


def execute_warmstart(ctx) -> Dict[str, Any]:
    """The ``warmstart`` kind: the train kind with ``run.train.warmstart``
    made from the flat settings."""
    s = ctx.cfg.settings
    train = TrainSettings(
        steps=s.steps, gym_key=s.gym_key,
        warmstart={"source": s.source, "optimizer": s.optimizer,
                   "strict": s.strict})
    result = execute_train(dataclasses.replace(
        ctx, cfg=dataclasses.replace(ctx.cfg, settings=train)))
    result["kind"] = "warmstart"
    return result


# ---------------------------------------------------------------------------
# sft / dpo — post-training through the same gym loop
# ---------------------------------------------------------------------------
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


def _save_adapter_artifacts(ctx, s, gym, lora_model, state, result) -> None:
    """Adapter-only checkpoint + optional merged export (post-run)."""
    if lora_model is None:
        return
    from ..posttrain import lora as LO

    cfg, write_files = ctx.cfg, _writes(ctx)
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
        ctx.log(f"adapter checkpoint: {path}")
    if getattr(s, "export_merged", False) and cfg.output_dir and write_files:
        out = LO.export_merged(lora_model, state["params"],
                               os.path.join(cfg.output_dir, "merged"))
        result["merged_export"] = out
        ctx.log(f"merged export: {out}")


def execute_sft(ctx) -> Dict[str, Any]:
    """Supervised fine-tuning: the train loop over a loss-masked dataset,
    optionally with LoRA adapters (frozen base, adapter-only checkpoint,
    merged deploy export)."""
    s = ctx.cfg.settings
    graph = _resolve_graph(ctx)
    gym = _graph_get(graph, s.gym_key, "sft")
    _refuse_modality_archs("sft", gym)
    lora_model = _inject_lora(gym, s.lora, ctx.log)
    _wire_evaluator(graph, gym, ctx.log)
    result = _drive_gym(ctx, s, gym)
    state = result.pop("_state")
    result["lora"] = (dataclasses.asdict(s.lora)
                      if s.lora is not None else None)
    _save_adapter_artifacts(ctx, s, gym, lora_model, state, result)
    return result


def execute_dpo(ctx) -> Dict[str, Any]:
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

    s, log = ctx.cfg.settings, ctx.log
    graph = _resolve_graph(ctx)
    base_gym = _graph_get(graph, s.gym_key, "dpo")
    if not isinstance(base_gym, Gym):
        raise RunError(f"dpo: graph entry {s.gym_key!r} is not a gym")
    _refuse_modality_archs("dpo", base_gym)
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

    result = _drive_gym(ctx, s, gym, before_run=before_run)
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
    _save_adapter_artifacts(ctx, s, gym, lora_model, state, result)
    gym.ref_params = None
    return result


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------
def execute_bench(ctx) -> Dict[str, Any]:
    """Measure the resolved gym's hot path (:meth:`Gym.bench`) on the run's
    device and, when the run writes files, write ``BENCH_<name>.json``
    into ``bench_dir`` (see :func:`_bench_dir`; ``""`` writes none)."""
    s: BenchSettings = ctx.cfg.settings
    graph = _resolve_graph(ctx)
    gym = _graph_get(graph, s.gym_key, "bench")
    _refuse_modality_archs("bench", gym)
    gym.device = ctx.device
    rec = _build_telemetry(ctx, s)
    if rec is not None and hasattr(gym, "telemetry"):
        gym.telemetry = rec
        rec.event("run_start", steps=s.steps, warmup=s.warmup,
                  windows=s.windows)
    try:
        result = gym.bench(steps=s.steps, warmup=s.warmup,
                           windows=s.windows)
    except BaseException:
        if rec is not None:
            rec.close()
        raise
    result["name"] = ctx.cfg.name
    arch = graph.get("arch")
    if arch is not None:
        result["arch"] = getattr(arch, "name", str(arch))
        result["n_layers"] = getattr(arch, "n_layers", None)
        result["remat"] = getattr(arch, "remat", None)
        result["scan_block_size"] = getattr(arch, "scan_block_size", None)
    ctx.log(f"bench {ctx.cfg.name!r}: compile {result['compile_s']:.2f}s, "
            f"steady {result['steady_step_ms']:.1f} ms/step "
            f"(median of {len(result.get('windows', []))} windows)"
            + (f", {result['tokens_per_s']} tok/s"
               if "tokens_per_s" in result else "")
            + (f", mfu {result['mfu']:.3e}" if "mfu" in result else ""))
    if rec is not None:
        rec.event("run_end", steady_step_ms=result["steady_step_ms"])
        result["telemetry"] = rec.summary()
        rec.close()
    if s.bench_dir and _writes(ctx):
        bench_dir = _bench_dir(ctx, s.bench_dir)
        os.makedirs(bench_dir, exist_ok=True)
        path = os.path.join(bench_dir, f"BENCH_{ctx.cfg.name}.json")
        with open(path, "w") as f:
            json.dump({**result, "fingerprint": ctx.fingerprint}, f,
                      indent=2, default=str)
            f.write("\n")
        result["bench_file"] = path
    return result


# ---------------------------------------------------------------------------
# dryrun / trace
# ---------------------------------------------------------------------------
def _compile_components(ctx, grad_accum: int, keep_messages: bool,
                        verbose: bool) -> Dict[str, Any]:
    graph = _resolve_graph(ctx)
    cfg = _graph_get(graph, "arch", ctx.cfg.kind)
    shape = _graph_get(graph, "shape", ctx.cfg.kind)
    provider = graph.get("mesh")
    if provider is None:
        provider = ctx.registry.build("mesh_provider", "production")
    plan = graph.get("plan")
    precision = graph.get("precision")
    from ..launch.dryrun import compile_run

    # the provider passes through un-built: compile_run builds the mesh,
    # inside a fake world of its size, only once the skip check has passed
    # (skipped combos start no process group)
    return compile_run(
        cfg, shape, provider, plan,
        grad_accum=grad_accum,
        bf16_params=bool(getattr(precision, "bf16_params", False)),
        serve_bf16=bool(getattr(precision, "serve_bf16", False)),
        keep_messages=keep_messages,
        verbose=verbose,
    )


def execute_dryrun(ctx) -> Dict[str, Any]:
    """One step of the resolved components traced on a fake world, with no
    card (``repro_torch.launch.dryrun.compile_run``)."""
    s: DryrunSettings = ctx.cfg.settings
    return _compile_components(ctx, s.grad_accum, keep_messages=False,
                               verbose=bool(ctx.options.get("verbose")))


def execute_trace(ctx) -> Dict[str, Any]:
    """The dryrun's collective schedule as a table (``schedule``)."""
    s: TraceSettings = ctx.cfg.settings
    res = _compile_components(ctx, s.grad_accum, keep_messages=True,
                              verbose=False)
    if "skipped" in res:
        ctx.log(f"skipped: {res['skipped']}")
        return res
    from ..launch.trace import format_schedule

    text = format_schedule(res, top=s.top)
    ctx.log(text)
    res.pop("messages", None)
    res["schedule"] = text
    return res


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------
def build_sweep_spec(cfg, output_dir_override: str = ""):
    """The one place a run config becomes a SweepSpec (CLI + executor)."""
    from ..sweep.spec import SweepSpec

    spec = SweepSpec.from_dict(cfg.settings, config_dir=cfg.config_dir)
    if spec.name == "sweep" and cfg.name != "run":
        spec.name = cfg.name
    if output_dir_override:
        spec.output_dir = output_dir_override
    elif not spec.output_dir:
        spec.output_dir = cfg.output_dir
    return spec


def execute_sweep(ctx) -> Dict[str, Any]:
    """Run (or resume) every trial of the sweep on the run's device, then
    write ``report.json`` / ``report.txt`` (JAX's ``execute_sweep``; the
    options ``redo``, ``max_trials``, ``retry_failed`` and ``output_dir``
    are the CLI's flags)."""
    from ..sweep.report import load_records, write_report
    from ..sweep.runner import SweepRunner
    from ..telemetry import build_recorder
    from .config import _coerce_telemetry

    spec = build_sweep_spec(ctx.cfg, ctx.options.get("output_dir", ""))
    trials = spec.trials()
    ctx.log(f"sweep {spec.name!r}: {len(trials)} trials -> {spec.output_dir}")
    rec = build_recorder(
        _coerce_telemetry("sweep", spec.telemetry),
        output_dir=spec.output_dir or "", run=ctx.cfg.name, kind="sweep",
        fingerprint=ctx.fingerprint, write=_writes(ctx), log=ctx.log)
    if rec is not None:
        rec.event("run_start", n_trials=len(trials), backend=spec.backend)
    runner = SweepRunner(spec, log=ctx.log, telemetry=rec, device=ctx.device)
    try:
        records = runner.run(resume=not ctx.options.get("redo", False),
                             max_trials=int(ctx.options.get("max_trials", 0)),
                             retry_failed=bool(
                                 ctx.options.get("retry_failed", False)))
    except BaseException:
        if rec is not None:
            rec.close()
        raise
    n_resumed = sum(1 for r in records if r.get("resumed"))
    n_failed = sum(1 for r in records if r.get("status") == "failed")
    ctx.log(f"done: {len(records)} records ({n_resumed} resumed, "
            f"{n_failed} failed)")
    summary = write_report(spec, load_records(spec.output_dir))
    result = {
        "sweep": spec.name,
        "backend": spec.backend,
        "objective_metric": spec.objective_metric,
        "objective_mode": spec.objective_mode,
        "n_trials": len(trials),
        "n_records": len(records),
        "n_resumed": n_resumed,
        "n_failed": n_failed,
        "best": summary.get("best"),
        "report": f"{spec.output_dir}/report.json",
        "sweep_output_dir": spec.output_dir,
    }
    if rec is not None:
        rec.event("run_end", n_records=len(records), n_failed=n_failed)
        result["telemetry"] = rec.summary()
        rec.close()
    return result


# ---------------------------------------------------------------------------
_REGISTERED = False


def register_builtin_kinds() -> None:
    """Register the port's kinds with the default registry (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    register_run_kind("train", TrainSettings, execute_train)
    register_run_kind("warmstart", WarmstartKindSettings, execute_warmstart)
    register_run_kind("sft", SFTSettings, execute_sft)
    register_run_kind("dpo", DPOSettings, execute_dpo)
    register_run_kind("bench", BenchSettings, execute_bench)
    register_run_kind("dryrun", DryrunSettings, execute_dryrun)
    register_run_kind("trace", TraceSettings, execute_trace)
    register_run_kind("serve", ServeSettings, execute_serve)
    register_run_kind("sweep", None, execute_sweep)
