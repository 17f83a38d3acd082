"""The gym: the training loop (port of ``repro.core.gym``, paper Fig. 1).

The resolved object graph (model, optimizer, loader, trackers) is injected;
the gym only drives the loop.  Hot-path notes, as in JAX: the loader is
wrapped in a :class:`PrefetchLoader` (a worker thread keeps the next
``prefetch`` batches on the device), and metrics stay on the device between
log points: one host fetch per ``log_every`` window, made one window late,
so the host never waits for the step it has just issued.  No ``.item()``
per step: that would serialize the host and the card.  Checkpoints route
through the async engine (:mod:`repro_torch.ckpt`): the loop pays for
issuing the device-to-host copies, serialization happens on a writer
thread.

Resilience (:mod:`repro_torch.resilience`, all optional), as in JAX: a
``sentinel`` inspects every flushed metric point and an anomaly rolls the
run back to the newest committed checkpoint strictly *before* the anomaly
step (metrics flush one window late, so the latest checkpoint may already
hold corrupted state); a ``preempt_guard`` turns SIGTERM into one final
synchronous checkpoint and a resumable exit; a ``fault_injector``
schedules deterministic failures through the same paths the real ones
take.  A ``profiler`` (:class:`repro_torch.telemetry.ProfilerHook`) traces
a window of steps.

With a ``telemetry`` recorder that records spans, ``run`` writes
``gym/run_enter`` (from its entry to the first data wait),
``gym/data_wait``, ``gym/step`` (holding the step's phases,
:mod:`repro_torch.telemetry.phases`: ``step/*`` on the host and, on a
card, ``device/*`` timed by events), ``gym/flush``, ``gym/ckpt`` and
``gym/run_exit`` (from the end of its steps' issue to its last read of the
step counter).

With a ``mesh`` (a ``DeviceMesh``, or a mesh provider the gym builds on its
device's type) and a sharding ``plan``, the train state is laid out by
``plans.train_state_shardings`` (params, moments and the counters as
DTensors; ``shard_warnings`` records the divisibility fallbacks), every
rank draws the loader's global batch and keeps its block
(``plans.batch_shardings``), and the step runs on DTensors.  Rank 0 alone
logs and writes checkpoints (``ckpt.engine``), as its processes' ``RANK``
says.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..data.prefetch import PrefetchLoader, place_batch
from ..device import resolve_device
from ..launch.mesh import process_rank
from ..sharding import plans as PL
from ..telemetry import phases as PH
from ..train import checkpoint as CK
from ..train import steps as ST


_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass
class Gym:
    model: Any
    optimizer: Any
    loader: Any
    mesh: Any = None                      # None => single device
    plan: Any = None
    seed: int = 0
    grad_accum: int = 1
    log_every: int = 10
    eval_every: int = 0
    ckpt_every: int = 0
    ckpt_dir: str = ""
    checkpointer: Any = None              # AsyncCheckpointer (default: async)
    run_fingerprint: str = ""             # stamped into manifests; checked on restore
    prefetch: int = 2                     # device-prefetch depth (0 = sync)
    eval_fn: Optional[Callable] = None
    logger: Optional[Callable[[Dict[str, Any]], None]] = None
    # -- resilience (see repro_torch.resilience; all optional) -------------
    sentinel: Any = None                  # StepSentinel: anomaly detection
    preempt_guard: Any = None             # PreemptionGuard: graceful SIGTERM
    fault_injector: Any = None            # FaultInjector: scheduled chaos
    max_rollbacks: int = 3                # anomaly rollbacks before fatal
    skip_window: bool = False             # skip the anomalous data window
    ckpt_retry: Any = None                # RetryPolicy for checkpoint IO
    # -- telemetry (see repro_torch.telemetry; both optional) --------------
    telemetry: Any = None                 # TelemetryRecorder (unified sink)
    profiler: Any = None                  # ProfilerHook (torch.profiler window)
    #: where the run trains: None is the card (``device.resolve_device``)
    device: Any = None
    #: set by ``setup``: the built mesh and the train state's layout
    _mesh = None
    _state_sh = None

    def setup(self):
        self._device = resolve_device(self.device)
        mesh = self.mesh
        if hasattr(mesh, "build"):
            mesh = mesh.build(self._device.type)
        self._mesh = mesh
        if mesh is not None and self.plan is None:
            raise ValueError("gym: a mesh needs a sharding plan to lay the "
                             "train state out")
        if mesh is not None:
            if self._device.type == "cuda":
                self._device = torch.device("cuda",
                                            torch.cuda.current_device())
            mesh_ctx = PL.mesh_context(self.plan, mesh)
            storage_axes = self.plan.ep_storage_axes if self.plan.ep else ()
            self._state_sh, self.shard_warnings = PL.train_state_shardings(
                self.plan, mesh, self.model, self.optimizer, seed=self.seed)
        else:
            mesh_ctx, storage_axes = None, ()
            self._state_sh, self.shard_warnings = None, []
        self.mesh_ctx = mesh_ctx
        self._batch_sh = None
        step_fn = self._build_step(mesh_ctx, storage_axes)
        self._step = lambda s, b: step_fn(s, self._lay_out(b),
                                          *self._step_extra_args())
        return self._init_state()

    def _init_state(self):
        """A fresh train state, seeded from ``seed`` on the gym's device —
        also the rollback fallback when no usable checkpoint predates an
        anomaly (the same generator, so the same init bit for bit).  Under
        a mesh every rank makes the same state and keeps its blocks."""
        gen = torch.Generator(device=self._device).manual_seed(self.seed)
        state = ST.init_train_state(self.model, self.optimizer, gen)
        if self._state_sh is not None:
            state = PL.distribute(state, self._state_sh)
        return state

    def _lay_out(self, batch):
        """A batch on the gym's device, laid out by the plan's batch
        shardings under a mesh (each rank keeps its rows of the global
        batch every rank drew)."""
        batch = place_batch(batch, self._device)
        if self._state_sh is None:
            return batch
        if self._batch_sh is None:
            self._batch_sh = PL.batch_shardings(self.plan, self._mesh, batch)
        return PL.distribute(batch, self._batch_sh)

    # -- subclass hooks ----------------------------------------------------
    # A Gym variant (e.g. a DPO gym) changes WHAT a step computes by
    # overriding these two; the loop, prefetch and metrics stay shared.
    def _build_step(self, mesh_ctx=None, storage_axes=()):
        """The (state, batch, *extras) -> (state, metrics) step function."""
        return ST.make_train_step(self.model, self.optimizer, mesh_ctx,
                                  storage_axes, grad_accum=self.grad_accum)

    def _step_extra_args(self) -> tuple:
        """Extra positional arguments appended to every step call."""
        return ()

    @property
    def n_dev(self) -> int:
        """The devices the step runs on: the mesh's size, else 1."""
        return 1 if self._mesh is None else self._mesh.size()

    # -- checkpointing -----------------------------------------------------
    def _ckpt(self):
        """The checkpointer this gym saves/restores through: the injected
        registry component, or a default async engine on ``ckpt_dir``."""
        ck = self.checkpointer
        if ck is None:
            if not self.ckpt_dir:
                return None
            from ..ckpt import AsyncCheckpointer

            ck = self.checkpointer = AsyncCheckpointer(self.ckpt_dir)
        # resilience knobs ride on the gym config; stamp them onto the
        # engine (injected registry checkpointers keep their own settings)
        if self.ckpt_retry is not None and ck.retry is None:
            ck.retry = self.ckpt_retry
        if self.fault_injector is not None and ck.fault_injector is None:
            ck.fault_injector = self.fault_injector
        return ck

    def save_policy(self, step: int) -> bool:
        """Does this step checkpoint? The ``ckpt_every`` knob (override for
        custom cadences — e.g. denser early saves)."""
        return bool(self.ckpt_every) and step % self.ckpt_every == 0

    def restore(self, state_like, source: str = "") -> Tuple[Any, Optional[int]]:
        """Restore the newest committed checkpoint (onto the device of
        ``state_like``'s leaves, this gym's after ``setup``).

        ``source`` may be a checkpoint directory (either format), one
        committed ``step_XXXXXXXX`` dir, or a legacy ``.npz`` file; empty
        means the gym's own ``ckpt_dir``.  Returns ``(state, step)`` —
        unchanged ``(state_like, None)`` when there is nothing to restore.
        A checkpoint stamped with another run fingerprint restores with a
        warning.
        """
        from ..ckpt import elastic as EL
        from ..ckpt import format as CF

        ck = self._ckpt()
        if ck is not None:
            ck.wait()  # queued saves must commit before "latest" is resolved
        src = source or self.ckpt_dir
        if not src:
            return state_like, None
        if os.path.isfile(src) or (os.path.isdir(src)
                                   and CF.is_committed(src)):
            path = src
        else:
            latest = CK.latest_checkpoint(src)
            if latest is None:
                return state_like, None
            path = latest[1]
        if os.path.isdir(path):
            saved_fp = CF.read_manifest(path).get("fingerprint", "")
            if saved_fp and self.run_fingerprint \
                    and saved_fp != self.run_fingerprint:
                # the checkpoint was written by a DIFFERENT resolved config
                warnings.warn(
                    f"restoring {path} saved under fingerprint "
                    f"{saved_fp[:22]}… into a run fingerprinted "
                    f"{self.run_fingerprint[:22]}… — the resolved configs "
                    f"differ", UserWarning, stacklevel=2)
            state = EL.restore(state_like, path, self._state_sh)
        else:
            state = CK.restore_checkpoint(state_like, path)
            if self._state_sh is not None:
                state = PL.distribute(state, self._state_sh)
        return state, int(state["step"])

    def _ckpt_extra(self) -> Optional[Dict[str, Any]]:
        """Manifest extras: the run fingerprint, so a restore can tell when
        a checkpoint came from a different resolved config."""
        if not self.run_fingerprint:
            return None
        return {"fingerprint": self.run_fingerprint}

    # -- input pipeline ----------------------------------------------------
    def _wrapped_loader(self):
        """The loader the loop drains: device prefetch unless disabled or
        the injected loader already prefetches.  A YAML-wired
        ``loader/prefetch`` knows no device: the loop drains a copy that
        carries the gym's (the shared component is not mutated)."""
        if isinstance(self.loader, PrefetchLoader):
            if self.loader.to_device and self.loader.device is None:
                return dataclasses.replace(self.loader, device=self._device)
            return self.loader
        if self.prefetch <= 0:
            return self.loader
        return PrefetchLoader(self.loader, depth=self.prefetch,
                              device=self._device)

    # -- training ----------------------------------------------------------
    def run(self, steps: int, state=None) -> Dict[str, Any]:
        """Train for ``steps`` steps.  Besides ``state``, the flushed
        metric ``history`` and the step counts, the result carries the
        resilience record: ``events`` (anomaly / rollback / preempt rows),
        ``rollbacks`` and ``preempted`` — all empty/zero/False on a clean
        run."""
        if state is None:
            state = self.setup()
        tel = self.telemetry
        do_spans = tel is not None and tel.spans
        t_enter = time.perf_counter()
        start = int(state["step"])
        # the card is idle after that read: the phases' anchor goes here
        phases = PH.StepPhases(tel, PH.cuda_events(self._device)) \
            if do_spans else None
        t_exit = None   # where the last segment's loop over steps ended
        target = start + steps
        history: List[Dict[str, Any]] = []
        events: List[Dict[str, Any]] = []
        rollbacks = 0
        preempted = False
        dispatched = 0   # every step the loop issued, replays included
        data_offset = 0  # grows when skip_window drops anomalous batches
        t_run0 = time.perf_counter()
        inj = self.fault_injector
        guard = self.preempt_guard
        if guard is None and inj is not None and inj.pending("preempt"):
            # an injected preemption needs a flag holder even when no real
            # signal handler was wired; same polling path as the real thing
            from ..resilience.preempt import PreemptionGuard

            guard = PreemptionGuard()

        ckpt = self._ckpt()
        rank0 = process_rank() == 0
        try:
            PH.set_current(phases)
            while True:
                current = int(state["step"])
                if target - current <= 0:
                    break
                pending: List[tuple] = []  # (step, device metrics, wall_s)

                def flush(pending=pending):
                    if not pending:
                        return
                    t_f0 = time.perf_counter()
                    last_step = pending[-1][0]
                    keys = list(pending[0][1])
                    # one device-to-host copy for the whole window
                    fetched = torch.stack(
                        [torch.stack([m[k].float() for k in keys])
                         for _, m, _ in pending]).cpu().tolist()
                    rows = [(step, wall, vals)
                            for (step, _, wall), vals in zip(pending, fetched)]
                    pending.clear()
                    for step, wall, vals in rows:
                        m = dict(zip(keys, vals))
                        if inj is not None and \
                                inj.fire("nan_loss", step) is not None:
                            m["loss"] = float("nan")
                        m["step"] = step
                        m["wall_s"] = wall
                        if tel is not None:
                            # telemetry sees the observation even when the
                            # sentinel is about to trip on it
                            tel.metric(step, {k: v for k, v in m.items()
                                              if k != "step"})
                        if self.sentinel is not None:
                            anomaly = self.sentinel.check(step, m)
                            if anomaly is not None:
                                raise _Rollback(anomaly)
                        history.append(m)
                        if self.logger and rank0:
                            self.logger(m)
                    if do_spans:
                        # the copy waited for the card: the phases' events
                        # are read here
                        phases.flush()
                        tel.span_row("gym/flush", t_f0, time.perf_counter(),
                                     step=last_step)

                batches = self._wrapped_loader().batches(
                    target - current, start_step=current + data_offset)
                stop_step = 0
                try:
                    it = iter(batches)
                    step = current
                    while True:
                        # manual next() so the host-side wait for data is
                        # its own span, apart from the step's dispatch
                        t_wait0 = time.perf_counter()
                        if do_spans and t_enter is not None:
                            # the run's entry ends at its first data wait
                            tel.span_row("gym/run_enter", t_enter, t_wait0,
                                         step=step + 1)
                            t_enter = None
                        try:
                            batch = next(it)
                        except StopIteration:
                            break
                        t_wait1 = time.perf_counter()
                        step += 1
                        if do_spans:
                            tel.span_row("gym/data_wait", t_wait0, t_wait1,
                                         step=step)
                            phases.step = step
                        with tel.span("gym/step", step=step) if do_spans \
                                else _NO_SPAN:
                            if self.profiler is not None:
                                self.profiler.step_begin(step)
                            if inj is not None and \
                                    inj.fire("nan_params", step) is not None:
                                state = inj.corrupt_params(state)
                            # a loader that does not prefetch yields host
                            # numpy
                            state, metrics = self._step(state, batch)
                        dispatched += 1
                        if self.log_every and (step % self.log_every == 0
                                               or step == start + 1):
                            # fetch the PREVIOUS window now (long since
                            # computed), stash the current one
                            flush()
                            pending.append((step, metrics,
                                            time.perf_counter() - t_run0))
                        if self.eval_every and self.eval_fn \
                                and step % self.eval_every == 0:
                            ev = self.eval_fn(self.model, state["params"])
                            row = {"step": step,
                                   **{f"eval_{k}": float(v)
                                      for k, v in ev.items()}}
                            history.append(row)
                            if tel is not None:
                                tel.metric(step, {k: v for k, v in row.items()
                                                  if k != "step"})
                            if self.logger and rank0:
                                self.logger(row)
                        if ckpt is not None and self.save_policy(step):
                            # the copies are queued on the stream before the
                            # next step's in-place updates; serialization
                            # runs on the writer thread
                            t_ck0 = time.perf_counter()
                            ckpt.save(state, step, extra=self._ckpt_extra())
                            if do_spans:
                                tel.span_row("gym/ckpt", t_ck0,
                                             time.perf_counter(), step=step)
                        if self.profiler is not None:
                            self.profiler.step_end(step)
                        if inj is not None and \
                                inj.fire("preempt", step) is not None:
                            guard.request()
                        if guard is not None and guard.requested:
                            stop_step = step
                            break
                    t_exit = time.perf_counter()
                    flush()
                except _Rollback as rb:
                    # the loop lets go of the corrupted tensors before the
                    # restore allocates their replacements
                    like = _meta_like(state)
                    state = metrics = None
                    state, data_offset, rollbacks = self._rollback(
                        like, rb.event, events, history, data_offset,
                        rollbacks, ckpt)
                    continue
                finally:
                    close = getattr(batches, "close", None)
                    if callable(close):
                        close()  # stop an abandoned prefetch worker
                if stop_step:
                    # graceful preemption: one synchronous final save at the
                    # step boundary, then exit resumable
                    if ckpt is not None:
                        ckpt.save(state, stop_step, extra=self._ckpt_extra())
                        ckpt.wait()
                    events.append(guard.event(stop_step))
                    if tel is not None:
                        tel.event("preempt", step=stop_step)
                    if self.logger and rank0:
                        self.logger({"step": stop_step, "event": "preempt"})
                    preempted = True
                    guard.clear()
                break
        finally:
            PH.set_current(None)
            if self.profiler is not None:
                self.profiler.close()
            if ckpt is not None:
                # the run's last checkpoint must be committed and the writer
                # thread must not outlive the run, even when the loop raised
                ckpt.close()
        final_step = int(state["step"])
        if do_spans and t_exit is not None:
            phases.flush()
            tel.span_row("gym/run_exit", t_exit, time.perf_counter(),
                         step=final_step)
        return {"state": state, "history": history, "events": events,
                "rollbacks": rollbacks, "preempted": preempted,
                "steps_dispatched": dispatched,
                "productive_steps": max(0, final_step - start)}

    # -- benchmarking ------------------------------------------------------
    def bench(self, steps: int = 20, warmup: int = 3,
              windows: int = 5) -> Dict[str, Any]:
        """Measure the hot path: the first step's time, steady-state step
        time, tokens/sec and modeled MFU.  The one timing implementation
        behind the ``bench`` run kind (``python -m repro_torch bench``),
        with JAX's steps, windows and result keys.

        The ``steps`` are split into ``windows`` synchronized windows and
        ``steady_step_ms`` is the median of the per-window step times: one
        hiccup of the host clock skews one window, not the figure.  The
        card is synchronized after the first step, after the warm-up and at
        each window's end; inside a window the metrics stay on the device.
        ``compile_s`` keeps JAX's name for the first step's time: the port
        traces nothing, so it holds the lazy load of the kernel libraries
        (and their build when the build directory is cold), cuBLAS and the
        allocator's warm-up.  Exactly ``1 + warmup + steps`` batches are
        drawn; the prefetch worker is stopped before returning.
        """
        import statistics

        from ..telemetry import accounting as ACC

        t0 = time.perf_counter()
        state = self.setup()
        setup_s = time.perf_counter() - t0
        start = int(state["step"])
        tel = self.telemetry
        dev = self._device
        n_w = max(1, min(int(windows), steps))
        base, rem = divmod(steps, n_w)
        sizes = [base + (1 if w < rem else 0) for w in range(n_w)]
        sizes = [s for s in sizes if s > 0]

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def step(state):
            return self._step(state, next(it))

        batches = self._wrapped_loader().batches(1 + warmup + steps,
                                                 start_step=start)
        try:
            it = iter(batches)
            t0 = time.perf_counter()
            state, m = step(state)
            sync()
            compile_s = time.perf_counter() - t0  # first call: loads + run
            for _ in range(warmup):
                state, m = step(state)
            sync()
            window_rows: List[Dict[str, Any]] = []
            for k in sizes:
                tw0 = time.perf_counter()
                for _ in range(k):
                    state, m = step(state)
                sync()
                tw1 = time.perf_counter()
                window_rows.append({"steps": k, "wall_s": round(tw1 - tw0, 6),
                                    "step_ms": round((tw1 - tw0) / k * 1000,
                                                     3)})
                if tel is not None:
                    tel.metric(len(window_rows),
                               {"bench_step_ms": window_rows[-1]["step_ms"],
                                "bench_window_steps": k},
                               phase="bench_window")
        finally:
            close = getattr(batches, "close", None)
            if callable(close):
                close()  # stop the prefetch worker
        wall = sum(r["wall_s"] for r in window_rows)
        steady_ms = statistics.median(r["step_ms"] for r in window_rows)
        loss = float(m["loss"] if "loss" in m else m["ce"])
        result = {
            "steps": steps,
            "warmup": warmup,
            "setup_s": round(setup_s, 3),
            "compile_s": round(compile_s, 3),
            "steady_step_ms": round(steady_ms, 3),
            "steady_step_ms_mean": round(wall / steps * 1000, 3),
            "windows": window_rows,
            "steps_per_s": round(steps / wall, 3) if wall > 0 else 0.0,
            "final_loss": round(loss, 6),
            "prefetch": self.prefetch,
            "grad_accum": self.grad_accum,
            # a clean bench dispatches every step productively by
            # construction (no rollback/preempt paths): goodput is 1.0
            "goodput": 1.0,
            "steps_dispatched": steps,
            "rollback_count": 0,
            "retry_count": int(getattr(self.checkpointer,
                                       "retry_count", 0) or 0),
            "graceful_exit": False,
        }
        flops = ACC.flops_per_train_step(self.model, self.loader,
                                         self.grad_accum)
        if flops:
            result["model_flops_per_step"] = flops
            result["mfu"] = ACC.mfu(flops, steady_ms / 1000.0, self.n_dev)
        gb = getattr(self.loader, "global_batch", None)
        seq = getattr(getattr(self.loader, "dataset", None), "seq_len", None)
        if gb and seq:
            result["global_batch"] = int(gb)
            result["seq_len"] = int(seq)
            result["tokens_per_s"] = int(gb * seq / (steady_ms / 1000.0)) \
                if steady_ms > 0 else 0
        if self.plan is not None and hasattr(self.plan, "describe"):
            result["plan"] = self.plan.describe()
            result["pipeline"] = PL.pipeline_info(
                self.plan, self._mesh,
                int(getattr(self.loader, "global_batch", 0) or 0))
        if tel is not None:
            tel.metric(None, {"steady_step_ms": result["steady_step_ms"],
                              "mfu": result.get("mfu"),
                              "tokens_per_s": result.get("tokens_per_s"),
                              "goodput": 1.0}, phase="bench_summary")
        return result

    def _rollback(self, like, event, events, history, data_offset,
                  rollbacks, ckpt):
        """Recover from an anomaly: restore the newest committed checkpoint
        strictly BEFORE the anomaly step (detection lags one metrics
        window, so a checkpoint at/after it may hold corrupted state) into
        the structure of ``like`` (the train state's tree on ``meta``),
        falling back to a fresh seed init.  Checkpoints at/after the
        anomaly are deleted — they must never win a later "latest"
        resolution.  Returns the new ``(state, data_offset, rollbacks)``."""
        from ..ckpt import elastic as EL
        from ..ckpt import format as CF
        from ..resilience.sentinel import AnomalyError

        anomaly_step = int(event["step"])
        rollbacks += 1
        if rollbacks > self.max_rollbacks:
            events.append(dict(event, rollbacks=rollbacks, fatal=True))
            raise AnomalyError(
                f"anomaly at step {anomaly_step} ({event.get('reason')}): "
                f"rollback budget ({self.max_rollbacks}) exhausted", event)
        if ckpt is not None:
            ckpt.wait()  # in-flight saves must commit before we pick one
        ckpt_dir = getattr(ckpt, "ckpt_dir", "") or self.ckpt_dir
        ckpts = CF.list_checkpoints(ckpt_dir) if ckpt_dir else []
        candidates = [(s, p) for s, p in ckpts if s < anomaly_step]
        if candidates:
            restored_step, path = max(candidates)
            state = EL.restore(like, path, self._state_sh,
                               device=self._device)
        else:
            state = self._init_state()
            restored_step = int(state["step"])
        for s, p in ckpts:
            if s >= anomaly_step:
                shutil.rmtree(p, ignore_errors=True)
        history[:] = [m for m in history if m["step"] <= restored_step]
        if self.sentinel is not None:
            self.sentinel.reset()  # replayed steps re-observe their values
        if self.skip_window:
            data_offset += anomaly_step - restored_step
        events.append(dict(event, rollbacks=rollbacks,
                           restored_step=restored_step,
                           data_offset=data_offset))
        if self.telemetry is not None:
            self.telemetry.event("rollback", step=anomaly_step,
                                 reason=event.get("reason"),
                                 restored_step=restored_step,
                                 rollbacks=rollbacks)
        if self.logger and process_rank() == 0:
            self.logger({"step": anomaly_step, "event": "rollback",
                         "reason": event.get("reason"),
                         "restored_step": restored_step})
        return state, data_offset, rollbacks


class _Rollback(Exception):
    """Internal control flow: the sentinel tripped mid-flush; unwind the
    current segment so :meth:`Gym._rollback` can restore and replay."""

    def __init__(self, event: Dict[str, Any]):
        super().__init__(event.get("reason", "anomaly"))
        self.event = event


def _meta_like(tree):
    """``tree`` with each tensor replaced by an empty one of its shape and
    dtype on ``meta``: the structure a restore fills."""
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
