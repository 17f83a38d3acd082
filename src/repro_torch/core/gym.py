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

This slice trains on one device.  The mesh and sharding plan (ROADMAP A8),
resilience (rollback, preemption, retries and fault injection) and the
profiler (A5) are refused where they are configured
(``core/components.py``, ``run/config.py``).
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..data.prefetch import PrefetchLoader, place_batch
from ..device import resolve_device
from ..train import checkpoint as CK
from ..train import steps as ST


@dataclasses.dataclass
class Gym:
    model: Any
    optimizer: Any
    loader: Any
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
    telemetry: Any = None                 # TelemetryRecorder (unified sink)
    #: where the run trains: None is the card (``device.resolve_device``)
    device: Any = None

    def setup(self):
        self._device = resolve_device(self.device)
        step_fn = self._build_step()
        self._step = lambda s, b: step_fn(s, b, *self._step_extra_args())
        return self._init_state()

    def _init_state(self):
        """A fresh train state, seeded from ``seed`` on the gym's device."""
        gen = torch.Generator(device=self._device).manual_seed(self.seed)
        return ST.init_train_state(self.model, self.optimizer, gen)

    # -- subclass hooks ----------------------------------------------------
    # A Gym variant (e.g. a DPO gym) changes WHAT a step computes by
    # overriding these two; the loop, prefetch and metrics stay shared.
    def _build_step(self):
        """The (state, batch, *extras) -> (state, metrics) step function."""
        return ST.make_train_step(self.model, self.optimizer,
                                  grad_accum=self.grad_accum)

    def _step_extra_args(self) -> tuple:
        """Extra positional arguments appended to every step call."""
        return ()

    # -- checkpointing -----------------------------------------------------
    def _ckpt(self):
        """The checkpointer this gym saves/restores through: the injected
        registry component, or a default async engine on ``ckpt_dir``."""
        if self.checkpointer is None and self.ckpt_dir:
            from ..ckpt import AsyncCheckpointer

            self.checkpointer = AsyncCheckpointer(self.ckpt_dir)
        return self.checkpointer

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
            state = EL.restore(state_like, path)
        else:
            state = CK.restore_checkpoint(state_like, path)
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
        """Train for ``steps`` steps; returns the state, the flushed metric
        ``history`` and the step counts."""
        if state is None:
            state = self.setup()
        start = int(state["step"])
        history: List[Dict[str, Any]] = []
        pending: List[tuple] = []  # (step, device metrics, wall_s)
        dispatched = 0
        t_run0 = time.perf_counter()
        tel = self.telemetry
        do_spans = tel is not None and tel.spans

        def flush():
            if not pending:
                return
            t_f0 = time.perf_counter()
            last_step = pending[-1][0]
            keys = list(pending[0][1])
            # one device-to-host copy for the whole window
            fetched = torch.stack([torch.stack([m[k].float() for k in keys])
                                   for _, m, _ in pending]).cpu().tolist()
            rows = [(step, wall, vals)
                    for (step, _, wall), vals in zip(pending, fetched)]
            pending.clear()
            for step, wall, vals in rows:
                m = dict(zip(keys, vals))
                m["step"] = step
                m["wall_s"] = wall
                if tel is not None:
                    tel.metric(step, {k: v for k, v in m.items()
                                      if k != "step"})
                history.append(m)
                if self.logger:
                    self.logger(m)
            if do_spans:
                tel.span_row("gym/flush", t_f0, time.perf_counter(),
                             step=last_step)

        ckpt = self._ckpt()
        batches = self._wrapped_loader().batches(steps, start_step=start)
        try:
            it = iter(batches)
            step = start
            while True:
                # manual next() so the host-side wait for data is its own
                # span, apart from the step's dispatch
                t_wait0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t_wait1 = time.perf_counter()
                step += 1
                # a loader that does not prefetch yields host numpy
                state, metrics = self._step(state,
                                            place_batch(batch, self._device))
                dispatched += 1
                if do_spans:
                    t_disp = time.perf_counter()
                    tel.span_row("gym/data_wait", t_wait0, t_wait1, step=step)
                    tel.span_row("gym/step", t_wait1, t_disp, step=step)
                if self.log_every and (step % self.log_every == 0
                                       or step == start + 1):
                    # fetch the PREVIOUS window now (long since computed),
                    # stash the current one
                    flush()
                    pending.append((step, metrics,
                                    time.perf_counter() - t_run0))
                if self.eval_every and self.eval_fn \
                        and step % self.eval_every == 0:
                    ev = self.eval_fn(self.model, state["params"])
                    row = {"step": step,
                           **{f"eval_{k}": float(v) for k, v in ev.items()}}
                    history.append(row)
                    if tel is not None:
                        tel.metric(step, {k: v for k, v in row.items()
                                          if k != "step"})
                    if self.logger:
                        self.logger(row)
                if ckpt is not None and self.save_policy(step):
                    # the copies are queued on the stream before the next
                    # step's in-place updates; serialization runs on the
                    # writer thread
                    t_ck0 = time.perf_counter()
                    ckpt.save(state, step, extra=self._ckpt_extra())
                    if do_spans:
                        tel.span_row("gym/ckpt", t_ck0, time.perf_counter(),
                                     step=step)
            flush()
        finally:
            close = getattr(batches, "close", None)
            if callable(close):
                close()  # stop an abandoned prefetch worker
            if ckpt is not None:
                # the run's last checkpoint must be committed and the writer
                # thread must not outlive the run, even when the loop raised
                ckpt.close()
        final_step = int(state["step"])
        return {"state": state, "history": history,
                "steps_dispatched": dispatched,
                "productive_steps": max(0, final_step - start)}
