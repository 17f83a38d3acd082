"""Profiler hook: wrap a configured window of gym steps in
``torch.profiler`` and record the trace's path as telemetry (port of
``repro.telemetry.profiler``, which wraps ``jax.profiler.trace``).

Configured declaratively on the run API:

    telemetry:
      profile: {start_step: 5, num_steps: 2}

The hook is step-driven (``step_begin``/``step_end`` from the gym loop),
so it composes with resume and warmstart: a run resumed past
``start_step`` starts tracing at its first executed step at or beyond it.
It records CPU activity, and CUDA activity when the run is on the card;
there the window opens and closes on a synchronized device, so the trace
holds the window's kernels and only them.  The chrome trace lands in
``out_dir``.  Profiler failures are recorded as an ``event`` row and never
fail the run.
"""
from __future__ import annotations

import os
from typing import Optional


class ProfilerHook:
    def __init__(self, start_step: int, num_steps: int, out_dir: str,
                 recorder=None, log=None, device=None) -> None:
        self.start_step = max(1, int(start_step))
        self.num_steps = max(1, int(num_steps))
        self.out_dir = str(out_dir)
        self.recorder = recorder
        self.log = log
        self.cuda = device is not None and str(device).startswith("cuda")
        self.active = False
        self.done = False
        self.artifact: Optional[str] = None   # the chrome trace's path
        self.error = ""
        self._stop_after = 0
        self._start = 0
        self._prof = None

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def step_begin(self, step: int) -> None:
        if self.done or self.active or step < self.start_step:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            self._sync()
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:  # a build or host without profiler support
            self.done = True
            self.error = f"{type(e).__name__}: {e}"
            if self.recorder is not None:
                self.recorder.event("profile_error", step=step,
                                    error=self.error)
            if self.log:
                self.log(f"[telemetry] profiler unavailable: {self.error}")
            return
        self._prof = prof
        self.active = True
        self._start = step
        self._stop_after = step + self.num_steps - 1
        if self.recorder is not None:
            self.recorder.event("profile_start", step=step,
                                path=self.out_dir)

    def step_end(self, step: int) -> None:
        if not self.active or step < self._stop_after:
            return
        self._stop()
        if self.recorder is not None:
            self.recorder.event("profile_stop", step=step,
                                path=self.out_dir)

    def close(self) -> None:
        """Stop an open trace (preemption/rollback ended the run early)."""
        if self.active:
            self._stop()

    def _stop(self) -> None:
        path = os.path.join(self.out_dir, f"trace_step{self._start}.json")
        try:
            self._sync()
            self._prof.stop()
            self._prof.export_chrome_trace(path)
            self.artifact = path
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
        self._prof = None
        self.active = False
        self.done = True
