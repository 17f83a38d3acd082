"""The async checkpoint engine (port of ``repro.ckpt.engine``): keep the
train step hot while saving.

``AsyncCheckpointer.save(state, step)`` does the minimum on the caller's
thread: it issues every leaf's device-to-host copy into a host buffer
(``non_blocking`` into pinned memory for a CUDA leaf) on the current stream
and records one CUDA event after them, without a full synchronize.  A
single writer thread waits on that event, then serializes the buffers and
commits them (atomic, see :mod:`.format`); a :class:`RetentionPolicy`
prunes committed checkpoints after each save.

The port's train step updates the params and the optimizer state in place
(``AdamW.update``), so the step after a save writes into the storage the
snapshot reads.  Stream order makes that safe: the copies are queued
before the next step's kernels.  JAX's snapshot is complete when ``save``
returns; here it is complete when the event is.

The host buffers are views into one flat host allocation per
checkpointer (pinned when a leaf is on a CUDA device), kept across
saves.  They are
never refilled while the writer still reads them: a ``save`` first waits
for the previous write to commit.  So at most one save is in flight, and
the set costs one train state of host memory.

Under a mesh (DTensor leaves) ``save`` gathers one leaf at a time to its
full tensor (a collective: every rank calls ``save`` at the same step),
copies it into rank 0's host buffer and frees it before the next, so a
card holds one unsharded leaf at most; it records each leaf's spec
(``format.spec_text``).  Only rank 0 keeps host buffers: it alone writes
and prunes, and ``wait`` holds every rank until rank 0's writes are
committed.

Writer failures are re-raised on the next ``save``/``check``/``wait``/
``close`` call — a checkpoint that silently failed to commit must not look
like progress — and raising *clears* the latched errors, so the
checkpointer stays usable.  ``background=False`` is the synchronous
variant: the same format and retention, the write on the caller's thread.
With a ``retry`` policy (:class:`repro_torch.resilience.RetryPolicy`)
transient write failures are absorbed on the writer thread before they
ever latch; ``retry_count`` counts the attempts retried.  A retried write
still holds the host buffers, and the next ``save`` waits for it.  A
``fault_injector`` (:class:`repro_torch.resilience.FaultInjector`) raises
scheduled ``ckpt_io`` OSErrors inside the write.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..launch.mesh import process_rank
from . import elastic as E
from . import format as F


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """Which committed checkpoints survive a prune.

    ``keep_last``: the N newest always survive (0 = unlimited).
    ``keep_every``: checkpoints whose step is a multiple survive forever
    (0 = none are permanent) — the "milestone" rule.
    """

    keep_last: int = 3
    keep_every: int = 0

    def survivors(self, steps) -> set:
        steps = sorted(steps)
        keep = set(steps[-self.keep_last:] if self.keep_last else steps)
        if self.keep_every:
            keep.update(s for s in steps if s % self.keep_every == 0)
        return keep


@dataclasses.dataclass
class AsyncCheckpointer:
    """Atomic, retained checkpoint saves off the hot path.

    ``saves`` records each committed save: its ``step``, the caller's
    ``stall_s`` in ``save`` (of which ``alloc_s`` went to allocating the
    host buffers, on the first save of a layout), the writer's ``write_s``
    (waiting for the copies included) and the ``bytes`` it wrote.
    """

    ckpt_dir: str
    retention: RetentionPolicy = dataclasses.field(default_factory=RetentionPolicy)
    background: bool = True
    retry: Any = None                 # Optional[resilience.RetryPolicy]
    fault_injector: Any = None        # Optional[resilience.FaultInjector]

    def __post_init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        self._errors: list = []
        self._lock = threading.Lock()
        self._layout: list = []
        self._host: Dict[str, torch.Tensor] = {}
        self._alloc_s = 0.0
        self._retries = 0
        self.specs: Dict[str, Any] = {}
        self.saves: List[Dict[str, Any]] = []

    @property
    def retry_count(self) -> int:
        """How many write attempts were absorbed by the retry policy."""
        return self._retries

    # -- snapshot (caller thread, hot path) ---------------------------------
    def _buffers(self, flat) -> Dict[str, torch.Tensor]:
        """Host buffers for ``flat``'s leaves, (re)allocated when the
        layout changes: views into one flat byte buffer, each at an offset
        aligned for its dtype."""
        layout = [(k, tuple(v.shape), v.dtype, v.device.type == "cuda")
                  for k, v in flat]
        if layout != self._layout:
            t0 = time.perf_counter()
            offsets, total = [], 0
            for _, shape, dtype, _ in layout:
                offsets.append(total)
                nbytes = math.prod(shape) * dtype.itemsize
                total += -(-nbytes // 64) * 64
            buf = torch.empty(total, dtype=torch.uint8,
                              pin_memory=any(c for *_, c in layout))
            self._host = {
                k: buf[o:o + math.prod(shape) * dtype.itemsize]
                .view(dtype).view(shape)
                for (k, shape, dtype, _), o in zip(layout, offsets)}
            self._layout = layout
            self._alloc_s = time.perf_counter() - t0
        return self._host

    def snapshot(self, state) -> Tuple[Dict[str, torch.Tensor],
                                       Optional[torch.cuda.Event]]:
        """Device tree -> (host buffers by tree key, in JAX's flatten order;
        the CUDA event the copies complete at, None when no leaf is on a
        CUDA device).  Issues every copy before waiting on any.  A DTensor
        leaf is gathered to its full tensor just before its copy, and the
        gathered tensor is dropped before the next gather (the allocator
        reuses its memory in stream order, after the copy).  Ranks other
        than 0 join the gathers and keep nothing: their buffers are ``{}``.
        The specs are kept in ``self.specs`` for the manifest."""
        flat = [(k, v.detach()) for k, v in F.flatten_with_paths(state)]
        self.specs = {k: F.spec_text(v) for k, v in flat}
        writer = process_rank() == 0
        host = self._buffers(flat) if writer else {}
        on_cuda = False
        for key, leaf in flat:
            if self.specs[key] is not None:
                leaf = leaf.full_tensor()
            if not writer:
                continue
            cuda = leaf.device.type == "cuda"
            host[key].copy_(leaf, non_blocking=cuda)
            on_cuda |= cuda
        ready = None
        if on_cuda:
            ready = torch.cuda.Event()
            ready.record()
        return dict(host), ready

    # -- save ---------------------------------------------------------------
    def save(self, state, step: int, extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot now; serialize and commit in the background."""
        t0 = time.perf_counter()
        self._drain()            # the writer must be done with the buffers
        self.check()
        self._alloc_s = 0.0
        arrays, ready = self.snapshot(state)
        timing = {"stall_s": time.perf_counter() - t0,
                  "alloc_s": self._alloc_s}
        if process_rank() != 0:
            return   # this rank took part in the gathers; rank 0 writes
        specs = dict(self.specs)
        if not self.background:
            self._write(int(step), arrays, ready, extra, timing, specs)
            return
        self._ensure_worker()
        self._q.put((int(step), arrays, ready, extra, timing, specs))

    def _ensure_worker(self):
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run_writer, daemon=True,
                    name="repro-torch-ckpt-writer")
                self._worker.start()

    def _run_writer(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except BaseException as e:
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, arrays, ready, extra, timing, specs=None):
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()

        def attempt():
            if self.fault_injector is not None:
                spec = self.fault_injector.fire("ckpt_io")
                if spec is not None:
                    raise OSError(f"injected ckpt_io fault "
                                  f"(step {step}, firing {spec._fired})")
            F.write_checkpoint(self.ckpt_dir, step, arrays, specs, extra)

        if self.retry is None:
            attempt()
        else:
            from ..resilience.retry import call_with_retry

            def count(attempt_n, exc):
                self._retries += 1

            call_with_retry(attempt, policy=self.retry, on_retry=count)
        self.saves.append({
            "step": step, **timing,
            "write_s": time.perf_counter() - t0,
            "bytes": sum(a.numel() * a.element_size()
                         for a in arrays.values())})
        self.prune()

    # -- lifecycle ----------------------------------------------------------
    def _drain(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            self._q.join()

    def wait(self) -> None:
        """Block until every queued save is committed; re-raise failures.
        Every rank of a multi-rank group waits for rank 0's commits."""
        self._drain()
        self.check()
        _barrier()

    def check(self) -> None:
        """Surface any background write failure on the caller's thread.

        Raising CLEARS the latch: the worker thread is still alive and the
        queue drained, so after handling the error the checkpointer is
        reusable — a later successful save must not re-raise a stale
        failure (one raise per failure burst, the first error of it)."""
        if self._errors:
            first, rest = self._errors[0], self._errors[1:]
            self._errors.clear()
            if rest:
                first.__notes__ = getattr(first, "__notes__", []) + [
                    f"(+{len(rest)} further queued save failure(s) cleared)"]
            raise first

    def close(self) -> None:
        """Drain, stop the writer thread, then surface any failure — the
        thread is shut down even when a queued write errored."""
        if self._worker is not None and self._worker.is_alive():
            self._q.join()
            self._q.put(None)
            self._worker.join(timeout=10.0)
        self._worker = None
        self.check()

    # -- retention / discovery ----------------------------------------------
    def prune(self) -> int:
        """Apply the retention policy; returns how many dirs were removed."""
        ckpts = F.list_checkpoints(self.ckpt_dir)
        keep = self.retention.survivors([s for s, _ in ckpts])
        n = F.sweep_aborted(self.ckpt_dir)
        for step, path in ckpts:
            if step not in keep:
                shutil.rmtree(path, ignore_errors=True)
                n += 1
        return n

    def latest(self) -> Optional[Tuple[int, str]]:
        return F.latest_checkpoint(self.ckpt_dir)

    # -- restore --------------------------------------------------------------
    def restore(self, state_like, shardings: Any = None,
                path: Optional[str] = None, device=None, **kw):
        """Restore the latest committed checkpoint (or ``path``) into
        ``state_like``'s structure on ``device``: the card unless the caller
        asks for the CPU (see :func:`repro_torch.ckpt.elastic.restore`)."""
        dev = resolve_device(device)
        self.wait()
        return E.restore(state_like, path or self.ckpt_dir, shardings,
                         device=dev, **kw)


def _barrier() -> None:
    """All ranks of a multi-rank default group meet here (no-op alone)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()
