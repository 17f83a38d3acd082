"""Async input pipeline (port of ``repro.data.prefetch``): a background
thread keeps the next ``depth`` batches on the device, so host-side batch
assembly and the host-to-device copy overlap the step.

``PrefetchLoader`` wraps any loader with ``batches(steps, start_step)``
yielding numpy dict batches.  The worker thread turns each batch into
tensors and, for a CUDA device, copies them from pinned host memory with
``non_blocking`` copies on a side stream; the consumer makes its stream wait
for that stream and calls ``record_stream`` on each tensor, so the caching
allocator does not hand the memory out again while the step still reads it.
Batch identity and order are exactly the inner loader's, including resume
through ``start_step``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

_DONE = object()


def place_batch(batch: Dict[str, Any], device: torch.device,
                stream: Optional["torch.cuda.Stream"] = None) -> Dict[str, Any]:
    """Numpy (or tensor) batch -> tensors on ``device``.  For a CUDA device
    the copies from the host come from pinned memory, ``non_blocking``,
    issued on ``stream`` (the current stream when None); a tensor already
    on the device is returned as it is."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext():
                t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


@dataclasses.dataclass
class PrefetchLoader:
    """Device-prefetching wrapper around a loader.

    ``depth`` is how many batches may wait ahead of the step; ``device`` is
    where they go (the gym fills it in from its own device when None);
    ``to_device=False`` keeps the batches on the host (prefetch of the host
    assembly only, numpy batches out).
    """

    loader: Any
    depth: int = 2
    to_device: bool = True
    device: Optional[torch.device] = None

    def batches(self, steps: int, start_step: int = 0) -> Iterator[dict]:
        place, receive = self._placer()
        if self.depth <= 0:
            for batch in self.loader.batches(steps, start_step=start_step):
                yield receive(place(batch))
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: list = []

        def worker():
            try:
                for batch in self.loader.batches(steps, start_step=start_step):
                    item = place(batch)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(_DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True,
                             name="repro-torch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                yield receive(item)
        finally:
            stop.set()
            t.join(timeout=5.0)
        if err:
            raise err[0]

    def _placer(self):
        """Per-``batches()`` (place, receive) pair: host numpy as is, else
        tensors on the device; a CUDA device gets a side stream for the
        copies, and ``receive`` orders the consumer's stream after them."""
        if not self.to_device:
            return (lambda batch: batch), (lambda batch: batch)
        if self.device is None:
            raise ValueError("PrefetchLoader: no device (the gym sets it; "
                             "pass device= when used on its own)")
        device = torch.device(self.device)
        if device.type != "cuda":
            return (lambda batch: place_batch(batch, device)), \
                (lambda batch: batch)
        stream = torch.cuda.Stream(device)

        def receive(batch):
            current = torch.cuda.current_stream(device)
            current.wait_stream(stream)
            for t in batch.values():
                t.record_stream(current)
            return batch

        return (lambda batch: place_batch(batch, device, stream)), receive

    # pass-throughs so token accounting sees the wrapped loader's geometry
    @property
    def global_batch(self) -> Optional[int]:
        return getattr(self.loader, "global_batch", None)

    @property
    def dataset(self) -> Any:
        return getattr(self.loader, "dataset", None)

