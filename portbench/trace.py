"""What a traced run reads from ``torch.profiler``: the device's busy
intervals and its kernels by name, on the host clock.

``profile(fn)`` runs ``fn`` between two synchronisations of the card under
``torch.profiler`` with CUDA activity alone: recording every CPU-side op
as well would double the host's time to issue a step, and these steps are
paced by it.  The trace's timestamps (wall-clock nanoseconds) are mapped
onto ``time.perf_counter`` through the two clocks read together as the
trace opens, so device intervals line up with the program's spans.  The
raw events are read without building the profiler's per-op tables.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

Interval = Tuple[str, float, float]


def profile(fn, device) -> Dict[str, Any]:
    """Run ``fn()`` under the profiler.  Returns ``t0``/``t1`` (the
    window, perf_counter seconds), ``device_events`` [(name, start, end)]
    and ``busy_s``, the union of the device intervals inside the window
    (None where the trace holds no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    a = time.perf_counter()
    wall = time.time_ns() * 1e-9
    t0 = time.perf_counter()
    offset = wall - 0.5 * (a + t0)
    fn()
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof.stop()
    dev: List[Interval] = [
        (e.name(), e.start_ns() * 1e-9 - offset, e.end_ns() * 1e-9 - offset)
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA]
    dev.sort(key=lambda x: x[1])
    return {"t0": t0, "t1": t1, "device_events": dev,
            "busy_s": busy(dev, t0, t1) if dev else None}


def merged(intervals: List[Interval], t0: float, t1: float):
    """The union of the intervals, clipped to [t0, t1], as sorted
    (start, end) pairs."""
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(intervals: List[Interval], t0: float, t1: float) -> float:
    return sum(b - a for a, b in merged(intervals, t0, t1))


def idle_gaps(intervals: List[Interval], t0: float, t1: float):
    """(start, end) of each stretch of the window with nothing on the
    device."""
    gaps, at = [], t0
    for a, b in merged(intervals, t0, t1):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def breakdown(prof: Dict[str, Any], spans, top: int = 10) -> Dict[str, Any]:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost program span the host was in at the gap's
    middle (``spans``: (name, t0, t1, step) on perf_counter)."""
    by_name: Dict[str, float] = {}
    for name, a, b in prof["device_events"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    for a, b in idle_gaps(prof["device_events"], prof["t0"], prof["t1"]):
        mid = 0.5 * (a + b)
        inside = [s for s in spans if s[1] <= mid <= s[2]]
        if inside:
            s = min(inside, key=lambda s: s[2] - s[1])
            label = f"{s[0]} (step {s[3]})" if s[3] is not None else s[0]
        else:
            label = "outside the gym's spans"
        gaps.append((label, b - a))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[_short(n), s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def kernel_time(prof: Optional[Dict[str, Any]], names) -> Tuple[int, float]:
    """(launches, summed device seconds) of the kernels whose name holds
    any of ``names``."""
    if not prof:
        return 0, 0.0
    n, t = 0, 0.0
    for name, a, b in prof["device_events"]:
        if any(k in name for k in names):
            n += 1
            t += b - a
    return n, t
