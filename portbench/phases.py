"""The train step's phases on the card, as a traced run records them.

The program marks each step's forward, backward, optimizer and the SSD's
recompute backward with timing events on the card, written as
``device/<phase>`` spans on the host clock (``repro_torch.telemetry.
phases``).  :func:`ms_per_step` is what the ``*_device_ms.train`` readers
report.  Run as a module, one traced run of a cell also checks the spans
against the profiler's kernels:

    python3 -m portbench.phases --workload <cell> --seed <n> --seconds <s>

It prints, for the window, each phase's mean ms a step and the share of
the window's seconds a step that forward, backward and optimizer cover;
for the traced chunk, the kernel farthest outside every forward, backward
and optimizer span (memory copies and sets left out), the same share, and
for each phase the share of it the card was busy, its launches and its
heaviest kernels.  On the card alone, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import bisect
import subprocess
import sys
from typing import Dict, Optional

from .trace import merged

#: the step's phases that cover it, in order
STEP_PHASES = ("device/forward", "device/backward", "device/optimizer")


def ms_per_step(run, name: str) -> Optional[float]:
    """The summed ``name`` spans of a step inside the window, as a mean
    over the window's steps, in ms; None where there is none."""
    w = run["window"]
    per_step: Dict[int, float] = {}
    for n, t0, t1, step in run["spans"]:
        if n == name and w["t0"] <= t0 and t1 <= w["t1"]:
            per_step[step] = per_step.get(step, 0.0) + (t1 - t0)
    return 1e3 * sum(per_step.values()) / len(per_step) if per_step else None


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _covered(merged_busy, a: float, b: float) -> float:
    """Seconds of ``[a, b]`` that the sorted, disjoint busy intervals
    cover."""
    i = bisect.bisect_right([e for _, e in merged_busy], a)
    t = 0.0
    while i < len(merged_busy) and merged_busy[i][0] < b:
        t += min(b, merged_busy[i][1]) - max(a, merged_busy[i][0])
        i += 1
    return t


def chunk_check(run) -> Dict[str, object]:
    """The traced chunk's kernels against its ``device/*`` spans: the worst
    distance (s) of a kernel outside every forward, backward and optimizer
    span, those spans' summed seconds a step over the chunk's wall a step,
    and for each phase its seconds, the share of them the card was busy,
    and its kernels by name as [device seconds, launches], a kernel counted
    in the shortest span holding its middle."""
    prof = run["profile"]
    t0, t1 = prof["t0"], prof["t1"]
    spans = [(n, a, b, s) for n, a, b, s in run["spans"]
             if n.startswith("device/") and t0 <= a and b <= t1]
    phases = sorted((s for s in spans if s[0] in STEP_PHASES),
                    key=lambda s: s[1])
    steps = {s[3] for s in phases}
    kernels = [e for e in prof["device_events"] if not _is_copy(e[0])]
    busy = merged(kernels, t0, t1)
    worst, worst_kernel, j = 0.0, None, 0
    by_phase: Dict[str, Dict[str, object]] = {}
    for name, a, b, _ in spans:
        p = by_phase.setdefault(name, {"s": 0.0, "busy_s": 0.0,
                                       "kernels": {}})
        p["s"] += b - a
        p["busy_s"] += _covered(busy, a, b)
    for name, a, b in kernels:           # sorted by start
        while j + 1 < len(phases) and phases[j + 1][1] <= a:
            j += 1
        near = phases[max(0, j - 1):j + 2]
        d = min(max(s[1] - a, b - s[2], 0.0) for s in near) if near else b - a
        if d > worst:
            worst, worst_kernel = d, name
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        if inner:
            k = by_phase[min(inner, key=lambda s: s[2] - s[1])[0]]["kernels"]
            k.setdefault(name, [0.0, 0])
            k[name][0] += b - a
            k[name][1] += 1
    wall = (t1 - t0) / len(steps) if steps else None
    covered = sum(b - a for _, a, b, _ in phases) / len(steps) \
        if steps else None
    return {"steps": len(steps), "kernels": len(kernels),
            "worst_outside_s": worst, "worst_kernel": worst_kernel,
            "covered_share": covered / wall if wall else None,
            "by_phase": by_phase}


def _short(name: str) -> str:
    return name.replace("void ", "").replace("at::native::", "")[:200]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown card"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.phases")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)

    import torch

    from . import harness as H
    from .run import _fixed_caches

    if not torch.cuda.is_available():
        sys.exit("portbench.phases: no CUDA device")
    root = H.root_dir()
    _fixed_caches(root)
    sys.path.insert(0, f"{root}/src")
    torch.set_num_threads(4)
    cell = H.load_cell(root, args.workload)
    run = H.run_cell(cell, args.seed, args.seconds, True, device="cuda",
                     reference=False,
                     log=lambda m: print(f"portbench: {m}", file=sys.stderr,
                                         flush=True))
    card = _card()
    w = run["window"]
    step_s = w["seconds"] / w["steps"]
    means = {n: ms_per_step(run, n) for n in
             (*STEP_PHASES, "device/ssd_backward", "device/exchange")}
    cover = sum(means[n] or 0.0 for n in STEP_PHASES) / (1e3 * step_s)
    print(f"phases window {w['steps']} steps, {1e3 * step_s:.1f} ms a step; "
          f"ms a step {({n: means[n] for n in means})}; forward + backward "
          f"+ optimizer {100 * cover:.3f}% of the window's step [{card}]",
          flush=True)
    c = chunk_check(run)
    print(f"phases chunk {c['steps']} steps, {c['kernels']} kernels; worst "
          f"outside the step's phases {1e3 * c['worst_outside_s']:.4f} ms "
          f"({c['worst_kernel']}); forward + backward + optimizer "
          f"{100 * (c['covered_share'] or 0):.3f}% of the chunk's step "
          f"[{card}]", flush=True)
    n = max(1, c["steps"])
    for phase, p in sorted(c["by_phase"].items()):
        kern = p["kernels"]
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:args.top]
        print(f"phases {phase}: {1e3 * p['s'] / n:.1f} ms a step, busy "
              f"{100 * p['busy_s'] / p['s']:.2f}%, kernels in it (its nested "
              f"phases' apart) {1e3 * sum(v[0] for v in kern.values()) / n:.1f}"
              f" ms and {sum(v[1] for v in kern.values()) // n} launches a "
              f"step; heaviest, ms and launches a step: "
              + "; ".join(f"{_short(k)} {1e3 * v[0] / n:.1f} ms {v[1] // n}"
                          for k, v in top), flush=True)


if __name__ == "__main__":
    main()
