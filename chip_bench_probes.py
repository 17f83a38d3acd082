#!/usr/bin/env python3
"""Probes of the ``bench`` kind on one GPU, beside ``chip_smoke.py``'s
phases: where its step time stands against the training phase's.

    python3 chip_bench_probes.py phases      # train qwen and mamba2, then phase_bench
    python3 chip_bench_probes.py turns       # per model: train (12 steps), bench, bench, train
    python3 chip_bench_probes.py mamba2-gap  # Mamba2: train (3), bench, train (12), train (3), bench

Each train run goes through the run API with the quickstart document at
full width (batch 8 x 1024, ``log_every`` 1) and prints its ms/step and
the medians of its ``gym/step``, ``gym/flush`` and ``gym/data_wait``
spans; each bench run is ``chip_smoke.py``'s (``bench.yaml`` at full
width).  Every line carries the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile

import chip_smoke as cs

ARGS = ["arch.config.reduced=false", "variables.seq_len=1024",
        "loader.config.global_batch=8"]
# bench.yaml's steps after warm-up for each model (as phase_bench)
BENCH = {"qwen": (30, 3), "mamba2": (10, 1)}


def _quiet(_msg):
    pass


def train(d: str, key: str, tag: str, steps: int, card: str) -> None:
    import torch

    from repro_torch.run import api

    out = os.path.join(d, f"t_{key}_{tag}")
    doc = cs.train_doc(d, f"t_{key}_{tag}", *ARGS,
                       *cs.TRAIN_SLICES[key]["sets"],
                       f"dataset.config.n_tokens={(steps + 2) * 8 * 1025}",
                       f"run.train.steps={steps}", f"run.output_dir={out}")
    torch.cuda.synchronize()
    res = api.execute_doc(doc, device="cuda", write_result=True, log=_quiet)
    ms = cs._step_ms(res["history"])
    with open(os.path.join(out, "telemetry.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    spans = {}
    for r in rows:
        if r["type"] == "span" and (r.get("step") or 0) >= 2:
            spans.setdefault(r["name"], []).append(1e3 * r["dur_s"])
    med = {k: round(statistics.median(v), 3) for k, v in spans.items()}
    print(f"probe {key} train {tag} ({steps} steps): ms/step steps 2-{steps} "
          f"{[round(x, 1) for x in ms]}, median {statistics.median(ms):.3f}; "
          f"span medians from step 2 (ms) {med} [{card}]", flush=True)
    del res
    cs._free()


def bench(d: str, key: str, tag: str, card: str) -> None:
    steps, warmup = BENCH[key]
    doc = cs.bench_doc(d, key, *ARGS, *cs.TRAIN_SLICES[key]["sets"],
                       f"dataset.config.n_tokens="
                       f"{(1 + warmup + steps) * 8 * 1025}",
                       f"run.bench.steps={steps}",
                       f"run.bench.warmup={warmup}")
    res, counts = cs._bench_run(doc)
    print(f"probe {key} bench {tag}: steady_step_ms {res['steady_step_ms']} "
          f"windows {[w['step_ms'] for w in res['windows']]} launches "
          f"{counts} [{card}]", flush=True)
    del res
    cs._free()


def main() -> int:
    probe = sys.argv[1] if len(sys.argv) > 1 else ""
    if probe not in ("phases", "turns", "mamba2-gap"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_bench_probes: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory(prefix="chip_bench_probes_") as d:
        if probe == "phases":
            results: dict = {}
            ok = all([cs.phase_train_full(key, d, results, card)
                      for key in ("qwen", "mamba2")])
            ok &= cs.phase_bench(d, results, card)
            return 0 if ok else 1
        if probe == "turns":
            for key in ("qwen", "mamba2"):
                train(d, key, "1", 12, card)
                bench(d, key, "1", card)
                bench(d, key, "2", card)
                train(d, key, "2", 12, card)
            return 0
        cs.phase_train_full("qwen", d, {}, card)
        train(d, "mamba2", "a", 3, card)
        bench(d, "mamba2", "1", card)
        train(d, "mamba2", "b", 12, card)
        train(d, "mamba2", "c", 3, card)
        bench(d, "mamba2", "2", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
