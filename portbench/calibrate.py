"""Readings that set a cell's limits: the program's sound runs over many
seeds, the control, and the faults, each against the reference.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control 1,2,3] [--faults 1,2,3] [--out readings.jsonl]

For each seed of ``--seeds`` the program runs its set-up steps (no window)
and the f32 reference follows them; ``--control`` seeds also run the
reference with its products' operands in fp8 in the program's place, and
``--faults`` seeds the program with each planted fault of ``faults.py``.
One JSON line per reading: the three gaps ``correct.py`` compares.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731

    from . import correct as C
    from . import harness as H
    from .faults import FAULTS
    from .kinds import train as K
    from .reference.lm import fp8_mm
    from .run import _fixed_caches

    root = H.root_dir()
    _fixed_caches(root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    cell = H.load_cell(root, args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    refs = {}

    def reference(seed):
        if seed not in refs:
            import tempfile

            from . import traffic as T
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "tokens")
                T.write(cell["traffic"], K.token_ids(cell["config"]), seed,
                        path, path + ".idx")
                batches = K.check_batches(path, cell["traffic"], "cuda")
            t = time.perf_counter()
            refs[seed] = (K.reference_readings(cell, seed, batches, "cuda"), batches,
                          time.perf_counter() - t)
        return refs[seed]

    def program(seed, hook=None):
        t = time.perf_counter()
        rec = K.run_cell(cell, seed, None, False, device="cuda", hook=hook,
                         reference=False)
        free()
        return rec["readings"], rec["peak_bytes"], time.perf_counter() - t

    seeds, control, faults = ints(args.seeds), ints(args.control), \
        ints(args.faults)
    for seed in sorted(set(seeds) | set(control) | set(faults)):
        if seed in seeds or seed in faults:
            readings, peak, secs = program(seed)
            ref, batches, ref_s = reference(seed)
            emit({"seed": seed, "run": "program", "gaps": C.gaps(readings, ref),
                  "losses": readings["losses"], "ref_losses": ref["losses"],
                  "program_s": secs, "reference_s": ref_s, "peak_bytes": peak})
        ref, batches, _ = reference(seed)
        if seed in control:
            t = time.perf_counter()
            ctl = K.reference_readings(cell, seed, batches, "cuda", mm=fp8_mm)
            free()
            emit({"seed": seed, "run": "control_fp8", "gaps": C.gaps(ctl, ref),
                  "losses": ctl["losses"], "seconds": time.perf_counter() - t})
        if seed in faults:
            for name, fault in FAULTS.items():
                if name == "unchanged":
                    continue  # reads 1 by construction
                readings, _, secs = program(seed, hook=fault)
                emit({"seed": seed, "run": f"fault_{name}",
                      "gaps": C.gaps(readings, ref), "seconds": secs})
        refs.pop(seed, None)
        free()
    if out:
        out.close()


if __name__ == "__main__":
    main()
