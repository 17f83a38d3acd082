"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit, which also close standard error).  Exits with a
code other than 0, printing no result, when there is no card or fewer
cards than the cell needs, when the checkout has no ``src/repro_torch``,
or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _fixed_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so only a cell's first run there builds."""
    cache = os.path.join(root, "build", "portbench")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(cache, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")


def _fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness as H

    root = H.root_dir()
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        _fail(f"no program to measure: {src}/repro_torch is missing")
    _fixed_caches(root)
    try:
        cell = H.load_cell(root, args.workload)
    except (H.BenchError, OSError, KeyError, ValueError) as e:
        _fail(f"cannot load {args.workload!r}: {e}")
    if cell["limits"] is None:
        _fail(f"no limits/{args.workload}.json: nothing to hold the run to")

    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark measures the card, never the CPU")
    if torch.cuda.device_count() < cell["chips"]:
        _fail(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible")
    torch.set_num_threads(4)
    sys.path.insert(0, src)

    record = H.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        device="cuda",
                        log=lambda m: print(f"portbench: {m}",
                                            file=sys.stderr, flush=True))
    loaded = H.forbidden_loaded()
    if loaded:
        _fail(f"JAX or the JAX package was loaded: {', '.join(loaded)}")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"]}
    out = H.result_line(record, bool(args.trace), root, device_info=info)
    for name, c in out["checks"].items():
        print(f"portbench check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
