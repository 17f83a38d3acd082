"""``python -m repro_torch <kind> --config run.yaml [--set path=value]
[--device cuda|cpu]`` — the port's declarative entry point.

The run runs on the card unless ``--device cpu`` is given; with no card and
no ``--device cpu`` it stops with an error.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch")
    ap.add_argument("kind", choices=["train", "serve"])
    ap.add_argument("--config", required=True, help="run document (YAML)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="PATH=VALUE", help="override a document entry")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .api import execute_file

    result = execute_file(args.config, kind=args.kind,
                          overrides=args.overrides, device=args.device,
                          write_result=True)
    if args.kind == "train":
        if "first_loss" in result:
            print(f"done: {result['logged_points']} logged points; first loss "
                  f"{result['first_loss']:.4f} -> last "
                  f"{result['final_loss']:.4f}, {result['tokens_per_s']} "
                  f"tok/s", flush=True)
        else:
            print(f"done: {result['steps']} steps, no logged points",
                  flush=True)
    elif "bench_file" in result:
        print(f"done: {result['completed']}/{result['n_requests']} requests, "
              f"{result['tok_s']} tok/s, decode {result['decode_tok_s']} "
              f"tok/s, prefix-cache hit rate "
              f"{result['prefill_cache_hit_rate']}; bench: "
              f"{result['bench_file']}", flush=True)
    else:
        print(f"done: {result['batch']} requests x {result['gen']} tokens, "
              f"prefill {result['prefill_tok_s']} tok/s, decode "
              f"{result['decode_tok_s']} tok/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
