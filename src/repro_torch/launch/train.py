"""Training launcher — DEPRECATED shim over the declarative Run API (port of
``repro.launch.train``).

Preferred:

  PYTHONPATH=src python -m repro_torch train --config examples/configs/quickstart.yaml \
      [--set run.train.steps=100]

This shim keeps the historic flag surface working by translating it into a
run document (``--arch`` composes a component graph, the JAX package's),
then delegating; it runs on the card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train --config <yaml> [--steps N] [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \
      --steps 50 --seq-len 128 --global-batch 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Any, Dict


def _arch_graph(args) -> Dict[str, Any]:
    """The component-graph equivalent of the historic --arch flag set."""
    from ..configs import canonical, get_config, get_reduced

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    arch_cfg: Dict[str, Any] = {"reduced": bool(args.reduced)}
    if args.scan_block:
        arch_cfg["scan_block_size"] = args.scan_block
    if args.data_prefix:
        dataset = {"component_key": "dataset", "variant_key": "packed_chunked",
                   "config": {"prefix": args.data_prefix,
                              "seq_len": args.seq_len}}
    else:
        n_tokens = max(200_000,
                       args.steps * args.global_batch * (args.seq_len + 1))
        dataset = {"component_key": "dataset", "variant_key": "synthetic",
                   "config": {"n_tokens": n_tokens, "vocab": cfg.vocab,
                              "prefix": os.path.join(
                                  tempfile.gettempdir(),
                                  f"repro_train_{canonical(args.arch)}"),
                              "seq_len": args.seq_len}}
    return {
        "arch": {"component_key": "arch_config",
                 "variant_key": canonical(args.arch), "config": arch_cfg},
        "model": {"component_key": "model", "variant_key": "auto",
                  "config": {"arch_config": {"instance_key": "arch"}}},
        "schedule": {"component_key": "lr_schedule",
                     "variant_key": "warmup_cosine",
                     "config": {"peak_lr": args.lr, "warmup_steps": 20,
                                "total_steps": args.steps}},
        "optimizer": {"component_key": "optimizer", "variant_key": "adamw",
                      "config": {"lr": {"instance_key": "schedule"}}},
        "dataset": dataset,
        "loader": {"component_key": "loader", "variant_key": "sharded",
                   "config": {"dataset": {"instance_key": "dataset"},
                              "global_batch": args.global_batch}},
        "tracker": {"component_key": "tracker", "variant_key": "stdout"},
        "gym": {"component_key": "gym", "variant_key": "standard",
                "config": {"model": {"instance_key": "model"},
                           "optimizer": {"instance_key": "optimizer"},
                           "loader": {"instance_key": "loader"},
                           "log_every": 10,
                           "ckpt_every": args.ckpt_every,
                           "ckpt_dir": args.ckpt_dir,
                           "tracker": {"instance_key": "tracker"}}},
    }


def main(argv=None) -> int:
    """DEPRECATED shim: delegates to ``python -m repro_torch train``."""
    import warnings

    warnings.warn(
        "python -m repro_torch.launch.train is deprecated; use "
        "`python -m repro_torch train --config <run.yaml>` (this shim "
        "delegates through the same Run API)", DeprecationWarning,
        stacklevel=2)
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="")
    ap.add_argument("--arch", default="")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=None,
                    help="override run.train.steps (default: the document's "
                         "value; 100 for --arch runs)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-prefix", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--scan-block", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..run import api as run_api
    from ..run.legacy import legacy_train_doc

    if args.config:
        from ..config.resolver import load_yaml

        raw = load_yaml(args.config)
        name = ""
    else:
        if not args.arch:
            print("need --config or --arch", file=sys.stderr)
            return 2
        from ..configs import canonical

        if args.steps is None:
            args.steps = 100  # the historic --arch default
        raw = _arch_graph(args)
        name = f"train_{canonical(args.arch)}"

    doc = legacy_train_doc(raw, steps=args.steps,
                           resume=True if args.resume else None,
                           name=name)
    result = run_api.execute_doc(doc, device=args.device, write_result=True,
                                 log=lambda m: print(m, flush=True))
    if result.get("logged_points"):
        print(f"done: {result['logged_points']} logged points; first loss "
              f"{result['first_loss']:.4f} -> last {result['final_loss']:.4f}",
              flush=True)
    else:  # steps < log_every: nothing logged is not a crash
        print(f"done: {result['steps']} steps, no logged points "
              f"(steps < log_every)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
