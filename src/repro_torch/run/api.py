"""Run API of the port: run document -> resolved graph -> result.

    from repro_torch.run import api
    result = api.execute_doc(doc, device="cpu")
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Sequence

from .config import RunError, parse_run_doc
from .overrides import apply_overrides, parse_overrides


def _resolve_graph(graph: Dict[str, Any]) -> Dict[str, Any]:
    from ..config.resolver import resolve_config
    from ..core.components import register_all

    register_all()
    return resolve_config(graph)


def execute_serve(cfg, *, device=None, log=print) -> Dict[str, Any]:
    graph = _resolve_graph(cfg.graph)
    model = graph.get("model")
    if model is None:
        if "arch" not in graph:
            raise RunError("serve: the graph needs a 'model' or an 'arch' entry")
        from ..models import build_model

        model = build_model(graph["arch"])
    from ..launch.serve import serve_benchmark

    s = cfg.settings
    return serve_benchmark(model, batch=s.batch, prompt_len=s.prompt_len,
                           gen=s.gen, ckpt=s.ckpt, seed=s.seed, device=device,
                           log=log)


def execute_doc(doc: Dict[str, Any], *, kind: Optional[str] = None,
                overrides: Sequence[str] = (), device=None,
                write_result: bool = False,
                log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Apply ``--set`` overrides, parse, resolve and run one document.
    ``device`` is the card unless the caller asks for the CPU."""
    log = log or (lambda msg: print(msg, flush=True))
    doc = apply_overrides(doc, parse_overrides(overrides))
    cfg = parse_run_doc(doc, kind=kind)
    result = execute_serve(cfg, device=device, log=log)
    if write_result:
        os.makedirs(cfg.output_dir, exist_ok=True)
        path = os.path.join(cfg.output_dir, "result.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=2, default=str)
            f.write("\n")
        log(f"run artifact: {cfg.output_dir}")
    return result


def execute_file(path: str, **kw) -> Dict[str, Any]:
    from ..config.resolver import load_yaml

    return execute_doc(load_yaml(path), **kw)
