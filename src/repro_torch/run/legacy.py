"""Converters from the historic flag/flat-kwarg surfaces into run documents
(port of ``repro.run.legacy``: pure dict conversions, the same documents).

Used by the ``repro_torch.launch.*`` deprecation shims and by the sweep
backends so that pre-Run-API sweep specs (flat ``{arch, shape, plan_name,
...}`` dryrun bases, bare gym graphs) keep working — every path still
resolves through the config graph and materializes a replayable artifact.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from .config import RunError

#: the full flat-kwarg surface of the historic ``dryrun()`` entrypoint
_DRYRUN_KEYS = {"arch", "shape", "plan_name", "scan_block", "multi_pod",
                "mesh_split", "mla_absorb", "grad_accum", "serve_bf16",
                "bf16_params"}


def _component(component_key: str, variant_key: str,
               config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    node: Dict[str, Any] = {"component_key": component_key,
                            "variant_key": variant_key}
    if config:
        node["config"] = config
    return node


def dryrun_graph(arch: str, shape: str, *, plan_name: str = "",
                 scan_block: int = 0, multi_pod: bool = False,
                 mesh_split: str = "", mla_absorb: bool = False,
                 serve_bf16: bool = False,
                 bf16_params: bool = False) -> Dict[str, Any]:
    """The component graph equivalent of the historic dryrun flag set."""
    from ..configs import canonical

    arch_cfg: Dict[str, Any] = {}
    if scan_block:
        arch_cfg["scan_block_size"] = int(scan_block)
    if mla_absorb:
        arch_cfg["mla_absorb"] = True
    graph: Dict[str, Any] = {
        "arch": _component("arch_config", canonical(arch), arch_cfg),
        "shape": _component("shape", shape),
    }
    if mesh_split:
        try:
            dp, tp = (int(x) for x in mesh_split.split("x"))
        except ValueError:
            raise RunError(f"mesh_split must look like '32x8', "
                           f"got {mesh_split!r}") from None
        if multi_pod:
            raise RunError("mesh_split re-splits a single pod; it cannot be "
                           "combined with multi_pod")
        graph["mesh"] = _component("mesh_provider", "split",
                                   {"dp": dp, "tp": tp})
    else:
        graph["mesh"] = _component("mesh_provider", "production",
                                   {"multi_pod": bool(multi_pod)})
    if plan_name:
        graph["plan"] = _component("sharding_plan", plan_name,
                                   {"multi_pod": bool(multi_pod)})
    if serve_bf16 or bf16_params:
        graph["precision"] = _component(
            "precision", "policy",
            {"bf16_params": bool(bf16_params), "serve_bf16": bool(serve_bf16)})
    return graph


def legacy_dryrun_doc(flat: Dict[str, Any], *, kind: str = "dryrun",
                      settings: Optional[Dict[str, Any]] = None,
                      name: str = "") -> Dict[str, Any]:
    """A run document from the flat dryrun kwarg mapping (sweep bases)."""
    flat = dict(flat)
    unknown = set(flat) - _DRYRUN_KEYS
    if unknown:
        raise RunError(f"unknown dryrun keys {sorted(unknown)}; "
                       f"accepted: {sorted(_DRYRUN_KEYS)}")
    for key in ("arch", "shape"):
        if key not in flat:
            raise RunError(f"dryrun config needs {key!r} "
                           f"(got {sorted(flat)})")
    grad_accum = int(flat.pop("grad_accum", 1))
    graph = dryrun_graph(flat.pop("arch"), flat.pop("shape"), **flat)
    run_settings = {"grad_accum": grad_accum}
    run_settings.update(settings or {})
    run_sec: Dict[str, Any] = {"kind": kind, kind: run_settings}
    if name:
        run_sec["name"] = name
    return {"run": run_sec, **graph}


#: train-shaped kinds a sweep base config may declare: they all accept
#: steps/gym_key/resume and report a loss history, so the gym sweep
#: backend drives any of them (LoRA-rank x lr ablations run as sft trials)
TRAIN_LIKE_KINDS = ("train", "sft", "dpo")


def legacy_train_doc(raw_graph: Dict[str, Any], *,
                     steps: Optional[int] = None,
                     gym_key: Optional[str] = None,
                     resume: Optional[Any] = None,
                     name: str = "",
                     output_dir: str = "") -> Dict[str, Any]:
    """Wrap a bare component graph (or re-head an existing run doc) as a
    train-shaped run.  A document that already declares a train-like kind
    (``train``/``sft``/``dpo``) keeps it — its settings section gets the
    step/resume patches; anything else becomes a plain ``train`` run.
    ``None`` settings keep whatever the document already says (so a shim
    without an explicit flag does not clobber the YAML).  ``resume``
    accepts the TrainSettings forms: bool or ``"auto"``."""
    doc = copy.deepcopy(raw_graph)
    run_sec = dict(doc.pop("run", {}) or {})
    kind = run_sec.get("kind")
    if kind not in TRAIN_LIKE_KINDS:
        kind = "train"
    settings = dict(run_sec.get(kind, {}) or {})
    if steps is not None:
        settings["steps"] = int(steps)
    if gym_key is not None:
        settings["gym_key"] = gym_key
    if resume is not None:
        settings["resume"] = resume if isinstance(resume, str) else bool(resume)
    run_sec["kind"] = kind
    run_sec[kind] = settings
    from .config import SETTINGS_SCHEMAS

    for other in set(SETTINGS_SCHEMAS) - {kind}:  # drop foreign sections
        run_sec.pop(other, None)
    if name:
        run_sec["name"] = name
    if output_dir:
        run_sec["output_dir"] = output_dir
    return {"run": run_sec, **doc}
