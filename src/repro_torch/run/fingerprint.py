"""Resolved-config materialization and content fingerprinting (the port's
own copy of ``repro.run.fingerprint``, over the port's registry).

``materialize`` turns a normalized run document into its fully-resolved
form: ``${var}`` interpolation applied everywhere (and the ``variables``
section dropped), reference nodes normalized, and every component node's
config filled with the registered factory's defaults.  The port registers
its factories with the JAX package's names, arguments and defaults, so one
document materializes to the same form, and ``fingerprint`` gives the same
hash, in both packages.

Artifacts written per run (byte-equal to JAX's for the same document, so
each package replays the other's run directories):

* ``resolved.yaml``  — the materialized run document
* ``manifest.json``  — ``{name, kind, fingerprint}``
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
from typing import Any, Dict, Optional, Tuple

from ..config.registry import DEFAULT_REGISTRY, Registry, RegistryError
from ..config.resolver import ConfigError, interpolate

RESOLVED_FILE = "resolved.yaml"
MANIFEST_FILE = "manifest.json"

_SERIALIZABLE = (str, int, float, bool, type(None))


def canonical_json(doc: Any) -> str:
    """Deterministic serialization: sorted keys, no incidental whitespace."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"), default=str)


def fingerprint(doc: Any) -> str:
    return "sha256:" + hashlib.sha256(canonical_json(doc).encode()).hexdigest()


def _default_value(value: Any) -> Tuple[bool, Any]:
    """Whether a factory default is expressible in YAML (and its form)."""
    if isinstance(value, _SERIALIZABLE):
        return True, value
    if isinstance(value, (list, tuple)):
        items = [_default_value(v) for v in value]
        if all(ok for ok, _ in items):
            return True, [v for _, v in items]
    if isinstance(value, dict):
        items = {k: _default_value(v) for k, v in value.items()}
        if all(ok for ok, _ in items.values()):
            return True, {k: v for k, (_, v) in items.items()}
    return False, None


def _fill_defaults(node: Dict[str, Any], registry: Registry,
                   path: str) -> Dict[str, Any]:
    """Fill a component node's config with the factory's default kwargs."""
    try:
        entry = registry.entry(node["component_key"], node["variant_key"])
    except RegistryError as e:
        raise ConfigError(f"{path}: {e}") from e
    cfg = dict(node.get("config", {}) or {})
    for name, param in entry.signature().parameters.items():
        if name in cfg or param.default is inspect.Parameter.empty:
            continue
        if param.kind in (inspect.Parameter.VAR_KEYWORD,
                          inspect.Parameter.VAR_POSITIONAL):
            continue
        ok, value = _default_value(param.default)
        if ok:
            cfg[name] = value
    out = {"component_key": node["component_key"],
           "variant_key": node["variant_key"]}
    if cfg:
        out["config"] = cfg
    return out


def materialize(doc: Dict[str, Any],
                registry: Optional[Registry] = None) -> Dict[str, Any]:
    """Fully-resolved form of a normalized run document: the ``run`` section
    and any ``sweep`` spec body pass through untouched (a sweep
    materializes per *trial*, through the backends); the component graph
    is interpolated and default-filled."""
    registry = registry or DEFAULT_REGISTRY
    doc = dict(doc)
    run_sec = doc.get("run")
    is_sweep = isinstance(run_sec, dict) and run_sec.get("kind") == "sweep"
    variables = dict(doc.pop("variables", {}) or {})

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, str):
            return interpolate(node, variables)
        if isinstance(node, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        if "instance_key" in node:
            return {"instance_key": node["instance_key"],
                    "pass_type": node.get("pass_type", "BY_REFERENCE")}
        if "component_key" in node:
            filled = _fill_defaults(node, registry, path)
            if "config" in filled:
                filled["config"] = {
                    k: walk(v, f"{path}.{k}")
                    for k, v in filled["config"].items()
                }
            return filled
        return {k: walk(v, f"{path}.{k}") for k, v in node.items()}

    return {key: value if key == "run" or is_sweep else walk(value, key)
            for key, value in doc.items()}


def write_artifacts(output_dir: str, resolved_doc: Dict[str, Any],
                    name: str, kind: str) -> str:
    """Write ``resolved.yaml`` + ``manifest.json``; returns the fingerprint."""
    import yaml

    fp = fingerprint(resolved_doc)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, RESOLVED_FILE), "w") as f:
        yaml.safe_dump(resolved_doc, f, sort_keys=False)
    with open(os.path.join(output_dir, MANIFEST_FILE), "w") as f:
        json.dump({"name": name, "kind": kind, "fingerprint": fp}, f, indent=2)
    return fp


def read_manifest(run_dir: str) -> Dict[str, Any]:
    path = os.path.join(run_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no run manifest at {path}")
    with open(path) as f:
        return json.load(f)
