"""Dependency-graph resolution: YAML dict -> validated object graph.

The port's own copy of ``repro.config.resolver``.  ``load_yaml`` imports
``yaml`` inside the function: nothing on the chip run's path needs PyYAML.

Semantics mirror Modalities:

* A mapping with ``component_key`` + ``variant_key`` is a *component node*;
  its ``config`` sub-mapping is resolved recursively, then the registered
  factory builds the instance.
* A mapping ``{instance_key: <top-level name>, pass_type: BY_REFERENCE}``
  resolves to the already-built top-level instance of that name (shared
  object; built lazily, cycle-checked).
* Everything else (scalars, lists, plain mappings) passes through, with
  ``${var}`` string interpolation from a ``variables`` section.

The resolved *object graph* is returned as a dict of top-level instances,
ready to be injected into the gym.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Set

from .registry import DEFAULT_REGISTRY, Registry, RegistryError


class ConfigError(Exception):
    pass


_VAR_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def interpolate(value: str, variables: Dict[str, Any]) -> Any:
    m = _VAR_RE.fullmatch(value)
    if m:  # whole-string reference keeps the native type
        name = m.group(1)
        if name not in variables:
            raise ConfigError(f"undefined variable ${{{name}}}")
        return variables[name]

    def sub(mo):
        name = mo.group(1)
        if name not in variables:
            raise ConfigError(f"undefined variable ${{{name}}}")
        return str(variables[name])

    return _VAR_RE.sub(sub, value)


class Resolver:
    def __init__(self, registry: Optional[Registry] = None) -> None:
        self.registry = registry or DEFAULT_REGISTRY

    def resolve(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(raw, dict):
            raise ConfigError("top-level config must be a mapping")
        variables = dict(raw.get("variables", {}))
        top = {k: v for k, v in raw.items() if k != "variables"}
        built: Dict[str, Any] = {}
        in_progress: Set[str] = set()

        def build_top(name: str) -> Any:
            if name in built:
                return built[name]
            if name not in top:
                raise ConfigError(
                    f"reference to unknown top-level entry {name!r}; "
                    f"available: {sorted(top)}"
                )
            if name in in_progress:
                raise ConfigError(
                    f"cyclic reference involving {name!r} "
                    f"(cycle: {sorted(in_progress)})"
                )
            in_progress.add(name)
            try:
                built[name] = resolve_node(top[name], path=name)
            finally:
                in_progress.discard(name)
            return built[name]

        def resolve_node(node: Any, path: str) -> Any:
            if isinstance(node, str):
                return interpolate(node, variables)
            if isinstance(node, list):
                return [resolve_node(v, f"{path}[{i}]") for i, v in enumerate(node)]
            if not isinstance(node, dict):
                return node
            if "instance_key" in node:
                pass_type = node.get("pass_type", "BY_REFERENCE")
                if pass_type != "BY_REFERENCE":
                    raise ConfigError(f"{path}: unsupported pass_type {pass_type!r}")
                extra = set(node) - {"instance_key", "pass_type"}
                if extra:
                    raise ConfigError(f"{path}: reference node has extra keys {extra}")
                return build_top(node["instance_key"])
            if "component_key" in node:
                if "variant_key" not in node:
                    raise ConfigError(f"{path}: component node missing variant_key")
                extra = set(node) - {"component_key", "variant_key", "config"}
                if extra:
                    raise ConfigError(f"{path}: component node has extra keys {extra}")
                cfg = node.get("config", {}) or {}
                if not isinstance(cfg, dict):
                    raise ConfigError(f"{path}: config must be a mapping")
                kwargs = {
                    k: resolve_node(v, f"{path}.{k}") for k, v in cfg.items()
                }
                try:
                    return self.registry.build(
                        node["component_key"], node["variant_key"], **kwargs
                    )
                except RegistryError as e:
                    raise ConfigError(f"{path}: {e}") from e
            return {k: resolve_node(v, f"{path}.{k}") for k, v in node.items()}

        for name in top:
            build_top(name)
        return built


def resolve_config(raw: Dict[str, Any], registry: Optional[Registry] = None) -> Dict[str, Any]:
    return Resolver(registry).resolve(raw)


def validate_config(raw: Dict[str, Any],
                    registry: Optional[Registry] = None) -> Dict[str, int]:
    """Schema + registry validation WITHOUT building anything (JAX's
    ``validate_config``).

    Walks the document exactly like :class:`Resolver` but never calls a
    factory: variables must be defined, reference targets must exist (and be
    acyclic), component/variant pairs must be registered, and each component
    node's config keys are checked against the factory signature (unknown and
    missing-required keys).  A component of a later slice of the port (a
    factory with a ``not_ported`` message, or a ``not_ported_for(config)``
    callable that gives one for the settings it refuses) raises
    ``NotImplementedError`` with that message.  Returns ``{"components": n, "top_level": m}``.
    """
    reg = registry or DEFAULT_REGISTRY
    if not isinstance(raw, dict):
        raise ConfigError("top-level config must be a mapping")
    variables = dict(raw.get("variables", {}) or {})
    top = {k: v for k, v in raw.items() if k != "variables"}
    counts = {"components": 0, "top_level": len(top)}
    visited: Set[str] = set()
    in_progress: Set[str] = set()

    def visit_top(name: str) -> None:
        if name in visited:
            return
        if name not in top:
            raise ConfigError(
                f"reference to unknown top-level entry {name!r}; "
                f"available: {sorted(top)}"
            )
        if name in in_progress:
            raise ConfigError(
                f"cyclic reference involving {name!r} "
                f"(cycle: {sorted(in_progress)})"
            )
        in_progress.add(name)
        try:
            check_node(top[name], path=name)
        finally:
            in_progress.discard(name)
        visited.add(name)

    def check_node(node: Any, path: str) -> None:
        if isinstance(node, str):
            interpolate(node, variables)
            return
        if isinstance(node, list):
            for i, v in enumerate(node):
                check_node(v, f"{path}[{i}]")
            return
        if not isinstance(node, dict):
            return
        if "instance_key" in node:
            pass_type = node.get("pass_type", "BY_REFERENCE")
            if pass_type != "BY_REFERENCE":
                raise ConfigError(f"{path}: unsupported pass_type {pass_type!r}")
            extra = set(node) - {"instance_key", "pass_type"}
            if extra:
                raise ConfigError(f"{path}: reference node has extra keys {extra}")
            visit_top(node["instance_key"])
            return
        if "component_key" in node:
            if "variant_key" not in node:
                raise ConfigError(f"{path}: component node missing variant_key")
            extra = set(node) - {"component_key", "variant_key", "config"}
            if extra:
                raise ConfigError(f"{path}: component node has extra keys {extra}")
            cfg = node.get("config", {}) or {}
            if not isinstance(cfg, dict):
                raise ConfigError(f"{path}: config must be a mapping")
            try:
                entry = reg.entry(node["component_key"], node["variant_key"])
                reg.validate_kwargs(entry, cfg)
            except RegistryError as e:
                raise ConfigError(f"{path}: {e}") from e
            not_ported = getattr(entry.factory, "not_ported", None)
            refuses = getattr(entry.factory, "not_ported_for", None)
            if refuses is not None:
                not_ported = refuses(cfg)
            if not_ported:
                raise NotImplementedError(f"{path}: {not_ported}")
            counts["components"] += 1
            for k, v in cfg.items():
                check_node(v, f"{path}.{k}")
            return
        for k, v in node.items():
            check_node(v, f"{path}.{k}")

    for name in top:
        visit_top(name)
    return counts


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
