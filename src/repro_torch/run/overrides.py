"""``--set path=value`` overrides applied to the raw run document
(port of ``repro.run.overrides``).

Paths are dotted (``a.b.0.c``; integer segments index lists).  Missing
intermediate keys are an error (a typo, not an override); a missing final
dict key is created.  Values are parsed as YAML (PyYAML is imported when a
value is parsed, not with this module).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Sequence, Tuple

from .config import RunError


def parse_value(raw: str) -> Any:
    if raw == "":
        return ""
    import yaml

    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def parse_overrides(pairs: Sequence[str]) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    for pair in pairs:
        path, sep, raw = pair.partition("=")
        if not sep or not path:
            raise RunError(f"--set expects path=value, got {pair!r}")
        out.append((path, parse_value(raw)))
    return out


def set_path(doc: Dict[str, Any], path: str, value: Any) -> None:
    keys = path.split(".")
    if any(not k for k in keys):
        raise RunError(f"--set {path}: empty path segment")
    node: Any = doc
    for i, k in enumerate(keys):
        last = i == len(keys) - 1
        where = ".".join(keys[:i]) or "<root>"
        if isinstance(node, list):
            try:
                idx = int(k)
                node[idx]
            except (ValueError, IndexError):
                raise RunError(f"--set {path}: bad list index {k!r} at {where}")
            if last:
                node[idx] = value
            else:
                node = node[idx]
        elif isinstance(node, dict):
            if last:
                node[k] = value
            elif k not in node:
                raise RunError(f"--set {path}: key {k!r} not found at {where}; "
                               f"available keys: {sorted(map(str, node))}")
            else:
                node = node[k]
        else:
            raise RunError(f"--set {path}: cannot step into "
                           f"{type(node).__name__} at {where}")


def apply_overrides(doc: Dict[str, Any],
                    overrides: Sequence[Tuple[str, Any]]) -> Dict[str, Any]:
    """Deep-copy ``doc`` and apply every ``(path, value)`` override."""
    doc = copy.deepcopy(doc)
    for path, value in overrides:
        set_path(doc, path, value)
    return doc
