"""Sweep specification: declarative axes -> concrete trial configs (port of
``repro.sweep.spec``: the same expansion, trial ids and error messages, so
one campaign's directories and resume keys are the same in both packages).

The spec mirrors the resolver philosophy — an ablation campaign is data, not
code.  Axes expand into per-trial *patch sets* (dotted config paths -> values)
that are deep-applied onto the raw base config; the resolver then builds each
trial's object graph, so a trial differs from the base by config only.

Axis blocks (``axes`` is a list; blocks combine by cartesian product):

* ``{type: grid, parameters: {path: [v, ...], ...}}`` — cartesian product of
  the per-path value lists within the block.
* ``{type: zip,  parameters: {path: [v, ...], ...}}`` — element-wise rows;
  all lists must have equal length.
* ``{type: list, trials: [{path: value, ...}, ...]}`` — explicit patch rows.

Seed replication: ``seeds: [0, 1, 2]`` adds a final product axis writing each
seed to ``seed_path`` (default ``gym.config.seed``; ignored for backends whose
configs carry no seed, e.g. ``dryrun``, by setting ``seed_path: null``).
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


class SweepError(Exception):
    """Malformed sweep spec or invalid patch path."""


# ---------------------------------------------------------------------------
# deep patching (moved here from core.tuner, now with validation + list index)
# ---------------------------------------------------------------------------
def _step_into(node: Any, key: str, path: str, full_path: str) -> Any:
    if isinstance(node, list):
        try:
            idx = int(key)
        except ValueError:
            raise SweepError(
                f"patch path {full_path!r}: segment {key!r} at {path!r} indexes "
                f"a list and must be an integer"
            ) from None
        if not -len(node) <= idx < len(node):
            raise SweepError(
                f"patch path {full_path!r}: index {idx} out of range at "
                f"{path!r} (list has {len(node)} elements)"
            )
        return node[idx]
    if isinstance(node, dict):
        if key not in node:
            raise SweepError(
                f"patch path {full_path!r}: key {key!r} not found at {path!r}; "
                f"available keys: {sorted(map(str, node))}"
            )
        return node[key]
    raise SweepError(
        f"patch path {full_path!r}: cannot descend into {type(node).__name__} "
        f"at {path!r}"
    )


def set_path(cfg: Dict[str, Any], path: str, value: Any,
             create_missing: bool = False) -> None:
    """Set ``cfg[a][b][...] = value`` for dotted ``path`` ``"a.b.c"``.

    Integer segments index lists (``"axes.0.type"``).  Missing intermediate
    keys are an error — a sweep that silently grows new config branches is a
    typo, not an ablation — unless ``create_missing`` is set, in which case
    missing *final-segment* dict keys are created (the historic tuner
    behaviour for adding e.g. a fresh override key).
    """
    if not path:
        raise SweepError("patch path must be non-empty")
    keys = path.split(".")
    if any(not k for k in keys):
        raise SweepError(f"patch path {path!r} has an empty segment")
    node: Any = cfg
    for i, k in enumerate(keys[:-1]):
        node = _step_into(node, k, ".".join(keys[:i]) or "<root>", path)
    last = keys[-1]
    parent = ".".join(keys[:-1]) or "<root>"
    if isinstance(node, list):
        _step_into(node, last, parent, path)  # validates index
        node[int(last)] = value
    elif isinstance(node, dict):
        if last not in node and not create_missing:
            raise SweepError(
                f"patch path {path!r}: key {last!r} not found at {parent!r}; "
                f"available keys: {sorted(map(str, node))} "
                f"(pass create_missing=True to add new keys)"
            )
        node[last] = value
    else:
        raise SweepError(
            f"patch path {path!r}: cannot assign into {type(node).__name__} "
            f"at {parent!r}"
        )


def apply_patches(base: Dict[str, Any], patches: Dict[str, Any],
                  create_missing: bool = False) -> Dict[str, Any]:
    """Deep-copy ``base`` and apply every ``path -> value`` patch."""
    raw = copy.deepcopy(base)
    for path, value in patches.items():
        set_path(raw, path, value, create_missing=create_missing)
    return raw


# ---------------------------------------------------------------------------
# axis expansion
# ---------------------------------------------------------------------------
def _expand_block(block: Dict[str, Any], i: int) -> List[Dict[str, Any]]:
    if not isinstance(block, dict):
        raise SweepError(f"axes[{i}] must be a mapping, got {type(block).__name__}")
    kind = block.get("type")
    if kind in ("grid", "zip"):
        params = block.get("parameters")
        if not isinstance(params, dict) or not params:
            raise SweepError(f"axes[{i}] ({kind}): 'parameters' must be a "
                             f"non-empty mapping of path -> value list")
        lists: List[Tuple[str, List[Any]]] = []
        for path, values in params.items():
            if not isinstance(values, (list, tuple)):
                raise SweepError(
                    f"axes[{i}] ({kind}): values for {path!r} must be a list, "
                    f"got {type(values).__name__}"
                )
            if not values:
                raise SweepError(f"axes[{i}] ({kind}): {path!r} has no values")
            lists.append((path, list(values)))
        if kind == "grid":
            names = [p for p, _ in lists]
            return [dict(zip(names, combo))
                    for combo in itertools.product(*(v for _, v in lists))]
        lengths = {len(v) for _, v in lists}
        if len(lengths) != 1:
            raise SweepError(
                f"axes[{i}] (zip): all value lists must have equal length, "
                f"got {sorted(len(v) for _, v in lists)}"
            )
        return [{p: v[j] for p, v in lists} for j in range(lengths.pop())]
    if kind == "list":
        rows = block.get("trials")
        if not isinstance(rows, list) or not rows:
            raise SweepError(f"axes[{i}] (list): 'trials' must be a non-empty "
                             f"list of patch mappings")
        for j, row in enumerate(rows):
            if not isinstance(row, dict):
                raise SweepError(f"axes[{i}] (list): trials[{j}] must be a "
                                 f"mapping of path -> value")
        return [dict(row) for row in rows]
    raise SweepError(
        f"axes[{i}]: unknown axis type {kind!r}; expected grid, zip, or list"
    )


def _merge_rows(rows: Sequence[Dict[str, Any]], i: int) -> Dict[str, Any]:
    merged: Dict[str, Any] = {}
    for row in rows:
        dup = set(merged) & set(row)
        if dup:
            raise SweepError(
                f"trial {i}: patch path(s) {sorted(dup)} set by more than one "
                f"axis block; each path may appear in exactly one axis"
            )
        merged.update(row)
    return merged


def _slug(value: Any) -> str:
    s = str(value)
    return "".join(c if c.isalnum() or c in "._+-" else "-" for c in s) or "x"


def _short_label(path: str, all_paths: Sequence[str]) -> str:
    """Shortest dotted suffix of ``path`` that is non-numeric and unique
    among ``all_paths`` (so 'optimizer.config.lr' labels as 'lr', but a
    list-index leaf like 'axes.0' keeps its parent segment)."""
    segs = path.split(".")
    for n in range(1, len(segs) + 1):
        label = ".".join(segs[-n:])
        if label.replace(".", "").isdigit():
            continue
        if not any(p != path and p.split(".")[-n:] == segs[-n:]
                   for p in all_paths):
            return label
    return path


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Trial:
    """One concrete point of the sweep: a patch set plus optional seed."""

    index: int
    patches: Dict[str, Any]
    seed: Optional[int] = None

    @property
    def trial_id(self) -> str:
        """Stable, filesystem-safe id derived from the patch values (not the
        trial index), so resume survives axis reordering."""
        paths = sorted(self.patches)
        labels = {p: _short_label(p, paths) for p in paths}
        parts = [f"{labels[p]}={_slug(self.patches[p])}" for p in paths]
        if self.seed is not None:
            parts.append(f"seed={self.seed}")
        return "__".join(parts) if parts else f"trial{self.index}"


DEFAULT_SEED_PATH = "gym.config.seed"


@dataclasses.dataclass
class SweepSpec:
    """Parsed, validated sweep document."""

    name: str
    base: Dict[str, Any]
    axes: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    backend: str = "gym"
    output_dir: Optional[str] = None
    objective_metric: str = "final_loss"
    objective_mode: str = "min"
    seeds: List[int] = dataclasses.field(default_factory=list)
    seed_path: Optional[str] = DEFAULT_SEED_PATH
    steps: int = 10
    gym_key: str = "gym"
    create_missing: bool = False
    retry: Any = None             # mapping -> in-trial RetryPolicy kwargs
    telemetry: Any = None         # mapping/bool -> sweep-level TelemetrySettings

    def __post_init__(self) -> None:
        if self.retry is not None and not isinstance(self.retry, dict):
            raise SweepError("sweep 'retry' must be a mapping of "
                             "RetryPolicy knobs (max_attempts, "
                             "base_delay_s, max_delay_s, jitter)")
        if self.backend not in ("gym", "dryrun"):
            raise SweepError(f"unknown backend {self.backend!r}; "
                             f"expected 'gym' or 'dryrun'")
        if self.objective_mode not in ("min", "max"):
            raise SweepError(f"objective mode must be 'min' or 'max', "
                             f"got {self.objective_mode!r}")
        if not isinstance(self.base, dict):
            raise SweepError("sweep base config must be a mapping")
        # expand eagerly so a malformed spec fails at load time, not mid-run
        self._trials = self._expand()

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dict(cls, doc: Dict[str, Any],
                  config_dir: str = ".") -> "SweepSpec":
        if not isinstance(doc, dict):
            raise SweepError("sweep document must be a mapping")
        doc = dict(doc.get("sweep", doc))  # tolerate a top-level `sweep:` key
        known = {"name", "backend", "base", "base_config", "axes", "output_dir",
                 "objective", "seeds", "seed_path", "steps", "gym_key",
                 "create_missing", "retry", "telemetry"}
        unknown = set(doc) - known
        if unknown:
            raise SweepError(f"unknown sweep keys {sorted(unknown)}; "
                             f"known keys: {sorted(known)}")
        base = doc.get("base")
        if "base_config" in doc:
            if base is not None:
                raise SweepError("give either 'base' (inline) or "
                                 "'base_config' (path), not both")
            path = os.path.join(config_dir, doc["base_config"])
            from ..config.resolver import load_yaml

            base = load_yaml(path)
        if base is None:
            raise SweepError("sweep needs a 'base' mapping or a "
                             "'base_config' path")
        objective = doc.get("objective", {}) or {}
        if not isinstance(objective, dict):
            raise SweepError("'objective' must be a mapping with "
                             "'metric' and 'mode'")
        kwargs: Dict[str, Any] = dict(
            name=str(doc.get("name", "sweep")),
            base=base,
            axes=doc.get("axes", []) or [],
            backend=doc.get("backend", "gym"),
            output_dir=doc.get("output_dir"),
            seeds=list(doc.get("seeds", []) or []),
            steps=int(doc.get("steps", 10)),
            gym_key=doc.get("gym_key", "gym"),
            create_missing=bool(doc.get("create_missing", False)),
            retry=doc.get("retry"),
            telemetry=doc.get("telemetry"),
        )
        if "seed_path" in doc:
            kwargs["seed_path"] = doc["seed_path"]
        elif kwargs["backend"] == "dryrun":
            kwargs["seed_path"] = None  # dryrun configs carry no seed
        if "metric" in objective:
            kwargs["objective_metric"] = objective["metric"]
        elif kwargs["backend"] == "dryrun":
            kwargs["objective_metric"] = "roofline_step_s"
        kwargs["objective_mode"] = objective.get("mode", "min")
        return cls(**kwargs)

    @classmethod
    def from_yaml(cls, path: str) -> "SweepSpec":
        from ..config.resolver import load_yaml

        spec = cls.from_dict(load_yaml(path),
                             config_dir=os.path.dirname(os.path.abspath(path)))
        if spec.name == "sweep":
            spec.name = os.path.splitext(os.path.basename(path))[0]
        return spec

    # -- expansion ----------------------------------------------------------
    def _expand(self) -> List[Trial]:
        if not isinstance(self.axes, list):
            raise SweepError("'axes' must be a list of axis blocks")
        blocks = [_expand_block(b, i) for i, b in enumerate(self.axes)]
        rows: Iterable[Tuple[Dict[str, Any], ...]] = (
            itertools.product(*blocks) if blocks else [()]
        )
        merged = [_merge_rows(r, i) for i, r in enumerate(rows)]
        seeds: List[Optional[int]] = list(self.seeds) or [None]
        if self.seeds and not self.seed_path:
            raise SweepError("seed replication needs a 'seed_path' to patch")
        trials: List[Trial] = []
        for patches in merged:
            for seed in seeds:
                trials.append(Trial(index=len(trials), patches=patches,
                                    seed=seed))
        ids = [t.trial_id for t in trials]
        if len(set(ids)) != len(ids):
            dup = sorted({i for i in ids if ids.count(i) > 1})
            raise SweepError(f"expansion produced duplicate trial ids {dup}; "
                             f"axes repeat the same patch values")
        # validate every patch path against the base (cheap: one deep-copy per
        # distinct patch row, before any trial runs)
        for patches in merged:
            probe = apply_patches(self.base, patches,
                                  create_missing=self.create_missing)
            if self.seeds and self.seed_path:
                set_path(probe, self.seed_path, seeds[0], create_missing=True)
        return trials

    def trials(self) -> List[Trial]:
        return list(self._trials)

    def trial_config(self, trial: Trial) -> Dict[str, Any]:
        """The fully-patched raw config for one trial."""
        raw = apply_patches(self.base, trial.patches,
                            create_missing=self.create_missing)
        if trial.seed is not None and self.seed_path:
            set_path(raw, self.seed_path, trial.seed, create_missing=True)
        return raw
