"""Run API of the port: run document -> materialize -> fingerprint ->
dispatch (JAX's ``repro.run.api``).

    from repro_torch.run import api
    result = api.execute_doc(doc, device="cpu")

Run kinds are registry components (``component_key="run_kind"``,
:mod:`repro_torch.run.kinds`), so a new workload is a registry entry plus a
settings schema — not a new script and no edit to the port::

    from repro_torch.run.kinds import register_run_kind

    register_run_kind("eval", MyEvalSettings, my_eval_executor)

With ``write_result`` every run writes ``resolved.yaml`` + ``manifest.json``
(the replay artifact, byte-equal to JAX's) and ``result.json`` into its
output directory; :func:`replay` re-executes a run directory of either
package.  Every result carries the run's ``fingerprint`` and
``output_dir``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Sequence

from ..config.registry import Registry
from .config import RunConfig, RunError, parse_run_doc
from .kinds import _apply_warmstart  # noqa: F401  (callers import it from here)
from .overrides import apply_overrides, parse_overrides

RESULT_FILE = "result.json"


@dataclasses.dataclass
class RunContext:
    """Everything an executor needs: JAX's context plus the ``device`` the
    run is on.  ``options["_write_files"]`` says whether the run writes
    files."""

    cfg: RunConfig
    resolved_doc: Dict[str, Any]
    fingerprint: str
    registry: Optional[Registry] = None
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    log: Callable[[str], None] = lambda msg: None
    device: Any = None


def _registry(registry: Optional[Registry] = None) -> Registry:
    """The caller's registry, else the default one with the port's
    components and run kinds registered."""
    from ..config.registry import DEFAULT_REGISTRY
    from ..core.components import register_all
    from .kinds import register_builtin_kinds

    register_all()
    register_builtin_kinds()
    return registry or DEFAULT_REGISTRY


def _run_kind(reg: Registry, kind: str):
    """Resolve the run-kind executor; custom registries that carry no
    run_kind entries fall back to the built-in kinds."""
    from ..config.registry import DEFAULT_REGISTRY, RegistryError

    try:
        return reg.build("run_kind", kind)
    except RegistryError:
        if reg is not DEFAULT_REGISTRY:
            return DEFAULT_REGISTRY.build("run_kind", kind)
        raise


def fingerprint(doc: Dict[str, Any]) -> str:
    """The fingerprint of a normalized run document (``RunConfig.doc``):
    sha256 of its materialized form, factory defaults filled in, as JAX's
    ``run.api.execute`` computes it, so one document has one fingerprint in
    both packages."""
    from .fingerprint import fingerprint as _fingerprint
    from .fingerprint import materialize

    return _fingerprint(materialize(doc, _registry()))


def execute(cfg: RunConfig, *, device=None, write_result: bool = False,
            log: Optional[Callable[[str], None]] = None,
            registry: Optional[Registry] = None,
            options: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Execute a parsed run config on ``device`` (the card unless the
    caller asks for the CPU) through its kind's executor, looked up in
    ``registry`` (the default one, or the caller's with the built-in kinds
    as the fallback).  With ``write_result`` the run writes its artifacts
    first and ``result.json`` last (not for a resumed run that had nothing
    left to train); under ``torchrun`` only rank 0 logs and writes.  ``options`` reach the executor as
    ``RunContext.options``."""
    from ..device import resolve_device
    from .fingerprint import fingerprint as _fingerprint
    from .fingerprint import materialize, write_artifacts

    from ..launch.mesh import process_rank

    log = log or (lambda msg: print(msg, flush=True))
    run_writes = write_result
    if process_rank() != 0:
        # under torchrun rank 0 alone logs and writes the run's files
        write_result, log = False, (lambda msg: None)
    device = resolve_device(device)
    reg = _registry(registry)
    resolved = materialize(cfg.doc, reg)
    fp = _fingerprint(resolved)
    if write_result and cfg.output_dir:
        write_artifacts(cfg.output_dir, resolved, cfg.name, cfg.kind)
    ctx_options = dict(options or {})
    ctx_options.setdefault("_write_files", write_result)
    # what rank 0 writes: the files a gather on every rank must join
    ctx_options.setdefault("_run_writes", run_writes)
    ctx = RunContext(cfg=cfg, resolved_doc=resolved, fingerprint=fp,
                     registry=reg, options=ctx_options, log=log,
                     device=device)
    result = _run_kind(reg, cfg.kind).execute(ctx) or {}
    result.setdefault("kind", cfg.kind)
    result["fingerprint"] = fp
    result["output_dir"] = cfg.output_dir
    no_file = result.pop("_no_result_file", False)
    if write_result and cfg.output_dir and not no_file:
        os.makedirs(cfg.output_dir, exist_ok=True)
        with open(os.path.join(cfg.output_dir, RESULT_FILE), "w") as f:
            json.dump(result, f, indent=2, default=str)
            f.write("\n")
        log(f"run artifact: {cfg.output_dir}")
    return result


def execute_doc(doc: Dict[str, Any], *, kind: Optional[str] = None,
                overrides: Sequence[str] = (), device=None,
                write_result: bool = False, default_name: str = "run",
                config_dir: str = ".",
                log: Optional[Callable[[str], None]] = None,
                registry: Optional[Registry] = None,
                options: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Apply ``--set`` overrides, parse and execute one document.
    ``device`` is the card unless the caller asks for the CPU."""
    doc = apply_overrides(doc, parse_overrides(overrides))
    cfg = parse_run_doc(doc, kind=kind, default_name=default_name,
                        config_dir=config_dir)
    return execute(cfg, device=device, write_result=write_result, log=log,
                   registry=registry, options=options)


def execute_file(path: str, **kw) -> Dict[str, Any]:
    """:func:`execute_doc` of a YAML file, named by its stem unless the
    document names itself; relative paths in it resolve from its
    directory."""
    from ..config.resolver import load_yaml

    kw.setdefault("default_name", os.path.splitext(os.path.basename(path))[0])
    kw.setdefault("config_dir", os.path.dirname(os.path.abspath(path)))
    return execute_doc(load_yaml(path) or {}, **kw)


def replay(run_dir: str, *, device=None,
           log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Re-execute a run (of either package) from its artifact.

    Loads ``<run_dir>/resolved.yaml``, verifies its fingerprint against the
    manifest, and executes it — the identical run (same resolved config,
    same fingerprint) — writing its artifacts and result again."""
    import yaml

    from .fingerprint import RESOLVED_FILE, read_manifest

    path = os.path.join(run_dir, RESOLVED_FILE)
    if not os.path.exists(path):
        raise RunError(f"no resolved config at {path}; not a run directory?")
    with open(path) as f:
        doc = yaml.safe_load(f)
    manifest = read_manifest(run_dir)
    fp = fingerprint(doc)
    if fp != manifest.get("fingerprint"):
        raise RunError(
            f"fingerprint mismatch: resolved.yaml materializes to {fp} but "
            f"the manifest records {manifest.get('fingerprint')} — the "
            f"artifact was edited or the registry changed"
        )
    return execute_doc(doc, config_dir=run_dir, device=device,
                       write_result=True, log=log)
