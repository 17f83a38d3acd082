"""Component catalog of the port: registers what this slice can build with
the port's own registry (``repro_torch.config.registry.DEFAULT_REGISTRY``).

Registered: ``arch_config/<arch>`` for every arch of the table (with the
``reduced`` flag and field overrides), ``arch_config/custom``, and
``model/auto``.  The names match ``repro.core.components``, so a run YAML of
the JAX package resolves here unchanged.
"""
from __future__ import annotations

from typing import Any, Dict

from ..config.registry import DEFAULT_REGISTRY as REG
from ..configs import ARCH_IDS, get_config, get_reduced
from ..models import build_model
from ..models.base import ArchConfig, MLAConfig, Model, MoEConfig, SSMConfig

_REGISTERED = False


def register_all() -> None:
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    for arch in ARCH_IDS + ["llama3_8b"]:
        REG.register("arch_config", arch,
                     (lambda a: (lambda reduced=False, **overrides:
                                 _cfg(a, reduced, overrides)))(arch),
                     ArchConfig)
    REG.register("arch_config", "custom", _custom_cfg, ArchConfig)
    REG.register("model", "auto", lambda arch_config: build_model(arch_config),
                 Model)


def _cfg(arch: str, reduced: bool, overrides: Dict[str, Any]) -> ArchConfig:
    cfg = get_reduced(arch) if reduced else get_config(arch)
    return cfg.with_(**overrides) if overrides else cfg


def _custom_cfg(**kw) -> ArchConfig:
    for key, cls in (("moe", MoEConfig), ("mla", MLAConfig), ("ssm", SSMConfig)):
        if isinstance(kw.get(key), dict):
            kw[key] = cls(**kw[key])
    return ArchConfig(**kw)
