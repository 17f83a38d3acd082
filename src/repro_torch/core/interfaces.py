"""The component interfaces (IFs) of the port: the contracts its registry
validates against (port of ``repro.core.interfaces``; the paper: "pluggable
components each implementing one of the pre-defined interfaces").

Most IFs are structural: a lightweight ABC or an existing concrete class.
A new component only has to satisfy the IF to compose with everything else
(checkpointing, evaluation, the gym).  The ABCs are copied from the JAX
package; :func:`register_builtin_interfaces` binds each component key to the
port's own classes, ``sharding_plan`` to the port's ``ShardingPlan``.
"""
from __future__ import annotations

import abc
from typing import Any, Dict


class OptimizerIF(abc.ABC):
    @abc.abstractmethod
    def init(self, params): ...

    @abc.abstractmethod
    def update(self, grads, state, params): ...


class TokenizerIF(abc.ABC):
    @abc.abstractmethod
    def encode(self, text: str, bos: bool = False, eos: bool = False): ...

    @abc.abstractmethod
    def decode(self, ids): ...


class DatasetIF(abc.ABC):
    @abc.abstractmethod
    def __len__(self): ...

    @abc.abstractmethod
    def sample(self, i: int): ...


class LoaderIF(abc.ABC):
    @abc.abstractmethod
    def batches(self, steps: int, start_step: int = 0): ...


class MeshProviderIF(abc.ABC):
    @abc.abstractmethod
    def build(self): ...


class TrackerIF(abc.ABC):
    """Metric sink (stdout/jsonl/...)."""

    @abc.abstractmethod
    def __call__(self, metrics: Dict[str, Any]) -> None: ...


class CheckpointerIF(abc.ABC):
    """Checkpoint engine: async-capable save + restore.

    ``save`` must have issued its device snapshot before returning (the
    gym updates the state's tensors in place at the next step); ``wait``
    blocks until every queued save is durably committed and re-raises
    background failures.
    """

    @abc.abstractmethod
    def save(self, state, step: int, extra=None) -> None: ...

    @abc.abstractmethod
    def wait(self) -> None: ...

    @abc.abstractmethod
    def latest(self): ...

    @abc.abstractmethod
    def restore(self, state_like, shardings=None, path=None): ...


#: component_key -> interface. Plain classes act as structural IFs.
INTERFACES: Dict[str, type] = {}


def register_builtin_interfaces() -> Dict[str, type]:
    from ..configs.shapes import InputShape
    from ..models.base import ArchConfig, Model
    from ..sharding.plans import ShardingPlan
    from .gym import Gym

    INTERFACES.update(
        {
            "model": Model,
            "arch_config": ArchConfig,
            "optimizer": OptimizerIF,
            "lr_schedule": object,       # callables: validated by signature
            "tokenizer": TokenizerIF,
            "dataset": DatasetIF,
            "loader": LoaderIF,
            "sharding_plan": ShardingPlan,
            "mesh_provider": MeshProviderIF,
            "shape": InputShape,
            "precision": object,
            "remat_policy": object,
            "gym": Gym,
            "tracker": TrackerIF,
            "checkpointer": CheckpointerIF,
            "exporter": object,
        }
    )
    return INTERFACES
