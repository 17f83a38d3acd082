"""Checkpointing of the port (``repro.ckpt``'s counterpart): the same
format on disk, so each package reads the other's checkpoints.

- :mod:`.format` — per-leaf shard files keyed by tree path + a JSON
  manifest (step, shapes, dtypes, spec), atomic commits.
- :mod:`.engine` — :class:`AsyncCheckpointer`: device-to-host snapshot on
  the hot path, background serialization, retention policies.
- :mod:`.elastic` — restore into a train state under any plan and mesh
  (or onto one device), with dtype-cast rules and lossy-cast warnings.
- :mod:`.export` — HF-style flat export (unstacked layer dims).

Registry components: ``checkpointer/async``, ``checkpointer/sync``.
"""
from .elastic import (  # noqa: F401
    LossyCastWarning,
    RestoreError,
    restore,
    restore_train_state,
    saved_step,
)
from .engine import AsyncCheckpointer, RetentionPolicy  # noqa: F401
from .export import export_flat  # noqa: F401
from .format import (  # noqa: F401
    latest_checkpoint,
    list_checkpoints,
    read_manifest,
    write_checkpoint,
)
