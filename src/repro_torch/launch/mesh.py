"""Device meshes (port of ``repro.launch.mesh``) on
``torch.distributed.device_mesh.init_device_mesh``.

A mesh's dim names are JAX's axis names and its shapes are JAX's:
``(data, model)``; ``(pipe, data, model)`` when ``pp > 1``; ``(pod, data,
model)`` for the multi-pod production mesh.  Here a device is a rank of
the default process group, and a mesh never shrinks to fit: one larger than
the world raises, with JAX's message.

Process groups: the first mesh a process builds initialises the default
group when none exists.  Under ``torchrun`` (``WORLD_SIZE`` set) it comes
from the environment, NCCL on ``cuda`` and gloo on ``cpu``; a one-device
mesh with no ``WORLD_SIZE`` starts a one-rank group itself, on a
``FileStore`` in a temporary directory (how one card runs a plan).
:func:`shutdown` destroys a group this module started.  A dryrun builds
its mesh inside :func:`fake_world`: a one-process group of the mesh's size
that moves no data, where JAX forces 512 host devices.

Functions, not module-level constants: importing this module touches no
device and no process group.  The card's constants are in
:mod:`repro_torch.device`.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Optional, Tuple

_OWN_GROUP: Optional[str] = None   # the FileStore dir of a group we started


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _device_type(device_type: Optional[str]) -> str:
    """The mesh's device type: the caller's, else the card's (``cuda``, or
    ``NoDeviceError`` without one, as every entry point of the port)."""
    if device_type is not None:
        return str(device_type)
    from ..device import resolve_device

    return resolve_device(None).type


def ensure_process_group(n: int, device_type: str) -> int:
    """The default group's world size, initialising the group first when
    none exists: from the environment under ``torchrun``, or a one-rank
    group for a one-device mesh."""
    global _OWN_GROUP
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            import torch

            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend=_backend(device_type))
        return dist.get_world_size()
    if n != 1:
        return 1   # a single process: the caller reports the shortfall
    path = tempfile.mkdtemp(prefix="repro-torch-pg-")
    store = dist.FileStore(os.path.join(path, "store"), 1)
    dist.init_process_group(backend=_backend(device_type), store=store,
                            rank=0, world_size=1)
    _OWN_GROUP = path
    return 1


def process_rank() -> int:
    """This process's rank: the default group's, else ``torchrun``'s
    ``RANK`` (before the first mesh starts the group), else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def shutdown() -> None:
    """Destroy the default process group if this module started it (a
    one-rank group); a ``torchrun`` group is the launcher's to end."""
    global _OWN_GROUP
    import shutil

    import torch.distributed as dist

    if _OWN_GROUP is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(_OWN_GROUP, ignore_errors=True)
    _OWN_GROUP = None


#: the device type of a fake world's meshes: the card's, so that DTensor
#: picks the collectives it picks over NCCL (over a ``cpu`` mesh it trades
#: each all-to-all for an all-gather, gloo having none)
FAKE_DEVICE_TYPE = "cuda"


@contextlib.contextmanager
def fake_world(n: int):
    """The default process group as ``n`` ranks in this one process, over
    the ``fake`` backend, which moves no data: meshes of ``n`` devices
    build on it, and DTensor ops on ``meta`` blocks run as rank 0 runs
    them (JAX's ``--xla_force_host_platform_device_count``).  A one-rank
    group this module started is destroyed first; any other group (a
    launcher's) refuses.  The group is destroyed on exit.

    The store is ``FakeStore`` from ``torch.testing._internal``, a private
    PyTorch API (the test suite's own fake process group), which may move
    between PyTorch versions."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if _OWN_GROUP is None:
            raise RuntimeError(
                f"a fake world of {n} ranks needs this process to itself, "
                f"but a process group of {dist.get_world_size()} ranks is "
                f"up (a launcher's); run the dryrun in a single process")
        shutdown()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type,
          what: str):
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type(device_type)
    n = math.prod(shape)
    have = ensure_process_group(n, device_type)
    if have < n:
        raise RuntimeError(f"need {n} devices{what}, have {have}")
    if have != n:
        # init_device_mesh spans the whole world; a smaller mesh on a
        # larger group would leave ranks out of every collective
        raise RuntimeError(f"a {n}-device mesh{what} on a world of {have} "
                           f"ranks: launch {n} processes")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type, " for the production mesh")


def make_local_mesh(dp: int = 1, tp: int = 1, pp: int = 1, device_type=None):
    """Small mesh over the ranks that exist (tests / smoke runs).

    ``pp > 1`` prepends a ``pipe`` axis — the 3D ``(pipe, data, model)``
    mesh pipelined plans compose over; the 2-axis shape is unchanged
    otherwise."""
    if pp > 1:
        return _mesh((pp, dp, tp), ("pipe", "data", "model"), device_type, "")
    return _mesh((dp, tp), ("data", "model"), device_type, "")


def pipe_of(mesh, axis: str = "pipe"):
    """The GPipe schedule's handles on ``mesh``'s dim ``axis``: a
    :class:`~repro_torch.sharding.pipeline.Pipe` with the dim's process
    group, its size, this rank's coordinate on it, and the submesh of the
    other dims (``mesh["data", "model"]`` for the local ``(pipe, data,
    model)`` mesh), where each stage's body runs."""
    from ..sharding.pipeline import Pipe

    names = list(mesh.mesh_dim_names)
    rest = tuple(n for n in names if n != axis)
    return Pipe(group=mesh.get_group(axis), size=mesh.size(names.index(axis)),
                rank=mesh.get_local_rank(axis), axis=axis, mesh=mesh,
                stage_mesh=mesh[rest] if rest else None)


def make_split_mesh(dp: int, tp: int, device_type=None):
    """Re-split a pod's chips into a dp x tp ("data", "model") mesh — the
    dry-run's mesh-split knob (e.g. 32x8 over the same 256)."""
    return _mesh((dp, tp), ("data", "model"), device_type,
                 f" for a {dp}x{tp} split")


# ---------------------------------------------------------------------------
# Mesh providers: the registry's mesh components.  Construction is DATA (no
# device or process group is touched at resolve time); ``build()`` makes the
# mesh, once.
# ---------------------------------------------------------------------------
class MeshProvider:
    """Base provider: lazy, cached mesh construction.  ``build`` takes the
    device type the run is on (the gym passes its device's); None is the
    card.  ``n_devices`` is the size of the mesh it builds (0: none), the
    world a dryrun fakes for it."""

    _UNSET = object()
    n_devices = 0

    def __init__(self) -> None:
        self._mesh = self._UNSET

    def build(self, device_type: Optional[str] = None):
        if self._mesh is self._UNSET:
            self._mesh = self._make(device_type)
        return self._mesh

    def _make(self, device_type):  # pragma: no cover - overridden
        raise NotImplementedError


class SingleDeviceMesh(MeshProvider):
    """No mesh: the gym runs un-sharded on one device."""

    def _make(self, device_type):
        return None


class LocalMesh(MeshProvider):
    def __init__(self, dp: int = 1, tp: int = 1, pp: int = 1) -> None:
        super().__init__()
        self.dp, self.tp, self.pp = int(dp), int(tp), int(pp)
        self.n_devices = self.dp * self.tp * self.pp

    def _make(self, device_type):
        return make_local_mesh(self.dp, self.tp, self.pp,
                               device_type=device_type)


class ProductionMesh(MeshProvider):
    def __init__(self, multi_pod: bool = False) -> None:
        super().__init__()
        self.multi_pod = bool(multi_pod)
        self.n_devices = 512 if self.multi_pod else 256

    def _make(self, device_type):
        return make_production_mesh(multi_pod=self.multi_pod,
                                    device_type=device_type)


class SplitMesh(MeshProvider):
    def __init__(self, dp: int, tp: int) -> None:
        super().__init__()
        self.dp, self.tp = int(dp), int(tp)
        self.n_devices = self.dp * self.tp

    def _make(self, device_type):
        return make_split_mesh(self.dp, self.tp, device_type=device_type)
