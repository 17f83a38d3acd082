"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``.cu`` source under a kernel's ``csrc/`` is compiled on its own by
``nvcc`` into a shared library with a plain C interface (no PyTorch headers,
so a build takes seconds).  The library lands in ``build/repro_torch_kernels``
at the repo root (listed in ``.gitignore``) or in ``$REPRO_TORCH_BUILD_DIR``,
named after a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  ``build_all`` starts one ``nvcc``
per source, all together, and waits for them.

Nothing here runs at import: the CPU tests import every module on a host
with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: every kernel source of the port, by library name
SOURCES: Dict[str, Path] = {
    "flash_fwd": Path(__file__).resolve().parent / "flash" / "csrc" / "flash_fwd.cu",
    "ssd_scan": Path(__file__).resolve().parent / "ssd" / "csrc" / "ssd_scan.cu",
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per library: seconds its nvcc took (0.0 when reused) and ptxas's report
build_info: Dict[str, Dict[str, object]] = {}


class KernelBuildError(RuntimeError):
    pass


def build_dir() -> Path:
    d = Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                            _REPO_ROOT / "build" / "repro_torch_kernels"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin); the port's "
                           "CUDA kernels are built on the machine with the card")


def _target(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        build_info.setdefault(name, {"seconds": 0.0, "log": "(cached)"})
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}


def build_all(names: List[str] = None) -> Dict[str, Dict[str, object]]:
    """Compile every listed source in parallel (one nvcc each)."""
    names = list(SOURCES) if names is None else names
    with _lock:
        started = {n: _start(n) for n in names}
        for n in names:
            _finish(n, started[n])
    return {n: build_info[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def refuse_dtensor(what, tensors):
    """Each kernel wrapper's first check.  Under a mesh the model calls a
    wrapper on each rank's local blocks (``models.base.local_call``), so a
    DTensor reaches one only by mistake: it raises rather than drop to the
    plain version."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what}: got a DTensor; call the kernel on each "
                        f"rank's local tensors (models.base.local_call)")
