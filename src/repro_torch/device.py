"""Where the port's entry points run.

Every entry point takes ``device=None``, which means the card: ``cuda``
when PyTorch sees one, and an error when it does not.  The CPU is used only
when the caller asks for it (``device="cpu"``), as the CPU tests do — a run
that meant to measure the card never goes on silently on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

#: NVIDIA H100 SXM5, dense bf16 tensor-core peak in FLOP/s: half the data
#: sheet's 1,979 TFLOPS, which counts 2:4 structured sparsity.  ``mfu``
#: divides by it (JAX divides by its modeled TPU's, ``launch/mesh.py``); on
#: a host without a card the value is the modeled utilization against it.
PEAK_FLOPS_BF16 = 989.4e12
#: the same card's HBM3 bandwidth in bytes/s (data sheet)
HBM_BYTES_S = 3.35e12
#: the same card's NVLink 4 bandwidth in bytes/s, one direction (the data
#: sheet's 900 GB/s counts both).  The dryrun's collective term divides
#: every collective's bytes by it, as if every collective crossed NVLink:
#: optimistic for a mesh axis wider than a node's 8 cards (the production
#: mesh's 16-wide ``model`` axis), whose hops cross the network
NVLINK_BYTES_S = 450e9


class NoDeviceError(RuntimeError):
    """No CUDA device, and the caller did not ask for the CPU."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port's plain PyTorch path on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(f"device {device!r} asked for, but no CUDA "
                            f"device is visible")
    return dev


class MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device: ``model.init``
    makes its leaves on ``gen.device``, so it builds shapes and dtypes only
    (factories on ``meta`` draw no numbers) — the port's
    ``jax.eval_shape``."""

    @property
    def device(self):
        return torch.device("meta")
