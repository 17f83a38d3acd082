"""Where the port's entry points run.

Every entry point takes ``device=None``, which means the card: ``cuda``
when PyTorch sees one, and an error when it does not.  The CPU is used only
when the caller asks for it (``device="cpu"``), as the CPU tests do — a run
that meant to measure the card never goes on silently on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


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
