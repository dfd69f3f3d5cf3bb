"""Device choice for the port's entry points.

The port runs on the card. A caller that wants the CPU (the tests, a
reference run) says so with ``device="cpu"``; nothing here falls back to the
CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["default_device", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """``cuda`` — or an error when no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a caller asked for, else :func:`default_device`."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was requested but CUDA is not available")
    return dev

