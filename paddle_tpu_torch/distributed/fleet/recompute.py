"""Activation checkpointing (port of
``paddle_tpu/distributed/fleet/recompute.py``).

The forward segment keeps only its inputs; its intermediate activations are
recomputed during the backward. PyTorch's non-reentrant
``torch.utils.checkpoint`` does the bookkeeping, replaying the CPU and CUDA
RNG states so the rerun draws the same random numbers. A kernel inside the
segment launches twice per step: once in the forward, once in the rerun.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute"]


def recompute(function: Any, *args: Any, **kwargs: Any) -> Any:
    """Run ``function(*args, **kwargs)`` without saving its intermediate
    activations; recompute them in the backward. ``use_reentrant`` is
    accepted for Paddle's signature (the port is always non-reentrant);
    ``preserve_rng_state`` (default True) replays the RNG state."""
    kwargs.pop("use_reentrant", None)
    preserve_rng = bool(kwargs.pop("preserve_rng_state", True))
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    return checkpoint(function, *args, use_reentrant=False, preserve_rng_state=preserve_rng, **kwargs)
