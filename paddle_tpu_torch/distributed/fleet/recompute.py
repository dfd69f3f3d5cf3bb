"""Activation checkpointing (port of
``paddle_tpu/distributed/fleet/recompute.py``).

The forward segment keeps only its inputs; its intermediate activations are
recomputed during the backward. PyTorch's non-reentrant
``torch.utils.checkpoint`` does the bookkeeping. Its ``preserve_rng_state``
replays only torch's global CPU and CUDA states, and the port draws from
its own generators (``core/rng.py``), so with ``preserve_rng_state`` (the
default) the port's generators are snapshotted before the segment, set back
to that snapshot for the rerun and returned afterwards to where they were,
as the JAX package snapshots and restores its key: a dropout in the segment
draws the forward's mask again. A kernel inside the segment launches twice
per step: once in the forward, once in the rerun.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core import rng

__all__ = ["recompute"]


def recompute(function: Any, *args: Any, **kwargs: Any) -> Any:
    """Run ``function(*args, **kwargs)`` without saving its intermediate
    activations; recompute them in the backward. ``use_reentrant`` is
    accepted for Paddle's signature (the port is always non-reentrant);
    ``preserve_rng_state`` (default True) replays the random state."""
    kwargs.pop("use_reentrant", None)
    preserve_rng = bool(kwargs.pop("preserve_rng_state", True))
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    if not preserve_rng:
        return checkpoint(function, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)
    devices = {a.device for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)}
    forward_state = rng.snapshot(devices)
    calls = [0]

    def segment(*a: Any, **k: Any) -> Any:
        calls[0] += 1
        if calls[0] == 1:  # the forward
            return function(*a, **k)
        after = rng.get_rng_state()
        rng.set_rng_state(forward_state)
        try:
            return function(*a, **k)
        finally:
            rng.set_rng_state(after)

    return checkpoint(segment, *args, use_reentrant=False, preserve_rng_state=True, **kwargs)
