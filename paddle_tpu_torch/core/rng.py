"""The port's random state (counterpart of ``paddle_tpu/core/rng.py``).

One ``torch.Generator`` per device, made on first use from the global seed
(0 until :func:`seed` sets it). Every random draw of the port — dropout,
attention dropout — takes an explicit generator and defaults to
:func:`default_generator` of its tensor's device, never torch's global
state. ``recompute`` snapshots these generators around a segment, as the
JAX package snapshots its key, so a recomputed dropout draws the forward's
mask. The draws are PyTorch's, not JAX's: the two packages seed alike but
do not draw the same masks.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Union

import torch

from paddle_tpu_torch.core.device import DeviceLike

__all__ = ["default_generator", "get_rng_state", "seed", "set_rng_state"]

_lock = threading.Lock()
_seed = 0
_generators: Dict[torch.device, torch.Generator] = {}


def _key(device: DeviceLike) -> torch.device:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device: DeviceLike = None) -> torch.Generator:
    """The port's generator of ``device`` (the CPU when None), made from
    the global seed on first use."""
    dev = _key(device)
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = _generators[dev] = torch.Generator(device=dev).manual_seed(_seed)
        return gen


def seed(value: int) -> None:
    """Set the global seed (``paddle.seed``): every generator of the port,
    made or still to be made, restarts from it."""
    global _seed
    with _lock:
        _seed = int(value)
        for gen in _generators.values():
            gen.manual_seed(_seed)


def get_rng_state(device: DeviceLike = None) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """The state of ``device``'s generator; with no device, every
    generator's, keyed by device."""
    if device is not None:
        return default_generator(device).get_state()
    with _lock:
        return {str(dev): gen.get_state() for dev, gen in _generators.items()}


def set_rng_state(state: Union[torch.Tensor, Dict[str, torch.Tensor]], device: DeviceLike = None) -> None:
    """Restore what :func:`get_rng_state` returned (one device's state with
    ``device``, else the dict of every device's)."""
    if device is not None or isinstance(state, torch.Tensor):
        default_generator(device).set_state(state)
        return
    for dev, st in state.items():
        default_generator(dev).set_state(st)


def snapshot(devices: Iterable[torch.device] = ()) -> Dict[str, torch.Tensor]:
    """Every generator's state, making those of ``devices`` first (a
    segment about to draw on them must find them in the snapshot)."""
    for dev in devices:
        default_generator(dev)
    return get_rng_state()


def generator_for(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Generator:
    """``generator`` if given, else the port's generator of ``t``'s device."""
    return generator if generator is not None else default_generator(t.device)
