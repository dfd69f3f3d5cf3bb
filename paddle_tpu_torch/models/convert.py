"""Carry the JAX package's Llama parameters into the port.

The port's module tree and parameter names follow the JAX package's and its
linear weights keep Paddle's ``[in, out]`` layout, so the conversion is a
by-name copy with no transpose. The rope tables are not parameters: the port
recomputes them from the config (the JAX ``state_dict`` carries them as
``...rotary_emb.{cos,sin}_cached`` buffers, which are skipped).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from paddle_tpu_torch.core.device import DeviceLike
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_paddle_tpu_state"]

_ROPE_BUFFERS = ("rotary_emb.cos_cached", "rotary_emb.sin_cached")


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # a private, writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_paddle_tpu_state(
    state: Mapping[str, np.ndarray], config: LlamaConfig, device: DeviceLike = None
) -> LlamaForCausalLM:
    """A port ``LlamaForCausalLM`` holding exactly the given parameters.

    ``state`` maps the JAX package's ``state_dict`` names to numpy arrays; the
    model takes their dtype. Missing, unexpected or misshapen entries raise."""
    params = {k: v for k, v in state.items() if not k.endswith(_ROPE_BUFFERS)}
    dtype = _to_tensor(params["llama.embed_tokens.weight"]).dtype
    model = LlamaForCausalLM(config, device=device, dtype=dtype)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    unexpected = sorted(set(params) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for name, p in own.items():
            t = _to_tensor(params[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: state shape {tuple(t.shape)} != model shape {tuple(p.shape)}")
            p.copy_(t)
    return model
