"""Carry the JAX package's Llama and GPT parameters into the port.

The port's module trees and parameter names follow the JAX package's and
its linear weights keep Paddle's ``[in, out]`` layout, so the conversion is
a by-name copy with no transpose. The rope tables are not parameters: the
port recomputes them from the config (the JAX Llama ``state_dict`` carries
them as ``...rotary_emb.{cos,sin}_cached`` buffers, which are skipped).
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core.device import DeviceLike
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_paddle_tpu_state"]

_ROPE_BUFFERS = ("rotary_emb.cos_cached", "rotary_emb.sin_cached")


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # a private, writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_paddle_tpu_state(
    state: Mapping[str, np.ndarray], config: Union[LlamaConfig, GPTConfig], device: DeviceLike = None
) -> Union[LlamaForCausalLM, GPTForPretraining]:
    """A port model holding exactly the given parameters: a
    ``LlamaForCausalLM`` for a ``LlamaConfig``, a ``GPTForPretraining`` for
    a ``GPTConfig``.

    ``state`` maps the JAX package's ``state_dict`` names to numpy arrays; the
    model takes their dtype. Missing, unexpected or misshapen entries raise."""
    if isinstance(config, GPTConfig):
        dtype = _to_tensor(state["gpt.embeddings.word_embeddings.weight"]).dtype
        return _load(GPTForPretraining(config, device=device, dtype=dtype), state)
    if not isinstance(config, LlamaConfig):
        raise TypeError(f"no port model for a {type(config).__name__}")
    params = {k: v for k, v in state.items() if not k.endswith(_ROPE_BUFFERS)}
    dtype = _to_tensor(params["llama.embed_tokens.weight"]).dtype
    return _load(LlamaForCausalLM(config, device=device, dtype=dtype), params)


def _load(model: nn.Module, params: Mapping[str, np.ndarray]) -> nn.Module:
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
