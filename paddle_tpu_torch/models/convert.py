"""Carry the JAX package's Llama and GPT parameters into the port.

The port's module trees and parameter names follow the JAX package's and
its linear weights keep Paddle's ``[in, out]`` layout, so the conversion is
a by-name copy with no transpose. The rope tables are not parameters: the
port recomputes them from the config (the JAX Llama ``state_dict`` carries
them as ``...rotary_emb.{cos,sin}_cached`` buffers, which are skipped).
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core.device import DeviceLike
from paddle_tpu_torch.kernels.quant import quantize_module_weights
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
    state: Mapping[str, np.ndarray], config: Union[LlamaConfig, GPTConfig], device: DeviceLike = None,
    quant_scales: Optional[Mapping[str, np.ndarray]] = None,
) -> Union[LlamaForCausalLM, GPTForPretraining]:
    """A port model holding exactly the given parameters: a
    ``LlamaForCausalLM`` for a ``LlamaConfig``, a ``GPTForPretraining`` for
    a ``GPTConfig``.

    ``state`` maps the JAX package's ``state_dict`` names to numpy arrays; the
    model takes the embedding's dtype. Missing, unexpected or misshapen
    entries raise. A weight-only int8 model (quantized by either package)
    comes with ``quant_scales``: its quantized parameters' names mapped to
    their ``[N]`` fp32 scales (the JAX parameters' ``_quant_scale``). The
    model is then quantized to the port's layout
    (:func:`~paddle_tpu_torch.kernels.quant.quantize_module_weights`) before
    the int8 arrays and the scales are loaded, and the two sets of names must
    agree. An int8 array without a scale raises."""
    if isinstance(config, GPTConfig):
        dtype = _to_tensor(state["gpt.embeddings.word_embeddings.weight"]).dtype
        return _load(GPTForPretraining(config, device=device, dtype=dtype), state, quant_scales)
    if not isinstance(config, LlamaConfig):
        raise TypeError(f"no port model for a {type(config).__name__}")
    params = {k: v for k, v in state.items() if not k.endswith(_ROPE_BUFFERS)}
    dtype = _to_tensor(params["llama.embed_tokens.weight"]).dtype
    return _load(LlamaForCausalLM(config, device=device, dtype=dtype), params, quant_scales)


def _load(model: nn.Module, params: Mapping[str, np.ndarray],
          quant_scales: Optional[Mapping[str, np.ndarray]] = None) -> nn.Module:
    if quant_scales is not None:
        quantized = set(quantize_module_weights(model))
        if quantized != set(quant_scales):
            raise KeyError(f"quant_scales name {sorted(quant_scales)}, but the model quantizes {sorted(quantized)}")
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    unexpected = sorted(set(params) - set(own))
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, unexpected {unexpected}")
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, p in own.items():
            t = _to_tensor(params[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: state shape {tuple(t.shape)} != model shape {tuple(p.shape)}")
            if (t.dtype == torch.int8) != (p.dtype == torch.int8):
                raise TypeError(f"{name}: the state holds {t.dtype} where the model holds {p.dtype} "
                                "(an int8 weight loads with its quant_scales)")
            p.copy_(t)
        for name, scale in (quant_scales or {}).items():
            s = _to_tensor(scale).float()
            mod = modules[name.rsplit(".", 1)[0]]
            if tuple(s.shape) != tuple(mod.weight_scale.shape):
                raise ValueError(f"{name}: scale shape {tuple(s.shape)} != {tuple(mod.weight_scale.shape)}")
            mod.weight_scale.copy_(s)
    return model
