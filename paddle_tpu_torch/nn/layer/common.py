"""``Linear``, ``Embedding`` and ``Dropout`` (port of
``paddle_tpu/nn/layer/common.py``).

Weights keep Paddle's layouts (``Linear``'s ``[in, out]``), so the JAX
package's arrays load by name without a transpose. Each layer is made on
the device and in the dtype it is given and draws its initial values from
a seeded ``torch.Generator`` (a model reseeds them all from its own seed).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.core.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn import functional as F

__all__ = ["Dropout", "Embedding", "INIT_STD", "Linear", "linear_forward"]

INIT_STD = 0.02  # std of the seeded random matrices and embeddings


def linear_forward(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The forward of a projection layer with a Paddle ``[in, out]``
    ``weight`` and an optional ``bias``: ``F.weight_only_linear`` when the
    layer carries a ``weight_scale`` (its weight quantized in place by
    ``kernels.quant.quantize_module_weights``), else ``F.linear`` — the JAX
    ``nn.Linear.forward``'s dispatch on ``_quant_scale``. Every ``Linear``
    of the port runs it."""
    bias = getattr(layer, "bias", None)
    scale = getattr(layer, "weight_scale", None)
    if scale is not None:
        return F.weight_only_linear(x, layer.weight, scale, bias)
    return F.linear(x, layer.weight, bias)


def _refuse_int8(layer: nn.Module) -> None:
    if not layer.weight.is_floating_point():
        raise RuntimeError(f"{type(layer).__name__}: the weight is quantized to {layer.weight.dtype}; "
                           "reset_parameters draws floating weights only")


def _generator(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=t.device).manual_seed(0)


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` of Paddle's ``[in, out]`` layout and an
    optional bias (``bias=False``: none, Paddle's ``bias_attr=False``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty((in_features, out_features), device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.empty((out_features,), device=dev, dtype=dtype)) if bias else None
        # [out] fp32 scales once the weight is quantized to int8 in place
        self.register_buffer("weight_scale", None)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 0.02) weight, zero bias; refused once the weight is int8."""
        _refuse_int8(self)
        self.weight.normal_(0.0, INIT_STD, generator=_generator(self.weight, generator))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_forward(self, x)


class Embedding(nn.Module):
    """A ``[num_embeddings, embedding_dim]`` table looked up by integer ids."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.weight = nn.Parameter(torch.empty((num_embeddings, embedding_dim), device=dev, dtype=dtype))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 0.02) rows."""
        self.weight.normal_(0.0, INIT_STD, generator=_generator(self.weight, generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.embedding(ids.long(), self.weight)


class Dropout(nn.Module):
    """Dropout. Only what the ported models run: the identity in eval mode
    or at ``p == 0``; ``p > 0`` in train mode raises (ROADMAP Queue 1 item
    3: the port has no dropout yet)."""

    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.p > 0:
            raise NotImplementedError(f"Dropout(p={self.p}) in train mode is not ported yet (ROADMAP Queue 1 item 3)")
        return x
