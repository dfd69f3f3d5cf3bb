"""``LayerNorm`` (port of ``paddle_tpu/nn/layer/norm.py``)."""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from paddle_tpu_torch.core.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes with a weight
    (ones) and a bias (zeros), through :func:`F.layer_norm`: the JAX
    package's composition, statistics in the input's dtype."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]], epsilon: float = 1e-5,
                 device: DeviceLike = None, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        dev = resolve_device(device)
        shape = [normalized_shape] if isinstance(normalized_shape, int) else list(normalized_shape)
        self.normalized_shape, self.epsilon = shape, float(epsilon)
        self.weight = nn.Parameter(torch.ones(shape, device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(shape, device=dev, dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.epsilon)
