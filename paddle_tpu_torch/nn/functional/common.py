"""Plain functionals of the Llama serving and training paths (port of the
pieces of ``paddle_tpu/nn/functional/{common,activation}.py`` they use).

Weights keep Paddle's ``[in, out]`` layout: ``linear`` is ``x @ W``, so the
JAX package's arrays load into the port without a transpose.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["linear", "rms_norm", "swiglu"]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W (+ b)`` with ``W`` in Paddle's ``[in, out]`` layout."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``silu(x) * y``, the Llama MLP gate."""
    return F.silu(x) * y


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, epsilon: float = 1e-6) -> torch.Tensor:
    """Paddle's ``rms_norm``: fp32 statistics, downcast, then the weight (the
    unfused order; the fused kernels apply the weight before the downcast)."""
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
