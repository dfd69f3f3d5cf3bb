"""Plain functionals of the Llama serving and training paths (port of the
pieces of ``paddle_tpu/nn/functional/{common,activation}.py`` they use).

Weights keep Paddle's ``[in, out]`` layout: ``linear`` is ``x @ W``, so the
JAX package's arrays load into the port without a transpose.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.kernels.fused import fused_rms_norm

__all__ = ["linear", "rms_norm", "swiglu"]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W (+ b)`` with ``W`` in Paddle's ``[in, out]`` layout."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``silu(x) * y``, the Llama MLP gate."""
    return F.silu(x) * y


def rms_norm(
    x: torch.Tensor, weight: Optional[torch.Tensor] = None, epsilon: float = 1e-6, upcast: bool = True
) -> torch.Tensor:
    """Paddle's ``rms_norm`` over the last axis. The JAX package's rule picks
    the path: with a weight of ``x``'s dtype, ``upcast`` on and the last
    axis a multiple of 128 it runs the RMSNorm kernels 7 and 8 (fp32
    statistics, the weight applied before the downcast); otherwise the
    unfused composition (statistics in fp32 when ``upcast``, downcast, then
    the weight)."""
    if (
        weight is not None
        and upcast
        and weight.dtype == x.dtype
        and x.shape[-1] % 128 == 0
        and flag("use_pallas_fused")
    ):
        return fused_rms_norm(x, weight, epsilon)
    xf = x.float() if upcast else x
    out = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
