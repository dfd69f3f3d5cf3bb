"""Plain functionals of the Llama and GPT serving and training paths (port
of the pieces of ``paddle_tpu/nn/functional/{common,activation}.py`` they
use).

Weights keep Paddle's ``[in, out]`` layout: ``linear`` is ``x @ W``, so the
JAX package's arrays load into the port without a transpose.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.kernels.fused import fused_rms_norm
from paddle_tpu_torch.kernels.quant import int8_weight_matmul

__all__ = ["gelu", "layer_norm", "linear", "rms_norm", "swiglu", "weight_only_linear"]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W (+ b)`` with ``W`` in Paddle's ``[in, out]`` layout."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def weight_only_linear(
    x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``x @ dequant(W) (+ b)`` with ``W`` int8 ``[in, out]`` and one fp32
    scale per output column (Paddle's ``weight_only_linear``): kernel 20
    (``int8_weight_matmul``), so the dequantized weight never exists.
    Inference only."""
    out = int8_weight_matmul(x, weight, weight_scale)
    return out if bias is None else out + bias


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``silu(x) * y``, the Llama MLP gate."""
    return F.silu(x) * y


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU: the exact erf form by default, the tanh form with
    ``approximate=True`` (Paddle's and ``jax.nn.gelu``'s flag)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def layer_norm(
    x: torch.Tensor,
    normalized_shape: Optional[Union[int, Sequence[int]]] = None,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    epsilon: float = 1e-5,
) -> torch.Tensor:
    """Paddle's ``layer_norm`` as the JAX package composes it: mean,
    ``mean((x - mean)^2)``, ``rsqrt``, then the weight and the bias, every
    op in ``x``'s dtype (no upcast; ``torch.nn.functional.layer_norm``
    computes in fp32 and would round a bf16 row differently). The statistics
    run over the last ``len(normalized_shape)`` axes (the last one when it
    is None)."""
    n = 1 if normalized_shape is None or isinstance(normalized_shape, int) else len(normalized_shape)
    axes = tuple(range(x.dim() - n, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    # rsqrt of the rounded var + eps, rounded once to x's dtype as XLA's is
    # (PyTorch's bf16 rsqrt on the CPU can miss the rounded result by an ulp)
    out = (x - mean) * torch.rsqrt((var + epsilon).float()).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


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
