"""Plain functionals of the Llama and GPT serving and training paths (port
of the pieces of ``paddle_tpu/nn/functional/{common,activation}.py`` they
use), dropout among them.

Weights keep Paddle's ``[in, out]`` layout: ``linear`` is ``x @ W``, so the
JAX package's arrays load into the port without a transpose.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.kernels.fused import fused_rms_norm
from paddle_tpu_torch.kernels.quant import int8_weight_matmul

__all__ = ["dropout", "gelu", "layer_norm", "linear", "rms_norm", "swiglu", "weight_only_linear"]

DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(
    x: torch.Tensor, p: float = 0.5, axis: Optional[Union[int, Sequence[int]]] = None, training: bool = True,
    mode: str = "upscale_in_train", name: Optional[str] = None, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Paddle's ``dropout``, as the JAX package computes it: in training with
    ``p > 0`` each element is kept with probability ``1 - p`` (a Bernoulli
    mask drawn from ``generator``, by default the port's generator of
    ``x``'s device, ``core/rng.py``), the kept ones divided by ``1 - p``
    (``upscale_in_train``; ``1 - p`` rounded to ``x``'s dtype first, as
    JAX's weakly typed scalar is) or left as they are
    (``downscale_in_infer``), the rest exact 0. ``axis`` (an int or a
    list) names the dims the mask varies over; it is broadcast over the
    others. In eval mode or at ``p == 0`` the result is ``x`` itself, in
    both modes (the JAX package scales nothing at inference either)."""
    if mode not in DROPOUT_MODES:
        raise ValueError(f"dropout: mode must be one of {DROPOUT_MODES}, not {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must be in [0, 1], not {p}")
    if not training or p == 0.0:
        return x
    keep = 1.0 - float(p)
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in ([axis] if isinstance(axis, int) else axis)}
        shape = [n if d in axes else 1 for d, n in enumerate(shape)]
    mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=rng.generator_for(x, generator)).bool()
    kept = x / float(torch.tensor(keep, dtype=x.dtype)) if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype, device=x.device))


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
