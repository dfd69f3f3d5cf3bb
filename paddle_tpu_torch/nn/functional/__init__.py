"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``):
the plain ops of the Llama and GPT paths, the attention entries, and the
loss."""

from paddle_tpu_torch.nn.functional.common import gelu, layer_norm, linear, rms_norm, swiglu, weight_only_linear
from paddle_tpu_torch.nn.functional.flash_attention import (
    flash_attention,
    flashmask_attention,
    make_flashmask_bias,
)
from paddle_tpu_torch.nn.functional.loss import cross_entropy, fused_linear_cross_entropy

__all__ = [
    "cross_entropy",
    "flash_attention",
    "flashmask_attention",
    "fused_linear_cross_entropy",
    "gelu",
    "layer_norm",
    "linear",
    "make_flashmask_bias",
    "rms_norm",
    "swiglu",
    "weight_only_linear",
]
