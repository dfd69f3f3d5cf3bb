"""Fused functionals of the serving step (port of the serving entries of
``paddle_tpu/incubate/nn/functional``).

``fused_embed_rms_norm`` and ``fused_rms_norm_residual`` are the kernel
wrappers of ``kernels/fused.py`` (B and C); the paged-cache functions live
in ``block_attention.py``.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels.fused import fused_embed_rms_norm, fused_rms_norm_residual

__all__ = [
    "BlockKVCache",
    "block_cache_append_chunk",
    "block_cache_cow_copy",
    "block_multihead_chunk_attention_fused",
    "fused_embed_rms_norm",
    "fused_rms_norm_residual",
]


def _rope_rotate(x: torch.Tensor, use_neox: bool) -> torch.Tensor:
    if use_neox:
        half = x.shape[-1] // 2
        return torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _rope_apply_xla(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, use_neox: bool) -> torch.Tensor:
    """``x * cos + rotate(x) * sin`` in ``x``'s dtype, tables ``[S, D]``
    (broadcast as ``[1, S, 1, D]``) or already broadcastable. The name is
    the JAX package's (there it is the XLA composition); here it is plain
    PyTorch elementwise ops."""
    if sin.dim() == 2:
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    return x * cos.to(x.dtype) + _rope_rotate(x, use_neox) * sin.to(x.dtype)


from paddle_tpu_torch.incubate.nn.functional.block_attention import (  # noqa: E402
    BlockKVCache,
    block_cache_append_chunk,
    block_cache_cow_copy,
    block_multihead_chunk_attention_fused,
)
