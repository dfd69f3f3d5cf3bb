"""Fused functionals of the serving and training steps (port of their
entries in ``paddle_tpu/incubate/nn/functional``).

``fused_embed_rms_norm`` and ``fused_rms_norm_residual`` run kernels B and
C of ``kernels/fused.py`` where the JAX package runs its Pallas kernels
(a weight of the input's dtype and a last axis that is a multiple of 128),
and elsewhere the exact unfused composition JAX runs; the paged-cache
functions live in ``block_attention.py``; ``fused_rotary_position_embedding``
is the rope of the training forward (kernels 9 and 10 where the shape
allows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.kernels import fused as _kfused
from paddle_tpu_torch.kernels.fused import fused_rope
from paddle_tpu_torch.nn.functional.common import rms_norm

__all__ = [
    "BlockKVCache",
    "block_cache_append",
    "block_cache_append_chunk",
    "block_cache_cow_copy",
    "block_cache_prefill",
    "block_multihead_attention",
    "block_multihead_attention_fused",
    "block_multihead_chunk_attention",
    "block_multihead_chunk_attention_fused",
    "fused_embed_rms_norm",
    "fused_rms_norm_residual",
    "fused_rotary_position_embedding",
]


def _kernel_norm(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """The JAX package's rule for kernels B and C: the weight in the input's
    dtype and the last axis a multiple of 128 (``rms_norm``'s rule too, so
    where it fails ``rms_norm`` runs the same composition JAX runs)."""
    return weight.dtype == x.dtype and x.shape[-1] % 128 == 0 and flag("use_pallas_fused")


def fused_rms_norm_residual(
    x: torch.Tensor, weight: torch.Tensor, residual: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + residual; y = rms_norm(r) * weight``; returns ``(y, r)``:
    kernel C where :func:`_kernel_norm` holds, else the composition."""
    if _kernel_norm(x, weight):
        return _kfused.fused_rms_norm_residual(x, weight, residual, epsilon)
    r = x + residual
    return rms_norm(r, weight, float(epsilon)), r


def fused_embed_rms_norm(
    input_ids: torch.Tensor, embed_weight: torch.Tensor, norm_weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token gather + embedding rows + their RMSNorm; returns ``(emb, y)``:
    kernel B where :func:`_kernel_norm` holds, else the composition (a
    negative id counts from the end, then ids clip to ``[0, V-1]``, as a JAX
    gather does)."""
    if _kernel_norm(embed_weight, norm_weight):
        return _kfused.fused_embed_rms_norm(input_ids, embed_weight, norm_weight, epsilon)
    v = embed_weight.shape[0]
    ids = input_ids.long()
    emb = embed_weight[torch.where(ids < 0, ids + v, ids).clamp(0, v - 1)]
    return emb, rms_norm(emb, norm_weight, float(epsilon))


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


def _rope_kernel_tables(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, use_neox: bool
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(cos, sin)`` in the kernels' ``[S, D]`` layout when this shape is
    kernel-eligible (the JAX package's rule), else None: neox, ``D % 128 ==
    0``, and tables ``[S, D]`` or with a leading 1 (``[1, S, 1, D]``).
    Per-batch tables (a leading dim > 1, ragged positions) cannot collapse
    to ``[S, D]``: composition only."""
    if not use_neox or x.shape[-1] % 128:
        return None
    if cos.dim() == 2:
        return cos, sin
    if cos.shape[0] == 1:
        return cos.reshape(cos.shape[1], cos.shape[-1]), sin.reshape(sin.shape[1], sin.shape[-1])
    return None


def fused_rotary_position_embedding(
    q: torch.Tensor,
    k: Optional[torch.Tensor] = None,
    v: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    cos: Optional[torch.Tensor] = None,
    position_ids=None,
    use_neox_rotary_style: bool = True,
    time_major: bool = False,
) -> Tuple[Optional[torch.Tensor], ...]:
    """RoPE over ``[B, S, H, D]`` q/k/v with ``sin``/``cos`` tables ``[S, D]``
    (or broadcastable to ``[B, S, 1, D]``); the caller builds the tables
    (``LlamaRotaryEmbedding``). Returns the roped tensors in the order given, padded with
    ``None`` to three (the JAX entry's packing).

    Each tensor, q then k then v, takes one call: where the shape is
    kernel-eligible (:func:`_rope_kernel_tables`) the rope kernel (9) with
    its adjoint kernel (10) as the ``x`` gradient; elsewhere
    ``_rope_apply_xla``, whose gradient is autograd's adjoint of
    ``x * cos + rotate(x) * sin`` (the JAX package's ``_rope_adjoint_xla``)."""
    if position_ids is not None or time_major:
        raise NotImplementedError("fused_rotary_position_embedding: position_ids and time_major are not ported")
    if sin is None or cos is None:
        raise ValueError("fused_rotary_position_embedding: pass the sin and cos tables")
    outs = []
    for t in (q, k, v):
        if t is None:
            continue
        tabs = _rope_kernel_tables(t, sin, cos, use_neox_rotary_style) if flag("use_pallas_fused") else None
        outs.append(fused_rope(t, *tabs) if tabs is not None else _rope_apply_xla(t, sin, cos, use_neox_rotary_style))
    return tuple(outs + [None] * (3 - len(outs)))


from paddle_tpu_torch.incubate.nn.functional.block_attention import (  # noqa: E402
    BlockKVCache,
    block_cache_append,
    block_cache_append_chunk,
    block_cache_cow_copy,
    block_cache_prefill,
    block_multihead_attention,
    block_multihead_attention_fused,
    block_multihead_chunk_attention,
    block_multihead_chunk_attention_fused,
)
