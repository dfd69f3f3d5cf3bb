"""Fused functionals of the serving and training steps (port of their
entries in ``paddle_tpu/incubate/nn/functional``).

``fused_embed_rms_norm``, ``fused_rms_norm_residual`` and
``fused_layer_norm_residual`` run kernels B, C and 12 of
``kernels/fused.py`` where the JAX package runs its Pallas kernels (a
weight of the input's dtype and a last axis that is a multiple of 128),
and elsewhere the exact unfused composition JAX runs. The two residual
norms are differentiable through :class:`ResidualNormFunction`, whose
backward is the adjoint kernel (11 or 13) under the same rule and JAX's
fp32 adjoint formula elsewhere — the JAX entries' tape node. The
paged-cache functions live in ``block_attention.py``;
``fused_rotary_position_embedding`` is the rope of the training forward
(kernels 9 and 10 where the shape allows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.kernels import fused as _kfused
from paddle_tpu_torch.kernels.fused import fused_rope
from paddle_tpu_torch.nn.functional.common import layer_norm, rms_norm

__all__ = [
    "ResidualNormFunction",
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
    "fused_layer_norm_residual",
    "fused_rms_norm_residual",
    "fused_rotary_position_embedding",
]


def _kernel_norm(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """The JAX package's rule for kernels B, C, 11, 12 and 13: the weight in
    the input's dtype and the last axis a multiple of 128 (``rms_norm``'s
    rule too, so where it fails ``rms_norm`` runs the same composition JAX
    runs)."""
    return weight.dtype == x.dtype and x.shape[-1] % 128 == 0 and flag("use_pallas_fused")


def _residual_norm_fwd(x, weight, bias, residual, epsilon: float, is_rms: bool):
    """``(y, r)``: kernel C or 12 where :func:`_kernel_norm` holds, else the
    JAX composition — ``r = x + residual``, then ``rms_norm``'s order
    (fp32 statistics, downcast, then the weight) or ``layer_norm``'s
    (statistics in the I/O dtype, the weight, the bias when present)."""
    if _kernel_norm(x, weight):
        if is_rms:
            return _kfused.fused_rms_norm_residual(x, weight, residual, epsilon)
        return _kfused.ln_residual(x, weight, bias, residual, epsilon)
    r = x + residual
    if is_rms:
        return rms_norm(r, weight, epsilon), r
    return layer_norm(r, None, weight, bias, epsilon), r


def _residual_norm_bwd(g, r, weight, epsilon: float, is_rms: bool):
    """``(d_r, dw, db)`` of the norm half (``db`` None for RMSNorm): the
    adjoint kernel (11 or 13) where :func:`_kernel_norm` holds for ``g``,
    else JAX's fp32 adjoint formula — never autograd of the composition."""
    kernel = _kernel_norm(g, weight)
    if is_rms:
        adjoint = _kfused.rms_residual_bwd if kernel else _kfused.rms_residual_adjoint
        return (*adjoint(g, r, weight, epsilon), None)
    adjoint = _kfused.ln_residual_bwd if kernel else _kfused.ln_residual_adjoint
    return adjoint(g, r, weight, epsilon)


class ResidualNormFunction(torch.autograd.Function):
    """``r = x + residual; y = norm(r)`` with the JAX entries' tape backward:
    the norm's adjoint ``d_r`` from the saved ``r`` (statistics recomputed),
    plus the cotangent of the residual stream ``r`` in the I/O dtype, goes to
    BOTH ``x`` and ``residual`` (the add's adjoint is the identity); ``dw``
    and ``db`` come in the weight's dtype. Only ``r`` and the weight are
    saved."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, epsilon, is_rms):  # noqa: D401 - autograd signature
        y, r = _residual_norm_fwd(x, weight, bias, residual, epsilon, is_rms)
        ctx.save_for_backward(r, weight)
        ctx.epsilon, ctx.is_rms, ctx.y_dtype = epsilon, is_rms, y.dtype
        ctx.set_materialize_grads(False)
        return y, r

    @staticmethod
    def backward(ctx, gy, gr):
        r, weight = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(r.shape, dtype=ctx.y_dtype, device=r.device)
        dr, dw, db = _residual_norm_bwd(gy, r, weight, ctx.epsilon, ctx.is_rms)
        if gr is not None:
            dr = dr + gr.to(dr.dtype)
        need = ctx.needs_input_grad
        return (dr if need[0] else None, dw if need[1] else None, db if need[2] else None,
                dr if need[3] else None, None, None)


def _residual_norm(x, weight, bias, residual, epsilon: float, is_rms: bool):
    """The entry of both residual norms: through :class:`ResidualNormFunction`
    while a gradient is recorded, else the forward alone (the serving step:
    kernel C once per call, nothing saved)."""
    epsilon = float(epsilon)
    tensors = (x, weight, bias, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return ResidualNormFunction.apply(x, weight, bias, residual, epsilon, is_rms)
    return _residual_norm_fwd(x, weight, bias, residual, epsilon, is_rms)


def fused_rms_norm_residual(
    x: torch.Tensor, weight: torch.Tensor, residual: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + residual; y = rms_norm(r) * weight``; returns ``(y, r)``:
    kernel C where :func:`_kernel_norm` holds, else the composition; its
    backward is kernel 11 under the same rule, else JAX's fp32 formula."""
    return _residual_norm(x, weight, None, residual, epsilon, True)


def fused_layer_norm_residual(
    x: torch.Tensor, norm_weight: torch.Tensor, norm_bias: Optional[torch.Tensor], residual: torch.Tensor,
    epsilon: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + residual; y = layer_norm(r, norm_weight, norm_bias)``;
    returns ``(y, r)``: kernel 12 where :func:`_kernel_norm` holds (a
    missing bias counts as zeros), else the composition with statistics in
    the I/O dtype; its backward is kernel 13 under the same rule, else
    JAX's fp32 formula."""
    return _residual_norm(x, norm_weight, norm_bias, residual, epsilon, False)


def fused_embed_rms_norm(
    input_ids: torch.Tensor, embed_weight: torch.Tensor, norm_weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token gather + embedding rows + their RMSNorm; returns ``(emb, y)``:
    kernel B where :func:`_kernel_norm` holds, else the composition (a
    negative id counts from the end, then ids clip to ``[0, V-1]``, as a JAX
    gather does). Inference only: both outputs are cut from the graph on
    every device, as the JAX entry returns them with ``stop_gradient``."""
    with torch.no_grad():
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
