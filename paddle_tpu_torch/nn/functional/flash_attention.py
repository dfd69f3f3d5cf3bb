"""Attention entries: ``flash_attention``, ``flashmask_attention`` and
``make_flashmask_bias`` (port of ``paddle_tpu/nn/functional/flash_attention.py``).

Both entries run the flash-attention kernels (forward, dq, dk/dv) through
:class:`~paddle_tpu_torch.kernels.flash_attention.FlashAttentionFunction`;
on CPU tensors those are the kernels' plain versions. A head dim that is
not a multiple of 64 takes :func:`_xla_attention`, the counterpart of the
JAX package's XLA composition (differentiated by autograd), as the JAX
package's gate sends it there. On the card the kernels take bf16, fp16
and fp32 at head dims 64, 128, 192 and 256 (kernels 14 and 15 on Hopper's
wgmma for bf16 and fp16, with FlashMask tiles that are masked whole
skipped; fp32 on the CUDA cores); a head dim above 256, which the gate lets
through, raises, naming what the kernels do not take.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.kernels.flash_attention import flash_masked
from paddle_tpu_torch.kernels.flash_attention import flash_attention as _flash
from paddle_tpu_torch.kernels.flashmask import flashmask_attention as _flashmask

__all__ = ["flash_attention", "flashmask_attention", "make_flashmask_bias"]

NEG_INF = -1e30  # the JAX package's masked logit


def _no_dropout(dropout: float, training: bool) -> None:
    if dropout and training:
        raise NotImplementedError("attention dropout is not ported yet")


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    dropout: float = 0.0,
    causal: bool = False,
    return_softmax: bool = False,
    fixed_seed_offset=None,
    rng_name: str = "",
    training: bool = True,
    name: Optional[str] = None,
) -> Tuple[torch.Tensor, None]:
    """Paddle's ``flash_attention`` over ``[B, S, H, D]``; returns
    ``(out, None)`` (the softmax is never materialised)."""
    _no_dropout(dropout, training)
    if query.shape[-1] % 64:
        return _xla_attention(query, key, value, causal=causal), None
    return _flash(query, key, value, None, causal=causal), None


def flashmask_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    startend_row_indices: Optional[torch.Tensor] = None,
    dropout: float = 0.0,
    causal: bool = True,
    window_size=None,
    return_softmax_lse: bool = False,
    return_seed_offset: bool = False,
    fixed_seed_offset=None,
    rng_name: str = "",
    training: bool = True,
    name: Optional[str] = None,
) -> torch.Tensor:
    """FlashMask attention: ``startend_row_indices`` int32 ``[B, Hm, Sk, C]``
    (``Hm`` in ``{1, H}``, ``C`` in ``{1, 2, 4}``) gives, per key column, the
    query rows that are masked (see :mod:`paddle_tpu_torch.kernels.flashmask`).
    Without it this is causal :func:`flash_attention`."""
    if window_size is not None or return_softmax_lse or return_seed_offset:
        raise NotImplementedError("flashmask_attention: window_size and the extra returns are not ported")
    _no_dropout(dropout, training)
    if startend_row_indices is None:
        return flash_attention(query, key, value, dropout=dropout, causal=causal, training=training)[0]
    if query.shape[-1] % 64:
        if startend_row_indices.dtype != torch.int32:
            raise TypeError(f"startend_row_indices must be int32, got {startend_row_indices.dtype}")
        bias = make_flashmask_bias(startend_row_indices, query.shape[1], key.shape[1], causal)
        return _xla_attention(query, key, value, bias=bias, causal=causal)
    return _flashmask(query, key, value, startend_row_indices, causal=causal)


def make_flashmask_bias(startend_row_indices: torch.Tensor, sq: int, sk: int, causal: bool) -> torch.Tensor:
    """The FlashMask bounds as a dense additive bias ``[B, Hm, Sq, Sk]``
    (``-1e30`` where masked); like the JAX function it encodes the bounds
    only — ``causal`` is applied by the attention itself."""
    masked = flash_masked(sq, sk, False, startend_row_indices, startend_row_indices.device)
    return torch.where(masked, NEG_INF, 0.0)


def _xla_attention(q, k, v, bias=None, causal=False, scale=None):
    """The JAX package's XLA composition, in fp32 over ``[B, S, H, D]``:
    masked logits are ``-1e30`` (so a fully masked row averages V uniformly).
    The entries run it for head dims that are not a multiple of 64."""
    d = q.shape[-1]
    scale = 1.0 / d**0.5 if scale is None else scale
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh, vh = kh.repeat_interleave(rep, dim=1), vh.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", qh, kh) * scale
    sq, sk = logits.shape[-2:]
    if causal:
        row = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        logits = torch.where(torch.arange(sk, device=q.device)[None, :] <= row, logits, NEG_INF)
    if bias is not None:
        logits = logits + bias.float()
    out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, dim=-1), vh)
    return out.transpose(1, 2).to(q.dtype)
