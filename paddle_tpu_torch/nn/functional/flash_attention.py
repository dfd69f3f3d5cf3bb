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

Attention dropout (``dropout > 0`` in training) takes the composition, as
the JAX package sends it to ``_xla_attention``: fp32 softmax, then
``where(keep, probs / (1 - p), 0)`` with a Bernoulli ``keep`` mask drawn
from the port's generator of q's device (``core/rng.py``). It is the
reference's own route: the flash kernels are not launched on it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.kernels.flash_attention import flash_masked
from paddle_tpu_torch.kernels.flash_attention import flash_attention as _flash
from paddle_tpu_torch.kernels.flashmask import flashmask_attention as _flashmask

__all__ = ["flash_attention", "flashmask_attention", "make_flashmask_bias"]

NEG_INF = -1e30  # the JAX package's masked logit


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
    ``(out, None)`` (the softmax is never materialised). With ``dropout >
    0`` in training the composition runs with attention dropout;
    ``return_softmax``, ``fixed_seed_offset`` and ``rng_name`` are accepted
    and ignored, as in the JAX package."""
    if dropout > 0.0 and training:
        return _xla_attention(query, key, value, causal=causal, dropout=dropout,
                              generator=rng.default_generator(query.device)), None
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
    Without it this is :func:`flash_attention` with ``dropout`` (called, as
    the JAX package calls it, without ``training``, so in training mode).
    Exactly as in the JAX package, ``window_size``,
    ``return_softmax_lse``, ``return_seed_offset``, ``fixed_seed_offset``,
    ``rng_name`` and ``training`` are accepted and ignored (the output is
    the only return), and so is ``dropout`` with ``startend_row_indices``."""
    if startend_row_indices is None:
        return flash_attention(query, key, value, dropout=dropout, causal=causal)[0]
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


def _xla_attention(q, k, v, bias=None, causal=False, scale=None, dropout=0.0, generator=None):
    """The JAX package's XLA composition, in fp32 over ``[B, S, H, D]``:
    masked logits are ``-1e30`` (so a fully masked row averages V uniformly).
    The entries run it for head dims that are not a multiple of 64, and for
    attention dropout: with ``dropout > 0`` the fp32 probabilities become
    ``where(keep, probs / (1 - dropout), 0)``, ``keep`` a Bernoulli mask
    of ``1 - dropout`` drawn from ``generator``."""
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
    probs = torch.softmax(logits, dim=-1)
    if dropout > 0.0:
        keep = torch.empty_like(probs).bernoulli_(1.0 - dropout, generator=generator).bool()
        probs = torch.where(keep, probs / (1.0 - dropout), 0.0)
    out = torch.einsum("bhst,bhtd->bhsd", probs, vh)
    return out.transpose(1, 2).to(q.dtype)
