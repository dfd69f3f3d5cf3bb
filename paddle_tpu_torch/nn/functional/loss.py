"""Softmax cross entropy (hard and soft labels, class weights, label
smoothing) and the fused linear cross entropy of the loss head (port of
``paddle_tpu/nn/functional/loss.py`` ``cross_entropy`` and
``fused_linear_cross_entropy``)."""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.kernels.fused_loss import linear_cross_entropy

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(
    input: torch.Tensor,  # noqa: A002 - Paddle's argument name
    label: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",
    soft_label: bool = False,
    axis: int = -1,
    use_softmax: bool = True,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Softmax cross entropy as the JAX package computes it. Half-precision
    inputs are upcast to fp32 first; ``use_softmax=False`` takes the input
    as probabilities (``log(clip(x, 1e-15, 1))``); ``axis`` is the class
    axis.

    - Hard labels (integers, the class axis squeezed or absent): labels
      equal to ``ignore_index`` contribute 0; ``label_smoothing`` mixes the
      target's negative log-likelihood with the mean over the classes,
      ``(1 - eps) nll + eps * mean(-logp)``; class ``weight`` multiplies
      each row's loss by its label's weight, and ``"mean"`` then divides by
      the summed weights of the valid labels (else by the number of valid
      labels, at least 1).
    - Soft labels (``soft_label``, a distribution over the class axis):
      ``-sum(target * logp)`` with the target smoothed to ``(1 - eps)
      target + eps / K``, times ``sum(target * weight)`` with a ``weight``;
      ``"mean"`` averages every row.

    ``"sum"`` sums, ``"none"`` returns the per-row loss. The JAX package
    indexes a hard label along the last axis whatever ``axis`` is; the port
    takes it along ``axis``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    logits = input.float() if input.dtype in (torch.float16, torch.bfloat16) else input
    logits = logits.movedim(axis, -1)
    logp = torch.log_softmax(logits, dim=-1) if use_softmax else torch.log(torch.clamp(logits, 1e-15, 1.0))
    k = logp.shape[-1]
    if soft_label:
        target = label.movedim(axis, -1)
        if label_smoothing > 0.0:
            target = (1 - label_smoothing) * target + label_smoothing / k
        loss = -(target * logp).sum(-1)
        if weight is not None:
            loss = loss * (target * weight).sum(-1)
        return _reduce(loss, reduction)
    lbl = label.squeeze(axis) if label.dim() == input.dim() else label
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    if label_smoothing > 0.0:
        loss = (1 - label_smoothing) * loss + label_smoothing * -logp.mean(-1)
    if weight is not None:
        w = weight[safe]
        loss = loss * w
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, w, torch.zeros_like(w)).sum()
        else:
            denom = valid.sum().clamp(min=1).to(loss.dtype)
        return loss.sum() / denom
    return _reduce(loss, reduction)


def fused_linear_cross_entropy(
    input: torch.Tensor,  # noqa: A002 - Paddle's argument name
    weight: torch.Tensor,
    label: torch.Tensor,
    ignore_index: int = -100,
    reduction: str = "mean",
    weight_vocab_major: bool = False,
    weight_scale=None,
) -> torch.Tensor:
    """Fused lm head + softmax cross entropy: ``cross_entropy(input @ W,
    label)`` with the ``[..., V]`` logits never materialised (the forward
    keeps an fp32 logsumexp and the target logit per row; the backward
    recomputes the logits chunk by chunk). ``weight`` is ``[H, V]`` or, with
    ``weight_vocab_major``, ``[V, H]``. The loss is fp32; ``ignore_index``
    and ``reduction`` behave as in :func:`cross_entropy`.

    The JAX package's gate picks the engine: with ``FLAGS_use_fused_loss``
    on and the hidden size a multiple of 128, kernels 17-19 (their plain
    versions on CPU tensors); otherwise the plain versions, the counterpart
    of its ``lax.scan`` reference, on any device.

    ``weight_scale`` (``[V]`` fp32, with ``weight`` int8: the weight-only
    int8 lm head) takes the forward-only quantized walk under the same gate:
    kernel 17's int8 site, or the plain version of JAX's
    ``_reference_quant_path``. A gradient through it raises, as JAX has no
    VJP there."""
    use_kernels = bool(flag("use_fused_loss")) and input.shape[-1] % 128 == 0
    return linear_cross_entropy(input, weight, label, ignore_index=ignore_index, reduction=reduction,
                                vocab_major=weight_vocab_major, use_kernels=use_kernels, weight_scale=weight_scale)
