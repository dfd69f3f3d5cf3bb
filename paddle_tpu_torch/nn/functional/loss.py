"""Softmax cross entropy, the hard-label path (port of
``paddle_tpu/nn/functional/loss.py`` ``cross_entropy``)."""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(
    input: torch.Tensor,  # noqa: A002 - Paddle's argument name
    label: torch.Tensor,
    weight=None,
    ignore_index: int = -100,
    reduction: str = "mean",
    soft_label: bool = False,
    axis: int = -1,
    use_softmax: bool = True,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Softmax cross entropy with integer labels: half-precision logits are
    upcast to fp32 before ``log_softmax``; labels equal to ``ignore_index``
    contribute 0; ``"mean"`` divides by the number of valid labels (at least
    1), ``"sum"`` sums, ``"none"`` returns the per-position loss.

    Class weights, soft labels, ``use_softmax=False`` and label smoothing are
    not ported yet and raise."""
    if weight is not None or soft_label or not use_softmax or label_smoothing:
        raise NotImplementedError("cross_entropy: only the hard-label softmax path is ported")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    logits = input.float() if input.dtype in (torch.float16, torch.bfloat16) else input
    logp = torch.log_softmax(logits, dim=axis)
    lbl = label.squeeze(axis) if label.dim() == logp.dim() else label
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss
