"""Softmax cross entropy, the hard-label path, and the fused linear cross
entropy of the loss head (port of ``paddle_tpu/nn/functional/loss.py``
``cross_entropy`` and ``fused_linear_cross_entropy``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.kernels.fused_loss import linear_cross_entropy

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


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
