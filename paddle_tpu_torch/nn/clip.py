"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``).

``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` take
and return ``[(param, grad), ...]`` (an optimizer's ``grad_clip`` applies
one over every parameter group before the update) and leave ``param.grad``
as it was; ``clip_grad_norm_`` scales ``param.grad`` in place and returns
the total norm. Every norm is an fp32 0-d tensor on the grads' device: no
call reads a value back to the host, so a training step that clips does not
wait on the card. A parameter whose ``need_clip`` attribute is False is left
out of ``ClipGradByGlobalNorm``'s norm and scaling, as in the JAX package.
This is plain PyTorch: the JAX clipping is an XLA program too.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_"]

ParamsGrads = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _scaled(grads: List[torch.Tensor], factor: torch.Tensor) -> List[torch.Tensor]:
    """New tensors ``(g in fp32 * factor)`` rounded to each grad's dtype
    (the JAX ``(g.astype(float32) * factor).astype(g.dtype)``): one kernel
    a grad, the product in fp32 (``factor`` as a 1-element fp32 tensor
    makes the result type fp32) written straight into a tensor of the
    grad's dtype, so no fp32 copy of a half-precision grad is made."""
    f = factor.reshape(1)
    return [torch.mul(g, f, out=torch.empty_like(g)) for g in grads]


def _sum_in_order(parts: List[torch.Tensor]) -> torch.Tensor:
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _square_sums(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each grad's fp32 sum of squares (its fp32 L2 norm, squared), without
    an fp32 copy of the grad."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch._foreach_mul(norms, norms)


class ClipGradBase:
    def __call__(self, params_grads: ParamsGrads) -> ParamsGrads:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each grad clipped to ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max: float, min: Optional[float] = None) -> None:  # noqa: A002 - Paddle's names
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads: ParamsGrads) -> ParamsGrads:
        return [(p, g if g is None else torch.clamp(g, self.min, self.max)) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each grad scaled by ``min(clip_norm / max(||g||, 1e-12), 1)``, its
    own L2 norm in fp32."""

    def __init__(self, clip_norm: float) -> None:
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads: ParamsGrads) -> ParamsGrads:
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.linalg.vector_norm(g, dtype=torch.float32)
            factor = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
            out.append((p, _scaled([g], factor)[0]))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every grad (of a parameter with ``need_clip`` not False) scaled by
    ``clip_norm / max(global_norm, clip_norm)``, the global norm the square
    root of the fp32 per-parameter square sums added in parameter order.
    ``group_name`` and ``auto_skip_clip`` are accepted for Paddle's
    signature (one group; nothing skipped), as in the JAX package."""

    def __init__(self, clip_norm: float = 1.0, group_name: str = "default_group", auto_skip_clip: bool = False) -> None:
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
        live = [g for g in grads if g is not None]
        if not live:
            return torch.zeros((), dtype=torch.float32)
        return torch.sqrt(_sum_in_order(_square_sums(live)))

    def __call__(self, params_grads: ParamsGrads) -> ParamsGrads:
        clipped = [k for k, (p, g) in enumerate(params_grads) if g is not None and getattr(p, "need_clip", True)]
        if not clipped:
            return params_grads
        gnorm = self.global_norm([params_grads[k][1] for k in clipped])
        factor = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        out = list(params_grads)
        for k, g in zip(clipped, _scaled([params_grads[k][1] for k in clipped], factor)):
            out[k] = (params_grads[k][0], g)
        return out


def clip_grad_norm_(parameters: Union[torch.Tensor, Iterable[torch.Tensor]], max_norm: float,
                    norm_type: float = 2.0, error_if_nonfinite: bool = False) -> torch.Tensor:
    """Scale every ``param.grad`` in place by ``min(max_norm / max(total,
    1e-6), 1)`` and return ``total``, the fp32 ``norm_type`` norm over all
    grads (``inf``: the largest magnitude). ``error_if_nonfinite`` is
    accepted and ignored, as in the JAX package (checking it would read the
    norm back to the host)."""
    params = [parameters] if isinstance(parameters, torch.Tensor) else list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    elif norm_type == 2.0:
        total = torch.sqrt(_sum_in_order(_square_sums(grads)))
    else:
        total = _sum_in_order([g.float().abs().pow(norm_type).sum() for g in grads]) ** (1.0 / norm_type)
    factor = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0).reshape(1)
    with torch.no_grad():
        for g in grads:
            torch.mul(g, factor, out=g)  # in fp32, rounded once to the grad's dtype
    return total
