"""Adam and AdamW (port of ``paddle_tpu/optimizer/optimizers.py``).

The update is the JAX package's ``_adam_update``, operation for operation:
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, bias-corrected
``m_hat / (sqrt(v_hat) + eps)``, AdamW's ``wd * param`` added to that
update (decoupled), then ``param - lr * update``. The scalars are rounded to
the state's dtype first, as ``jnp.asarray(beta, param.dtype)`` does. This is
not ``torch.optim.AdamW``: that decays as ``p * (1 - lr * wd)`` before the
Adam step, which rounds differently.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


def _in(dtype: torch.dtype, x) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype)


class Adam(Optimizer):
    def __init__(
        self,
        learning_rate: float = 0.001,
        beta1: float = 0.9,
        beta2: float = 0.999,
        epsilon: float = 1e-8,
        parameters=None,
        weight_decay=None,
        grad_clip=None,
        lazy_mode: bool = False,
        multi_precision: bool = False,
        use_multi_tensor: bool = False,
        amsgrad: bool = False,
        name=None,
    ) -> None:
        if amsgrad:
            raise NotImplementedError("amsgrad is not ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision, name)
        self._beta1, self._beta2, self._epsilon = float(beta1), float(beta2), float(epsilon)

    def init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"moment1": torch.zeros_like(param), "moment2": torch.zeros_like(param)}

    def _adam_update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                     states: List[Dict[str, torch.Tensor]], lr: float, step: int,
                     decoupled_wd: float, l2_wd: float) -> None:
        dt = params[0].dtype
        b1, b2 = _in(dt, self._beta1), _in(dt, self._beta2)
        t = _in(dt, step)
        one = _in(dt, 1.0)
        omb1, omb2 = float(one - b1), float(one - b2)
        bc1, bc2 = float(one - torch.pow(b1, t)), float(one - torch.pow(b2, t))
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        if l2_wd:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, l2_wd))
        torch._foreach_mul_(m, float(b1))
        torch._foreach_add_(m, torch._foreach_mul(grads, omb1))
        torch._foreach_mul_(v, float(b2))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, omb2)
        torch._foreach_add_(v, sq)
        del sq
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, den)
        del den
        if decoupled_wd:
            torch._foreach_add_(upd, torch._foreach_mul(params, decoupled_wd))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(params, upd)

    def update(self, params, grads, states, *, lr, step, weight_decay):
        # Paddle's Adam applies weight_decay as L2 regularisation (coupled)
        self._adam_update(params, grads, states, lr, step, 0.0, weight_decay)


class AdamW(Adam):
    def __init__(
        self,
        learning_rate: float = 0.001,
        beta1: float = 0.9,
        beta2: float = 0.999,
        epsilon: float = 1e-8,
        parameters=None,
        weight_decay: float = 0.01,
        lr_ratio=None,
        apply_decay_param_fun=None,
        grad_clip=None,
        lazy_mode: bool = False,
        multi_precision: bool = False,
        amsgrad: bool = False,
        name=None,
    ) -> None:
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError("lr_ratio and apply_decay_param_fun are not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, weight_decay=weight_decay,
                         grad_clip=grad_clip, multi_precision=multi_precision, amsgrad=amsgrad, name=name)

    def update(self, params, grads, states, *, lr, step, weight_decay):
        # decoupled weight decay (AdamW)
        self._adam_update(params, grads, states, lr, step, weight_decay, 0.0)
