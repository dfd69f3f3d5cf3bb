"""Optimizer base (port of ``paddle_tpu/optimizer/optimizer.py``).

Each algorithm defines ``init_state(param)`` and ``update(params, grads,
states, lr, step, weight_decay)`` over lists of tensors; ``step()`` runs the
update over the parameters that have a gradient, in groups of bounded size
so the ``torch._foreach_*`` temporaries stay small next to the model. With
``multi_precision`` a bf16/fp16 parameter gets an fp32 master copy and fp32
moments; the update runs on the master, which is then cast back into the
parameter (round to nearest even, as the JAX package's ``astype``). This is
plain PyTorch, not a kernel: the JAX optimizer is an XLA program too.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

__all__ = ["Optimizer"]

# elements per foreach group: bounds each temporary list to ~256 MB in fp32
_GROUP_NUMEL = 1 << 26
_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(
        self,
        learning_rate: float = 0.001,
        parameters: Optional[Iterable[torch.nn.Parameter]] = None,
        weight_decay: Optional[float] = None,
        grad_clip: Any = None,
        multi_precision: bool = False,
        name: Optional[str] = None,
    ) -> None:
        if parameters is None:
            raise ValueError("parameters is required (pass model.parameters())")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            raise NotImplementedError("parameter groups are not ported yet")
        if grad_clip is not None:
            raise NotImplementedError("gradient clipping is not ported yet")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("learning-rate schedulers are not ported yet")
        self._parameters: List[torch.nn.Parameter] = params
        self._learning_rate = float(learning_rate)
        self._weight_decay = 0.0 if weight_decay is None else float(weight_decay)
        self._multi_precision = bool(multi_precision)
        self._step_count = 0
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}

    # -- the algorithm (overridden) ----------------------------------------------
    def init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               states: List[Dict[str, torch.Tensor]], *, lr: float, step: int,
               weight_decay: float) -> None:
        """Update ``params`` (masters where there are) and ``states`` in place."""
        raise NotImplementedError

    # -- lr ------------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        self._learning_rate = float(value)

    # -- state -----------------------------------------------------------------------
    def _state_for(self, p: torch.nn.Parameter) -> Dict[str, torch.Tensor]:
        key = id(p)
        if key not in self._accumulators:
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                # fp32 master AND fp32 moments (Paddle's multi_precision)
                master = p.detach().float()
                state = self.init_state(master)
                state["master_weight"] = master
            else:
                state = self.init_state(p.detach())
            self._accumulators[key] = state
        return self._accumulators[key]

    # -- the step ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        live = [p for p in self._parameters if p.requires_grad and p.grad is not None]
        if not live:
            return
        self._step_count += 1
        group: List[torch.nn.Parameter] = []
        numel = 0
        for p in live:
            if group and (numel + p.numel() > _GROUP_NUMEL or self._kind(p) != self._kind(group[0])):
                self._run(group)
                group, numel = [], 0
            group.append(p)
            numel += p.numel()
        self._run(group)

    def _kind(self, p: torch.nn.Parameter) -> tuple:
        return (p.device, p.dtype, "master_weight" in self._state_for(p))

    def _run(self, params: List[torch.nn.Parameter]) -> None:
        states = [self._state_for(p) for p in params]
        if "master_weight" in states[0]:
            targets = [st["master_weight"] for st in states]
            grads = [p.grad.float() for p in params]
        else:
            targets = [p.detach() for p in params]
            grads = [p.grad for p in params]
        inner = [{k: v for k, v in st.items() if k != "master_weight"} for st in states]
        self.update(targets, grads, inner, lr=self.get_lr(), step=self._step_count,
                    weight_decay=self._weight_decay)
        if "master_weight" in states[0]:
            for p, master in zip(params, targets):
                p.copy_(master)

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameters:
            if p.grad is not None:
                if set_to_zero:
                    p.grad.zero_()
                else:
                    p.grad = None

    clear_gradients = clear_grad
