"""Optimizer base (port of ``paddle_tpu/optimizer/optimizer.py``).

Each algorithm defines ``init_state(param)`` and ``update(params, grads,
states, lr, step, weight_decay)`` over lists of tensors. ``step()`` runs, as
the JAX package does: the ``grad_clip`` over every parameter group, then
the update bucketed by (group learning rate, weight decay, the parameter's
``optimize_attr["learning_rate"]`` factor), each bucket in groups of
bounded size so the ``torch._foreach_*`` temporaries stay small next to the
model. The learning rate is a float or an ``lr.LRScheduler``, read each
step through ``get_lr()`` (the user calls ``scheduler.step()``); like the
JAX package's ``jnp.asarray(lr, float32)`` it enters the update rounded to
fp32. With ``multi_precision`` a bf16/fp16 parameter gets an fp32 master
copy and fp32 moments; the update runs on the master, which is then cast
back into the parameter (round to nearest even, as ``astype``).

Parameter groups are dicts with ``params`` and optionally ``learning_rate``
(that group's learning rate, in place of the optimizer's) and
``weight_decay``. Each parameter's name (``state_dict`` keys,
``apply_decay_param_fun``) is its structured name in the model that owns it
(``named_parameters()``; the port's models set it as ``paddle_name`` when
they are built), else ``param_<i>``, its place in the optimizer's list.
This is plain PyTorch, not a kernel: the JAX optimizer is an XLA program
too.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer", "name_parameters"]

# elements per foreach group: bounds each temporary list to ~256 MB in fp32
_GROUP_NUMEL = 1 << 26
_LOW_PRECISION = (torch.bfloat16, torch.float16)


def name_parameters(module: torch.nn.Module) -> None:
    """Give each parameter of ``module`` its structured name (the one
    ``named_parameters()`` yields) as ``paddle_name``: the name the
    optimizers key their state and ``apply_decay_param_fun`` by."""
    for name, p in module.named_parameters():
        p.paddle_name = name


def _wd_value(weight_decay: Any) -> float:
    if weight_decay is None:
        return 0.0
    if hasattr(weight_decay, "_coeff"):  # an L2Decay regularizer object
        return float(weight_decay._coeff)
    return float(weight_decay)


def _fp32(x: float) -> float:
    return float(np.float32(x))


class Optimizer:
    def __init__(
        self,
        learning_rate: Any = 0.001,
        parameters: Optional[Iterable[Any]] = None,
        weight_decay: Optional[Any] = None,
        grad_clip: Any = None,
        multi_precision: bool = False,
        name: Optional[str] = None,
    ) -> None:
        if parameters is None:
            raise ValueError("parameters is required (pass model.parameters())")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            self._param_groups = [{**g, "params": list(g["params"])} for g in params]
            self._parameters: List[torch.nn.Parameter] = [p for g in self._param_groups for p in g["params"]]
        else:
            self._param_groups = [{"params": params}]
            self._parameters = params
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an LRScheduler, not {type(learning_rate).__name__}")
        self._learning_rate = learning_rate
        self._weight_decay = _wd_value(weight_decay)
        self._grad_clip = grad_clip
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

    def _param_weight_decay(self, p: torch.nn.Parameter, wd: float) -> float:
        """The weight decay of one parameter (AdamW's
        ``apply_decay_param_fun`` overrides it)."""
        return wd

    # -- names, lr -------------------------------------------------------------------
    def _name_of(self, p: torch.nn.Parameter) -> str:
        name = getattr(p, "paddle_name", None)
        if name is None:
            name = f"param_{next(i for i, q in enumerate(self._parameters) if q is p)}"
        return name

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

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
        params_grads = [(p, p.grad) for p in self._parameters if p.requires_grad and p.grad is not None]
        if not params_grads:
            return
        if self._grad_clip is not None:  # over every group: the global norm spans them
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        base_lr = self.get_lr()
        grad_of = {id(p): g for p, g in params_grads}
        buckets: Dict[Tuple[Optional[float], float, float], List[torch.nn.Parameter]] = {}
        for group in self._param_groups:
            g_wd = group.get("weight_decay")
            wd = self._weight_decay if g_wd is None else _wd_value(g_wd)
            for p in group["params"]:
                if id(p) not in grad_of:
                    continue
                factor = float(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0))
                buckets.setdefault((group.get("learning_rate"), self._param_weight_decay(p, wd), factor),
                                   []).append(p)
        for (g_lr, wd, factor), params in buckets.items():
            lr = _fp32(base_lr if g_lr is None else g_lr)
            if factor != 1.0:
                lr = float(np.float32(lr) * np.float32(factor))
            self._run_bucket(params, [grad_of[id(p)] for p in params], lr, wd)

    def _run_bucket(self, params: List[torch.nn.Parameter], grads: List[torch.Tensor], lr: float,
                    weight_decay: float) -> None:
        group: List[int] = []
        numel = 0
        for k, p in enumerate(params):
            if group and (numel + p.numel() > _GROUP_NUMEL or self._kind(p) != self._kind(params[group[0]])):
                self._run([params[i] for i in group], [grads[i] for i in group], lr, weight_decay)
                group, numel = [], 0
            group.append(k)
            numel += p.numel()
        self._run([params[i] for i in group], [grads[i] for i in group], lr, weight_decay)

    def _kind(self, p: torch.nn.Parameter) -> tuple:
        return (p.device, p.dtype, "master_weight" in self._state_for(p))

    def _run(self, params: List[torch.nn.Parameter], grads: List[torch.Tensor], lr: float,
             weight_decay: float) -> None:
        states = [self._state_for(p) for p in params]
        if "master_weight" in states[0]:
            targets = [st["master_weight"] for st in states]
            grads = [g.float() for g in grads]
        else:
            targets = [p.detach() for p in params]
        inner = [{k: v for k, v in st.items() if k != "master_weight"} for st in states]
        self.update(targets, grads, inner, lr=lr, step=self._step_count, weight_decay=weight_decay)
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

    # -- serialization -------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The JAX package's layout: ``"{name}__{moment1|moment2|
        moment2_max|master_weight}"`` for each parameter with state,
        ``"_step_count"``, and ``"LR_Scheduler"`` (the scheduler's own
        ``state_dict``) when the learning rate is one. The tensors are the
        live state (as ``torch.optim``'s): ``torch.save`` them, or clone
        them, to keep a snapshot."""
        sd: Dict[str, Any] = {"_step_count": self._step_count}
        for p in self._parameters:
            st = self._accumulators.get(id(p))
            if st is not None:
                name = self._name_of(p)
                for k, v in st.items():
                    sd[f"{name}__{k}"] = v
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Resume from :meth:`state_dict`'s layout (a ``torch.load`` of one,
        or ``models.convert.optimizer_state_from_paddle_tpu``'s): each
        parameter's entries are copied onto its device, and the step count,
        which is also the bias correction's ``t``, resumes with them."""
        self._step_count = int(state_dict.get("_step_count", 0))
        for p in self._parameters:
            prefix = f"{self._name_of(p)}__"
            st = {k[len(prefix):]: torch.as_tensor(v).to(device=p.device, copy=True)
                  for k, v in state_dict.items() if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._accumulators[id(p)] = st
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
