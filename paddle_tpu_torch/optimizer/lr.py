"""Learning-rate schedulers (the port's own copy of ``paddle_tpu/optimizer/lr.py``).

Paddle semantics: a scheduler holds ``last_epoch``; the user calls
``scheduler.step()`` (per epoch or per step) and the optimizer reads
``scheduler()`` at each update (``Optimizer.get_lr``). These are pure Python
floats, kept line for line as the JAX package computes them, so both
packages give the same learning-rate sequence as floats; the port imports
nothing of the JAX package, so it keeps this copy.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

__all__ = [
    "LRScheduler",
    "NoamDecay",
    "ExponentialDecay",
    "NaturalExpDecay",
    "InverseTimeDecay",
    "PolynomialDecay",
    "PiecewiseDecay",
    "CosineAnnealingDecay",
    "LinearWarmup",
    "StepDecay",
    "MultiStepDecay",
    "LambdaDecay",
    "MultiplicativeDecay",
    "ReduceOnPlateau",
    "OneCycleLR",
    "CyclicLR",
    "CosineAnnealingWarmRestarts",
    "LinearLR",
]


class LRScheduler:
    auto_step = False

    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1, verbose: bool = False) -> None:
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self) -> float:
        return self.last_lr

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch: Optional[int] = None) -> None:
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def state_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_") and not callable(v)}

    def set_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.__dict__.update(state_dict)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model: int, warmup_steps: int, learning_rate: float = 1.0, last_epoch: int = -1, verbose: bool = False) -> None:
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        step = max(self.last_epoch, 1)
        return (
            self.base_lr
            * self.d_model**-0.5
            * min(step**-0.5, step * self.warmup_steps**-1.5)
        )


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1, verbose: bool = False) -> None:
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr * self.gamma**self.last_epoch


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1, verbose: bool = False) -> None:
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1, verbose: bool = False) -> None:
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int, end_lr: float = 0.0001, power: float = 1.0, cycle: bool = False, last_epoch: int = -1, verbose: bool = False) -> None:
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * (1 - step / decay_steps) ** self.power + self.end_lr


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float], last_epoch: int = -1, verbose: bool = False) -> None:
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self) -> float:
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, T_max: int, eta_min: float = 0.0, last_epoch: int = -1, verbose: bool = False) -> None:  # noqa: N803
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return (
            self.eta_min
            + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
        )


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate: Union[float, LRScheduler], warmup_steps: int, start_lr: float, end_lr: float, last_epoch: int = -1, verbose: bool = False) -> None:
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr if isinstance(learning_rate, float) else learning_rate.base_lr, last_epoch, verbose)

    def get_lr(self) -> float:
        if self.last_epoch < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * self.last_epoch / max(self.warmup_steps, 1)
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr_after.get_lr()
        return float(self.lr_after)

    def state_dict(self) -> Dict[str, Any]:
        sd = {k: v for k, v in self.__dict__.items() if k != "lr_after"}
        if isinstance(self.lr_after, LRScheduler):
            sd["lr_after"] = self.lr_after.state_dict()
        else:
            sd["lr_after"] = self.lr_after
        return sd

    def set_state_dict(self, state_dict: Dict[str, Any]) -> None:
        state_dict = dict(state_dict)  # the caller's dict is left as it was
        inner = state_dict.pop("lr_after", None)
        self.__dict__.update(state_dict)
        if isinstance(inner, dict) and isinstance(self.lr_after, LRScheduler):
            self.lr_after.set_state_dict(inner)
        elif inner is not None:
            self.lr_after = inner


class StepDecay(LRScheduler):
    def __init__(self, learning_rate: float, step_size: int, gamma: float = 0.1, last_epoch: int = -1, verbose: bool = False) -> None:
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate: float, milestones: Sequence[int], gamma: float = 0.1, last_epoch: int = -1, verbose: bool = False) -> None:
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma**n


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate: float, lr_lambda: Callable[[int], float], last_epoch: int = -1, verbose: bool = False) -> None:
        self._lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr * self._lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate: float, lr_lambda: Callable[[int], float], last_epoch: int = -1, verbose: bool = False) -> None:
        self._lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        lr = self.base_lr
        for e in range(1, self.last_epoch + 1):
            lr *= self._lr_lambda(e)
        return lr


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate: float, mode: str = "min", factor: float = 0.1, patience: int = 10, threshold: float = 1e-4, threshold_mode: str = "rel", cooldown: int = 0, min_lr: float = 0, epsilon: float = 1e-8, verbose: bool = False) -> None:
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self) -> float:
        return self.last_lr

    def step(self, metrics: Any = None, epoch: Optional[int] = None) -> None:
        if metrics is None:
            return
        current = float(metrics)
        self.last_epoch += 1
        if self.best is None:
            self.best = current
            return
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def _is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1 + self.threshold)
        return a > best + self.threshold


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate: float, total_steps: int, divide_factor: float = 25.0, end_learning_rate: float = 0.0001, phase_pct: float = 0.3, anneal_strategy: str = "cos", three_phase: bool = False, last_epoch: int = -1, verbose: bool = False) -> None:
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start: float, end: float, pct: float) -> float:
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def get_lr(self) -> float:
        step = min(self.last_epoch, self.total_steps)
        up_steps = int(self.phase_pct * self.total_steps)
        if step <= up_steps:
            return self._interp(self.initial_lr, self.max_lr, step / max(up_steps, 1))
        return self._interp(self.max_lr, self.end_lr, (step - up_steps) / max(self.total_steps - up_steps, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate: float, max_learning_rate: float, step_size_up: int, step_size_down: Optional[int] = None, mode: str = "triangular", exp_gamma: float = 1.0, scale_fn: Optional[Callable] = None, scale_mode: str = "cycle", last_epoch: int = -1, verbose: bool = False) -> None:
        self.max_lr = max_learning_rate
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self._scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        if x <= self.step_size_up:
            pct = x / self.step_size_up
        else:
            pct = 1 - (x - self.step_size_up) / self.step_size_down
        amp = (self.max_lr - self.base_lr) * pct
        if self._scale_fn is not None:
            scale_arg = cycle if self.scale_mode == "cycle" else self.last_epoch
            return self.base_lr + amp * self._scale_fn(scale_arg)
        if self.mode == "triangular2":
            return self.base_lr + amp / (2 ** (cycle - 1))
        if self.mode == "exp_range":
            return self.base_lr + amp * (self.exp_gamma**self.last_epoch)
        return self.base_lr + amp


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate: float, T_0: int, T_mult: int = 1, eta_min: float = 0.0, last_epoch: int = -1, verbose: bool = False) -> None:  # noqa: N803
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        t = self.last_epoch
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / t_i)) / 2


class LinearLR(LRScheduler):
    def __init__(self, learning_rate: float, total_steps: int, start_factor: float = 1.0 / 3, end_factor: float = 1.0, last_epoch: int = -1, verbose: bool = False) -> None:
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        pct = min(self.last_epoch / self.total_steps, 1.0)
        factor = self.start_factor + (self.end_factor - self.start_factor) * pct
        return self.base_lr * factor
