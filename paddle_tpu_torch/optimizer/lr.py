"""Learning-rate schedulers.

Copy of ``paddle_tpu/optimizer/lr.py`` (plain Python, no framework
imports). The LR reaches the step as a scalar device feed each run (see
``Optimizer._create_global_learning_rate``), so schedulers add no ops to
the program.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1, verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self.step()

    def __call__(self) -> float:
        return self.last_lr

    def step(self, epoch: Optional[int] = None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self) -> float:
        raise NotImplementedError

    def state_dict(self):
        return {
            k: v
            for k, v in self.__dict__.items()
            if isinstance(v, (int, float, bool, str, list, tuple))
        }

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(step ** -0.5, step * self.warmup_steps ** -1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float], last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0, cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * ((1 - step / decay_steps) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1, verbose=False):
        self.lr = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / self.warmup_steps + self.start_lr
        if isinstance(self.lr, LRScheduler):
            self.lr.step(self.last_epoch - self.warmup_steps)
            return self.lr()
        return float(self.lr)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones: Sequence[int], gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size: int, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float], last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        d = super().state_dict()
        d.pop("lr_lambda", None)
        return d


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
        )


class ReduceOnPlateau(LRScheduler):
    def __init__(
        self,
        learning_rate,
        mode="min",
        factor=0.1,
        patience=10,
        threshold=1e-4,
        threshold_mode="rel",
        cooldown=0,
        min_lr=0,
        epsilon=1e-8,
        verbose=False,
    ):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self.last_lr if hasattr(self, "last_lr") else self.base_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        metrics = float(metrics)
        if self.best is None:
            self.best = metrics
            return
        better = (
            metrics < self.best - abs(self.best) * self.threshold
            if self.mode == "min"
            else metrics > self.best + abs(self.best) * self.threshold
        ) if self.threshold_mode == "rel" else (
            metrics < self.best - self.threshold if self.mode == "min" else metrics > self.best + self.threshold
        )
        if better:
            self.best = metrics
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0, end_learning_rate=None, phase_pct=0.3, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.min_lr = end_learning_rate if end_learning_rate is not None else self.initial_lr / 1e4
        self.phase_steps = int(phase_pct * total_steps)
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if step <= self.phase_steps:
            pct = step / max(self.phase_steps, 1)
            return self.initial_lr + (self.max_lr - self.initial_lr) * (1 - math.cos(math.pi * pct)) / 2
        pct = (step - self.phase_steps) / max(self.total_steps - self.phase_steps, 1)
        return self.min_lr + (self.max_lr - self.min_lr) * (1 + math.cos(math.pi * pct)) / 2
