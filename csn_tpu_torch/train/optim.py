"""Optimizers and LR schedules (counterpart of `csn_tpu/train/optim.py`).

Reference: `MinkowskiNet/lib/solvers.py` — SGD(momentum, dampening) / Adam
with L2 weight decay folded into the gradient, and StepLR / PolyLR /
SquaredLR / ExpLR / ReduceLROnPlateau schedules. The JAX package rebuilt
torch's semantics as gradient transformations (the SGD buffer starts as the
first, undampened gradient); here they are torch's own `torch.optim.SGD`
and `Adam`.

Step schedules are pure functions step -> lr; ReduceLROnPlateau is a host
state machine driven once per epoch by the validation loss. A caller applies
an lr by writing it into the optimizer's `param_groups`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    optimizer: str = "SGD",
    lr: float = 1e-2,
    sgd_momentum: float = 0.9,
    sgd_dampening: float = 0.1,
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
    weight_decay: float = 1e-4,
) -> torch.optim.Optimizer:
    """`lib/solvers.py:45-63` equivalent: weight decay added to the gradient
    (L2, not decoupled), SGD's momentum buffer initialised to the first
    step's gradient."""
    if optimizer == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=sgd_momentum,
                               dampening=sgd_dampening,
                               weight_decay=weight_decay)
    if optimizer == "Adam":
        return torch.optim.Adam(params, lr=lr,
                                betas=(adam_beta1, adam_beta2),
                                weight_decay=weight_decay)
    raise ValueError(f"Optimizer type not supported: {optimizer}")


def make_lr_schedule(
    scheduler: str,
    base_lr: float,
    *,
    step_size: int = 20000,
    step_gamma: float = 0.1,
    max_iter: int = 60000,
    poly_power: float = 0.9,
    exp_gamma: float = 0.95,
    exp_step_size: float = 445.0,
) -> Optional[Callable[[int], float]]:
    """Returns step -> lr, or None for ReduceLROnPlateau (host-driven)."""
    if scheduler == "StepLR":
        return lambda s: base_lr * step_gamma ** (s // step_size)
    if scheduler == "PolyLR":
        return lambda s: base_lr * (1 - s / (max_iter + 1)) ** poly_power
    if scheduler == "SquaredLR":
        return lambda s: base_lr * (1 - s / (max_iter + 1)) ** 2
    if scheduler == "ExpLR":
        return lambda s: base_lr * exp_gamma ** (s / exp_step_size)
    if scheduler == "ReduceLROnPlateau":
        return None
    raise ValueError(f"Scheduler not supported: {scheduler}")


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau (mode='min', rel threshold).

    The reference drives it with validation loss once per epoch
    (`lib/trainer_csn.py:163-167`) using factor=0.5, patience=10, cooldown=10
    (`trainer_csn.py:41-44`)."""

    lr: float
    factor: float = 0.5
    patience: int = 10
    cooldown: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0

    best: float = float("inf")
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, d):
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
        self.cooldown_counter = d["cooldown_counter"]
