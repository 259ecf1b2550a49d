"""Learning-rate schedules, including the paper's plateau-halving rule
(port of ``repro/optim/schedules.py``).  A schedule maps the step, a Python
int, to a Python float, so reading it never waits for the device."""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    def fn(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        prog = min(max((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac)
                          * 0.5 * (1 + math.cos(math.pi * prog)))
    return fn


class PlateauHalver:
    """Host-side plateau halving: the paper halves the lr on N-epoch training
    accuracy plateaus.  Stateful; feed it the metric each epoch and read
    ``lr``."""

    def __init__(self, lr: float, patience: int, mode: str = "max",
                 min_lr: float = 1e-6):
        self.lr = lr
        self.patience = patience
        self.mode = mode
        self.min_lr = min_lr
        self.best = -math.inf if mode == "max" else math.inf
        self.bad = 0

    def step(self, metric: float) -> float:
        better = metric > self.best if self.mode == "max" else metric < self.best
        if better:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                self.lr = max(self.lr * 0.5, self.min_lr)
                self.bad = 0
        return self.lr


def plateau_halving(lr: float, patience: int, **kw) -> PlateauHalver:
    return PlateauHalver(lr, patience, **kw)
