"""AdamW with float32 moments (params may be bf16; the moments stay float32
so mixed-precision training is stable).  Port of ``repro/optim/adamw.py``:
the same update, the step a Python int."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch import utils
from repro_torch.optim.common import Optimizer

PyTree = Any
ScheduleOrFloat = Union[float, Callable[[int], float]]


class AdamWState(NamedTuple):
    step: int
    mu: PyTree     # first moment, float32
    nu: PyTree     # second moment, float32


def adamw(lr: ScheduleOrFloat, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """``update`` writes the new moments into the state's tensors and
    returns that state: like the JAX train step's donated optimizer state,
    the state passed in is consumed."""
    def lr_at(step):
        return lr(step) if callable(lr) else float(lr)

    def init(params: PyTree) -> AdamWState:
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(0, utils.tree_map(f32, params),
                          utils.tree_map(f32, params))

    @torch.no_grad()
    def update(grads: PyTree, state: AdamWState, params: Optional[PyTree] = None
               ) -> tuple[PyTree, AdamWState]:
        step = state.step + 1
        c1 = 1.0 - b1 ** step
        c2 = 1.0 - b2 ** step
        lr_t = lr_at(step)

        def upd(g, m, v, p=None):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / c1).div_((v / c2).sqrt_().add_(eps)).mul_(-lr_t)
            if weight_decay > 0.0 and p is not None and p.dim() >= 2:
                u.sub_(p.float(), alpha=lr_t * weight_decay)
            return u

        if params is None:
            updates = utils.tree_map(upd, grads, state.mu, state.nu)
        else:
            updates = utils.tree_map(upd, grads, state.mu, state.nu, params)
        return updates, AdamWState(step, state.mu, state.nu)

    return Optimizer(init, update)
