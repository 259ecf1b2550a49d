"""Plain SGD (+momentum): the paper's explorative experiments use pure SGD
with lr 0.2.  Port of ``repro/optim/sgd.py``."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch import utils
from repro_torch.optim.common import Optimizer

PyTree = Any
ScheduleOrFloat = Union[float, Callable[[int], float]]


class SGDState(NamedTuple):
    step: int
    momentum: PyTree      # float32 buffers, or None leaves without momentum


def sgd(lr: ScheduleOrFloat, momentum: float = 0.0) -> Optimizer:
    def lr_at(step):
        return lr(step) if callable(lr) else float(lr)

    def init(params: PyTree) -> SGDState:
        if not momentum:
            return SGDState(0, None)
        return SGDState(0, utils.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params))

    @torch.no_grad()
    def update(grads: PyTree, state: SGDState, params: Optional[PyTree] = None
               ) -> tuple[PyTree, SGDState]:
        step = state.step + 1
        lr_t = lr_at(step)
        if momentum:
            mom = utils.tree_map(lambda m, g: momentum * m + g.float(),
                                 state.momentum, grads)
            return utils.tree_map(lambda m: -lr_t * m, mom), SGDState(step, mom)
        return (utils.tree_map(lambda g: -lr_t * g.float(), grads),
                SGDState(step, None))

    return Optimizer(init, update)
