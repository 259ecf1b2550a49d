"""Gradient accumulation (port of ``repro/optim/accum.py``): the global
batch split into microbatches run one after another, a loop in place of
the JAX package's ``lax.scan``, so large global batches fit device
memory."""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import utils
from repro_torch.optim.common import value_and_grad

PyTree = Any


def gradient_accumulation(loss_fn: Callable, num_micro: int) -> Callable:
    """loss_fn(params, batch, gen) -> (loss, metrics).

    Returns grad_fn(params, batch, gen) -> (grads, (loss, metrics)), the
    batch's leading dim split into ``num_micro`` microbatches; with more
    than one, the grads are float32 means and metrics hold only ``loss``."""
    vg = value_and_grad(loss_fn)

    def grad_fn(params: PyTree, batch: dict,
                gen: Optional[torch.Generator] = None):
        if num_micro <= 1:
            (loss, metrics), grads = vg(params, batch, gen)
            return grads, (loss, metrics)

        def micro(x, i):
            b = x.shape[0] // num_micro
            return x.reshape(num_micro, b, *x.shape[1:])[i]

        g_sum, l_sum = None, torch.zeros(())
        for i in range(num_micro):
            mb = {k: micro(v, i) for k, v in batch.items()}
            (loss, _), grads = vg(params, mb, gen)
            grads = utils.tree_map(lambda g: g.float(), grads)
            g_sum = grads if g_sum is None else utils.tree_map(torch.add, g_sum, grads)
            l_sum = l_sum.to(loss.device) + loss
        scale = 1.0 / num_micro
        grads = utils.tree_map(lambda g: g * scale, g_sum)
        loss = l_sum * scale
        return grads, (loss, {"loss": loss})

    return grad_fn
