"""Optimizer interface (optax-style init/update pairs), the shared
transforms, and ``value_and_grad``, the counterpart of
``jax.value_and_grad(..., has_aux=True)`` over a parameter tree."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import utils

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]   # (grads, state, params)


def value_and_grad(fn: Callable) -> Callable:
    """``fn(params, *args) -> (loss, aux)`` to ``vg(params, *args) ->
    ((loss, aux), grads)``, grads a tree shaped like ``params``.

    ``fn`` sees aliases of the caller's tensors (``detach()``, no copy)
    that require grad, so the caller's tree is never marked and a
    parameter ``fn`` does not use gets a zero gradient.  The loss and the
    tensors of ``aux`` come back detached.  Params made under ``torch.inference_mode`` cannot
    enter autograd: make them outside it."""
    def vg(params: PyTree, *args, **kw):
        with torch.enable_grad():
            live = utils.tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()),
                                  params)
            leaves = [p for p in utils.tree_leaves(live) if p.requires_grad]
            loss, aux = fn(live, *args, **kw)
            grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        tree = utils.tree_map(
            lambda p: _or_zeros(next(grads), p) if p.requires_grad else None, live)
        aux = utils.tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t, aux)
        return (loss.detach(), aux), tree

    return vg


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """params + updates in float32, each cast back to its param's dtype."""
    with torch.no_grad():
        return utils.tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                              params, updates)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> tuple[PyTree, torch.Tensor]:
    """grads scaled by ``min(1, max_norm / norm)``; as in JAX the float32
    scale promotes every clipped gradient to float32."""
    norm = utils.tree_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return utils.tree_map(lambda g: g.float() * scale, grads), norm


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping."""
    def update(grads, state, params=None, **kw):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params, **kw)
    return Optimizer(opt.init, update)
