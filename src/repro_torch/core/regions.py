"""Input-space regionalization utilities (port of ``repro/core/
regions.py``; paper §Regions of responsibility).

Each FFF leaf owns one region of the learned tree partition.  For node width
n = 1 the boundary at each node is the activation hyperplane of its single
neuron, so every leaf region is an intersection of half-spaces —
algebraically identifiable, which the paper highlights for
interpretability, surgical model editing and replay-budget reduction.  The
half-spaces are numpy (host-side analysis); the routing they are held
against is the port's ``fff.route_hard``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import fff


class Halfspace(NamedTuple):
    normal: np.ndarray   # (dim_in,)
    offset: float        # region satisfies sign * (normal . x + offset) >= 0
    sign: int            # +1 if the path took the right child here


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def leaf_region(params: fff.Params, cfg: fff.FFFConfig, leaf: int,
                tree: int = 0) -> list[Halfspace]:
    """The half-space constraints defining ``leaf``'s region of responsibility."""
    if cfg.node_width != 1:
        raise ValueError("closed-form regions require node_width == 1")
    constraints = []
    idx = 0
    w1 = _host(params["node_w1"][tree, :, :, 0])
    b1 = _host(params["node_b1"][tree, :, 0])
    w2 = _host(params["node_w2"][tree, :, 0])
    b2 = _host(params["node_b2"][tree])
    for m in range(cfg.depth):
        bit = (leaf >> (cfg.depth - 1 - m)) & 1
        g = 2 ** m - 1 + idx
        # logit(x) = w2 * (w1 . x + b1) + b2; right child iff logit >= 0
        normal = w2[g] * w1[g]
        offset = w2[g] * b1[g] + b2[g]
        constraints.append(Halfspace(normal, float(offset), +1 if bit else -1))
        idx = 2 * idx + bit
    return constraints


def region_membership(constraints: list[Halfspace], x: np.ndarray) -> np.ndarray:
    """Vectorized membership test for a batch of points (B, D) -> (B,) bool."""
    ok = np.ones(x.shape[0], bool)
    for c in constraints:
        val = x @ c.normal + c.offset
        ok &= (val >= 0) if c.sign > 0 else (val < 0)
    return ok


def partition_histogram(params: fff.Params, cfg: fff.FFFConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """How many of the given samples fall into each leaf region: (T, 2^d)."""
    leaf_idx = fff.route_hard(params, cfg, x).reshape(-1, cfg.trees).long()
    return torch.stack([torch.bincount(leaf_idx[:, t], minlength=cfg.num_leaves)
                        for t in range(cfg.trees)])


def is_partition(params: fff.Params, cfg: fff.FFFConfig, x: torch.Tensor) -> bool:
    """Every sample belongs to exactly one closed-form region, and it is the
    region of the leaf FORWARD_I selects — the partition invariant."""
    xf = _host(x.reshape(-1, cfg.dim_in))
    routed = fff.route_hard(params, cfg, x).reshape(-1, cfg.trees).cpu().numpy()
    for t in range(cfg.trees):
        membership = np.zeros(xf.shape[0], dtype=int)
        agree = np.zeros(xf.shape[0], dtype=bool)
        for leaf in range(cfg.num_leaves):
            cons = leaf_region(params, cfg, leaf, tree=t)
            inside = region_membership(cons, xf)
            membership += inside.astype(int)
            agree |= inside & (routed[:, t] == leaf)
        if not (membership == 1).all() or not agree.all():
            return False
    return True
