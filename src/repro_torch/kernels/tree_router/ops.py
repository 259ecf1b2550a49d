"""Wrapper for the tree_router kernel (port of ``repro/kernels/tree_router/
ops.py``): the dense/gather level split for deep trees and the forest
variant."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.tree_router import kernel as K
from repro_torch.kernels.tree_router import ref as R


def route(x: torch.Tensor, node_w: torch.Tensor, node_b: torch.Tensor, *,
          depth: int, dense_levels: Optional[int] = None) -> torch.Tensor:
    """Leaf index per token.  x (B, D); node_w (N, D); node_b (N,).

    ``dense_levels`` caps how many levels the kernel routes from its dense
    logits (default: all levels up to 8); deeper levels descend by per-token
    gathers.  The JAX wrapper pads B to ``pick_tile(B, 256)``, which always
    divides B, so its pad is empty; the CUDA kernel masks its ragged last
    tile, so nothing is padded here."""
    if dense_levels is None:
        dense_levels = min(depth, 8)
    dense_levels = min(dense_levels, depth)
    if dense_levels == 0:
        return R.tree_router_ref(x, node_w, node_b, depth=depth)
    dt = torch.promote_types(x.dtype, node_w.dtype)
    n_dense = 2 ** dense_levels - 1
    idx = K.tree_router(x.to(dt).contiguous(),
                        node_w[:n_dense].to(dt).contiguous(),
                        node_b[:n_dense].to(dt).contiguous(),
                        depth=dense_levels).long()
    # finish deep levels with the gather path
    for m in range(dense_levels, depth):
        g = (2 ** m - 1) + idx
        logit = (x.float() * node_w[g].float()).sum(-1) + node_b[g].float()
        idx = 2 * idx + (logit >= 0.0).long()
    return idx.to(torch.int32)


def route_forest(x: torch.Tensor, node_w: torch.Tensor, node_b: torch.Tensor,
                 *, depth: int, **kw) -> torch.Tensor:
    """Forest variant: node_w (T, N, D), node_b (T, N) -> (B, T)."""
    return torch.stack([route(x, node_w[t], node_b[t], depth=depth, **kw)
                        for t in range(node_w.shape[0])], dim=1)
