"""Plain PyTorch version of the tree_router kernel (port of
``repro/kernels/tree_router/ref.py``): FORWARD_I descent only, one tree,
node width 1."""
from __future__ import annotations

import torch


def tree_router_ref(x: torch.Tensor, node_w: torch.Tensor,
                    node_b: torch.Tensor, *, depth: int) -> torch.Tensor:
    """x (B, D), node_w (N, D), node_b (N,) -> (B,) int32 leaf indices."""
    xf = x.float()
    idx = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for m in range(depth):
        g = (2 ** m - 1) + idx                       # global node ids (B,)
        logit = (xf * node_w[g].float()).sum(-1) + node_b[g].float()
        idx = 2 * idx + (logit >= 0.0).long()
    return idx.to(torch.int32)
