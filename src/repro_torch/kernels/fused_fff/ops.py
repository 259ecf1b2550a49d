"""The small-slab kernel path (port of ``repro/kernels/fused_fff/ops.py``):
route, then each token's own leaf MLP through the gathered kernels, with
no sort, scatter or capacity bound.  Exact for any batch; the ``cuda``
backend takes it for slabs of at most ``PALLAS_DECODE_MAX_TOKENS`` tokens
(``core/api.py``), where the grouped path's sorted dispatch costs more than
it saves.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import fff as fff_lib
from repro_torch.kernels.fused_decode import ops as fused_decode_ops
from repro_torch.kernels.fused_fff import kernel as K
from repro_torch.kernels.tree_router import ops as router_ops


def gathered_leaf_mlp(x: torch.Tensor, leaf_idx: torch.Tensor, params: dict,
                      *, activation: str = "gelu") -> torch.Tensor:
    """Each token's routed leaf MLP, one gathered launch per product.

    params: one tree's leaf weights, {leaf_w1 (E,D,l), leaf_w2 (E,l,O)} or
    SwiGLU {leaf_wg, leaf_wu, leaf_wd}.  The operands go to the kernels in
    the widest of x's and the weights' dtypes; the hidden activation rounds
    to x's dtype between the products, as the JAX path stores it.  Returns
    (B, O) in x's dtype."""
    if "leaf_b1" in params or "leaf_b2" in params:
        raise ValueError("kernel path requires bias-free leaves")
    swiglu = "leaf_wg" in params
    names = ("leaf_wg", "leaf_wu", "leaf_wd") if swiglu else ("leaf_w1", "leaf_w2")
    dt = x.dtype
    for n in names:
        dt = torch.promote_types(dt, params[n].dtype)
    w = [params[n].to(dt).contiguous() for n in names]
    xk = x.to(dt).contiguous()
    idx = leaf_idx.to(torch.int32).contiguous()
    if swiglu:
        h = K.gathered_matmul_dual(xk, w[0], w[1], idx)
    else:
        h = K.gathered_matmul(xk, w[0], idx, act=activation)
    h = h.to(x.dtype).to(dt)
    return K.gathered_matmul(h, w[-1], idx, act="none").to(x.dtype)


def fff_decode(x: torch.Tensor, params: dict, cfg: fff_lib.FFFConfig, *,
               dense_levels: Optional[int] = None,
               return_leaf_idx: bool = False):
    """Exact FORWARD_I through the router and gathered kernels.  x (B, D)
    -> (B, dim_out) summed over the forest's trees; with
    ``return_leaf_idx=True`` ``(y, leaf_idx (B, trees) int32)``."""
    if cfg.node_width != 1:
        raise ValueError("kernel path supports node_width == 1 (paper default)")
    nw, nb = fused_decode_ops.collapse_nodes(params, cfg)
    out = None
    idxs = []
    for t in range(cfg.trees):
        leaf_idx = router_ops.route(x, nw[t], nb[t], depth=cfg.depth,
                                    dense_levels=dense_levels)
        tree_leaves = {k: v[t] for k, v in params.items()
                       if k.startswith("leaf_")}
        y = gathered_leaf_mlp(x, leaf_idx, tree_leaves,
                              activation=cfg.activation)
        out = y if out is None else out + y
        idxs.append(leaf_idx)
    if return_leaf_idx:
        return out, torch.stack(idxs, dim=1)
    return out
