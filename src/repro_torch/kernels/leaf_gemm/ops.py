"""Sorted-dispatch plumbing and the complete kernel FFF inference path
(port of ``repro/kernels/leaf_gemm/ops.py``): route -> slot -> grouped
GEMMs -> unslot.

The capacity-padded layout turns the ragged problem into a fixed-shape one;
tokens overflowing a leaf's capacity are repaired exactly (overflow-to-
dense), so results never depend on the capacity factor.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import utils
from repro_torch.core import fff as fff_lib
from repro_torch.core import routing as routing_lib
from repro_torch.kernels.fused_decode import ops as fused_decode_ops
from repro_torch.kernels.leaf_gemm import kernel as K
from repro_torch.kernels.tree_router import ops as router_ops


class GroupedLayout(NamedTuple):
    x_grouped: torch.Tensor    # (E, C, D) capacity-padded sorted tokens
    leaf_idx: torch.Tensor     # (B,) routed leaf per original token
    slot: torch.Tensor         # (B,) slot in the leaf's buffer; == capacity
                               # marks a dropped token (mask with `kept`)
    kept: torch.Tensor         # (B,) bool: token fit under capacity
    group_sizes: torch.Tensor  # (E,) int32, clipped to capacity


def scatter_to_groups(x: torch.Tensor, leaf_idx: torch.Tensor,
                      num_leaves: int, capacity: int) -> GroupedLayout:
    """x (B, D) -> capacity-padded per-leaf buffers: an O(B log B) sort for
    the slots and one O(B) scatter.  Dropped tokens (and sentinel-leaf
    tokens) all write to one spare row past the buffers, which is cut off,
    so no dropped token lands in another leaf's slot."""
    B, D = x.shape
    li = leaf_idx.long()
    slot = routing_lib.group_slots(li, num_leaves)
    kept = (slot < capacity) & (li < num_leaves)
    slot_c = torch.where(kept, slot, capacity)
    flat_idx = torch.where(kept, li * capacity + slot, num_leaves * capacity)
    xg = torch.zeros((num_leaves * capacity + 1, D), dtype=x.dtype,
                     device=x.device)
    xg[flat_idx] = x
    sizes = torch.bincount(li.clamp(max=num_leaves),
                           minlength=num_leaves + 1)[:num_leaves]
    return GroupedLayout(xg[:-1].view(num_leaves, capacity, D), li, slot_c,
                         kept, sizes.clamp(max=capacity).to(torch.int32))


def gather_from_groups(y_grouped: torch.Tensor, layout: GroupedLayout
                       ) -> torch.Tensor:
    """(E, C, O) -> per-token outputs (B, O); dropped tokens get zeros."""
    E, C, O = y_grouped.shape
    idx = torch.where(layout.kept, layout.leaf_idx * C + layout.slot, 0)
    y = y_grouped.reshape(E * C, O)[idx]
    return torch.where(layout.kept[:, None], y, torch.zeros_like(y))


def fff_leaf_mlp(x: torch.Tensor, leaf_idx: torch.Tensor, params: dict, *,
                 activation: str = "gelu", capacity_factor: float = 2.0,
                 block_c: int = 128) -> torch.Tensor:
    """Each token's routed leaf MLP through the grouped kernels.

    params: one tree's leaf weights — {leaf_w1 (E,D,l), leaf_w2 (E,l,O)} or
    SwiGLU {leaf_wg, leaf_wu, leaf_wd}.  Returns (B, O) in x's dtype."""
    if "leaf_b1" in params or "leaf_b2" in params:
        # biases break the zero-row padding invariant of the skipped tiles
        raise ValueError("kernel path requires bias-free leaves")
    B, D = x.shape
    swiglu = "leaf_wg" in params
    names = ("leaf_wg", "leaf_wu", "leaf_wd") if swiglu else ("leaf_w1", "leaf_w2")
    dt = x.dtype
    for n in names:
        dt = torch.promote_types(dt, params[n].dtype)
    w = [params[n].to(dt).contiguous() for n in names]
    E = w[0].shape[0]
    capacity = max(block_c,
                   utils.round_up(int(capacity_factor * utils.cdiv(B, E)),
                                  block_c))
    layout = scatter_to_groups(x.to(dt), leaf_idx, E, capacity)
    if swiglu:
        h = K.grouped_matmul_dual(layout.x_grouped, w[0], w[1],
                                  layout.group_sizes)
        yg = K.grouped_matmul(h, w[2], layout.group_sizes, act="none")
    else:
        h = K.grouped_matmul(layout.x_grouped, w[0], layout.group_sizes,
                             act=activation)
        yg = K.grouped_matmul(h, w[1], layout.group_sizes, act="none")
    y = gather_from_groups(yg, layout).to(x.dtype)

    # overflow-to-dense: the exact leaf output for dropped tokens only,
    # leaf by leaf (plain torch, as the JAX package computes it outside
    # Pallas; its per-token gathered weights would be ~13 GB per weight in
    # bf16 at full width and 1024 tokens)
    dropped = torch.nonzero(~layout.kept).squeeze(1)
    if dropped.numel():
        dense = fff_lib.leaf_apply_grouped(
            params, x[dropped], leaf_idx[dropped],
            "swiglu" if swiglu else activation, torch.float32)
        y[dropped] = dense.to(x.dtype)
    return y


def fff_infer(x: torch.Tensor, params: dict, cfg: fff_lib.FFFConfig, *,
              capacity_factor: float = 2.0,
              dense_levels: Optional[int] = None,
              return_leaf_idx: bool = False):
    """FORWARD_I for a (possibly multi-tree) FFF layer through the kernels:
    routed descent + grouped leaf GEMMs.  x (B, D) -> (B, dim_out), or
    ``(y, leaf_idx (B, trees))`` with ``return_leaf_idx=True``."""
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
        y = fff_leaf_mlp(x, leaf_idx, tree_leaves, activation=cfg.activation,
                         capacity_factor=capacity_factor)
        out = y if out is None else out + y
        idxs.append(leaf_idx)
    if return_leaf_idx:
        return out, torch.stack(idxs, dim=1)
    return out
