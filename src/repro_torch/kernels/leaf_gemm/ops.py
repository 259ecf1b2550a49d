"""Sorted-dispatch plumbing and the complete kernel FFF inference path
(port of ``repro/kernels/leaf_gemm/ops.py``): route -> slot -> grouped
GEMMs -> unslot.

The capacity-padded layout turns the ragged problem into a fixed-shape one;
tokens overflowing a leaf's capacity take an overflow pass on the same
kernels at a shape fixed by the token count, so results never depend on the
capacity factor and nothing reads a count on the host.
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


def _slots(leaf_idx: torch.Tensor, num_leaves: int,
           valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Each token's slot in its leaf, from sort ranks; with ``valid`` (B,)
    bool a leaf's valid tokens take its slots before its phantom ones."""
    li = leaf_idx.long()
    if valid is None:
        return routing_lib.group_slots(li, num_leaves)
    phantom = (~valid).long()
    n_valid = torch.zeros(num_leaves + 1, dtype=torch.int64,
                          device=li.device).scatter_add_(
        0, li.clamp(max=num_leaves), valid.long())
    return (routing_lib.group_slots(2 * li + phantom, 2 * num_leaves)
            + phantom * n_valid[li.clamp(max=num_leaves)])


def _layout(x: torch.Tensor, li: torch.Tensor, slot: torch.Tensor,
            num_leaves: int, capacity: int, first: int = 0,
            zero: bool = True) -> GroupedLayout:
    """The buffers of slots ``[first, first + capacity)`` of every leaf:
    those tokens go to row ``slot - first`` of their leaf's buffer, all
    others to one spare row past the buffers, which is cut off.  With
    ``zero=False`` the rows past each leaf's tokens are left unwritten."""
    D = x.shape[1]
    kept = (slot >= first) & (slot < first + capacity) & (li < num_leaves)
    row = slot - first
    flat_idx = torch.where(kept, li * capacity + row, num_leaves * capacity)
    xg = (torch.zeros if zero else torch.empty)(
        (num_leaves * capacity + 1, D), dtype=x.dtype, device=x.device)
    xg[flat_idx] = x
    sizes = routing_lib._counts(li, num_leaves) - first
    return GroupedLayout(xg[:-1].view(num_leaves, capacity, D), li,
                         torch.where(kept, row, capacity), kept,
                         sizes.clamp(0, capacity).to(torch.int32))


def scatter_to_groups(x: torch.Tensor, leaf_idx: torch.Tensor,
                      num_leaves: int, capacity: int,
                      valid: Optional[torch.Tensor] = None) -> GroupedLayout:
    """x (B, D) -> capacity-padded per-leaf buffers: an O(B log B) sort for
    the slots and one O(B) scatter.  Dropped tokens (and sentinel-leaf
    tokens) all write to one spare row past the buffers, which is cut off,
    so no dropped token lands in another leaf's slot.  With ``valid`` (B,)
    bool, a leaf's valid tokens take its slots before its phantom ones, so
    which valid tokens fit depends on the valid tokens alone."""
    return _layout(x, leaf_idx.long(), _slots(leaf_idx, num_leaves, valid),
                   num_leaves, capacity)


def gather_from_groups(y_grouped: torch.Tensor, layout: GroupedLayout
                       ) -> torch.Tensor:
    """(E, C, O) -> per-token outputs (B, O); dropped tokens get zeros."""
    E, C, O = y_grouped.shape
    idx = torch.where(layout.kept, layout.leaf_idx * C + layout.slot, 0)
    y = y_grouped.reshape(E * C, O)[idx]
    return torch.where(layout.kept[:, None], y, torch.zeros_like(y))


def capacity(tokens: int, num_leaves: int, capacity_factor: float = 2.0,
             block_c: int = 128) -> int:
    """A leaf's capacity in ``fff_leaf_mlp`` for a slab of ``tokens``:
    ``max(block_c, round_up(int(cf * ceil(tokens / E)), block_c))``."""
    return max(block_c, utils.round_up(
        int(capacity_factor * utils.cdiv(tokens, num_leaves)), block_c))


def grouped_passes(tokens: int, num_leaves: int,
                   capacity_factor: float = 2.0) -> int:
    """The launches of each grouped GEMM a tree in ``fff_leaf_mlp`` for a
    slab of ``tokens``: 1, or 2 where the overflow pass runs."""
    return 1 + bool(overflow_rows(tokens, capacity(tokens, num_leaves,
                                                   capacity_factor)))


def overflow_rows(tokens: int, capacity: int) -> int:
    """The overflow pass's rows a leaf: the most tokens one leaf can hold
    past ``capacity`` in a slab of ``tokens``, rounded up to 32; 0 where
    none can (``tokens <= capacity``), and the pass is left out."""
    return utils.round_up(tokens - capacity, 32) if tokens > capacity else 0


def _grouped_mlp(layout: GroupedLayout, w: list, swiglu: bool,
                 activation: str) -> torch.Tensor:
    """The leaf MLP over a layout's buffers through the grouped GEMMs, its
    outputs gathered back to the tokens (zeros for the rest)."""
    gs = layout.group_sizes
    if swiglu:
        h = K.grouped_matmul_dual(layout.x_grouped, w[0], w[1], gs)
    else:
        h = K.grouped_matmul(layout.x_grouped, w[0], gs, act=activation)
    return gather_from_groups(K.grouped_matmul(h, w[-1], gs, act="none"), layout)


def fff_leaf_mlp(x: torch.Tensor, leaf_idx: torch.Tensor, params: dict, *,
                 activation: str = "gelu", capacity_factor: float = 2.0,
                 block_c: int = 128,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each token's routed leaf MLP through the grouped kernels.

    params: one tree's leaf weights — {leaf_w1 (E,D,l), leaf_w2 (E,l,O)} or
    SwiGLU {leaf_wg, leaf_wu, leaf_wd}.  ``valid`` (B,) bool marks phantom
    tokens (False): they take only the capacity the valid tokens leave, so
    which valid tokens fit, and every valid token's output, never depend on
    a phantom one.  Returns (B, O) in x's dtype.

    Tokens past their leaf's capacity C are exact too, with no host sync:
    an overflow pass runs the same grouped kernels on a second set of
    buffers, slot ``s - C`` of (E, ``overflow_rows(B, C)``, D), whose
    group sizes (the counts past C) the kernels read on the device, so
    their cost follows the real overflow.  Whether the pass runs depends
    on the shape alone (B > C); phantom tokens take it with the valid ones,
    since a row's result in these kernels depends on no other row."""
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
    C = capacity(B, E, capacity_factor, block_c)
    xd, li = x.to(dt), leaf_idx.long()
    slot = _slots(li, E, valid)
    y = _grouped_mlp(_layout(xd, li, slot, E, C), w, swiglu, activation)
    rows = overflow_rows(B, C)
    if rows:
        over = _layout(xd, li, slot, E, rows, first=C)
        y = torch.where(over.kept[:, None],
                        _grouped_mlp(over, w, swiglu, activation), y)
    return y.to(x.dtype)


def fff_infer(x: torch.Tensor, params: dict, cfg: fff_lib.FFFConfig, *,
              capacity_factor: float = 2.0,
              dense_levels: Optional[int] = None,
              return_leaf_idx: bool = False,
              valid: Optional[torch.Tensor] = None):
    """FORWARD_I for a (possibly multi-tree) FFF layer through the kernels:
    routed descent + grouped leaf GEMMs.  x (B, D) -> (B, dim_out), or
    ``(y, leaf_idx (B, trees))`` with ``return_leaf_idx=True``.  ``valid``
    (B,) bool: phantom tokens never take a valid token's capacity
    (``fff_leaf_mlp``)."""
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
                         capacity_factor=capacity_factor, valid=valid)
        out = y if out is None else out + y
        idxs.append(leaf_idx)
    if return_leaf_idx:
        return out, torch.stack(idxs, dim=1)
    return out
