"""Token -> leaf dispatch (port of ``repro/core/routing.py``).

* Sorted dispatch: sort tokens by routed leaf, run the leaves over
  contiguous per-leaf runs, scatter results back.
* Switch-style capacity-bounded dispatch: each leaf gets ``C`` slots per
  (data shard, leaf); tokens past them are dropped, and the caller's
  overflow policy decides what they get (``core/fff.py``).
* ``grouped_leaf_apply``: the leaf execution of the ``grouped`` backends
  over capacity-padded ``(E, C, D)`` buffers.  Serving (``serving=True``)
  on a CUDA tensor runs the hand-written grouped GEMMs of
  ``kernels/leaf_gemm`` (or raises); training (``serving=False``, the
  straight-through estimator) and the CPU run the JAX package's einsums,
  which autograd differentiates.  The kernels are forward-only.
* ``grouped_leaf_apply_ep``: the ``grouped_ep`` backend's expert-parallel
  form over the model process group that ``distributed/act`` installs:
  tokens travel to the rank owning their leaf by ``all_to_all`` and back.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import utils
from repro_torch.distributed import act as dist_act
from repro_torch.distributed import dispatch as dispatch_lib
from repro_torch.kernels.leaf_gemm import kernel as gemm_kernel
from repro_torch.kernels.leaf_gemm import ref as gemm_ref


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``idx`` equal each of 0..n-1 (ids >= n are not counted),
    int64, without the host sync of ``torch.bincount`` on a card."""
    idx = idx.reshape(-1).long().clamp(max=n)
    out = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    return out.index_add_(0, idx, torch.ones_like(idx))[:n]


class SortedDispatch(NamedTuple):
    """A plan for grouped execution of tokens sorted by leaf id.

    sort_idx:    (B,) permutation; x_sorted = x[sort_idx]
    unsort_idx:  (B,) inverse permutation
    group_sizes: (E,) tokens routed to each leaf
    group_offsets: (E+1,) exclusive prefix sums of group_sizes
    leaf_ids_sorted: (B,) leaf id per sorted slot
    """
    sort_idx: torch.Tensor
    unsort_idx: torch.Tensor
    group_sizes: torch.Tensor
    group_offsets: torch.Tensor
    leaf_ids_sorted: torch.Tensor


def make_sorted_dispatch(leaf_idx: torch.Tensor, num_leaves: int
                         ) -> SortedDispatch:
    """The sorted-dispatch plan from per-token leaf ids (B,)."""
    sort_idx = torch.argsort(leaf_idx, stable=True)
    sizes = _counts(leaf_idx, num_leaves)
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    i32 = torch.int32
    return SortedDispatch(sort_idx.to(i32), torch.argsort(sort_idx).to(i32),
                          sizes.to(i32), offsets.to(i32),
                          leaf_idx[sort_idx].to(i32))


def apply_sorted(x: torch.Tensor, plan: SortedDispatch) -> torch.Tensor:
    return x[plan.sort_idx.long()]


def unapply_sorted(y_sorted: torch.Tensor, plan: SortedDispatch) -> torch.Tensor:
    return y_sorted[plan.unsort_idx.long()]


# ---------------------------------------------------------------------------
# capacity-bounded dispatch
# ---------------------------------------------------------------------------

class CapacityDispatch(NamedTuple):
    """Scatter/gather dispatch plan bounded by per-leaf capacity C.

    flat_idx: (B,) position ``leaf*C + slot`` in the flattened (E*C,)
              buffer; dropped tokens carry the sentinel E*C
    kept:     (B,) bool; False = the token overflowed its leaf's capacity
    """
    flat_idx: torch.Tensor
    kept: torch.Tensor
    capacity: int
    num_leaves: int


def _as_ep_plan(plan: CapacityDispatch) -> dispatch_lib.EPPlan:
    """A CapacityDispatch is the one-rank case of the EP exchange plan."""
    return dispatch_lib.EPPlan(plan.flat_idx, plan.kept, plan.capacity,
                               plan.num_leaves, 1)


def make_capacity_dispatch(leaf_idx: torch.Tensor, num_leaves: int,
                           capacity_factor: float = 1.25) -> CapacityDispatch:
    B = leaf_idx.shape[0]
    capacity = max(1, int(capacity_factor * utils.cdiv(B, num_leaves)))
    slot = group_slots(leaf_idx, num_leaves)
    p = dispatch_lib.make_ep_plan(
        leaf_idx, slot, torch.ones(B, dtype=torch.bool, device=leaf_idx.device),
        num_leaves, num_shards=1, capacity=capacity)
    return CapacityDispatch(p.flat_idx, p.kept, capacity, num_leaves)


def capacity_gather(x: torch.Tensor, plan: CapacityDispatch) -> torch.Tensor:
    """x (B, D) -> per-leaf buffers (E, C, D): one O(B) scatter."""
    return dispatch_lib.ep_scatter(x, _as_ep_plan(plan))[0]


def capacity_scatter(y: torch.Tensor, plan: CapacityDispatch) -> torch.Tensor:
    """(E, C, O) -> (B, O); dropped tokens receive zeros."""
    E, C, O = y.shape
    return dispatch_lib.ep_gather(y.reshape(E * C, O), _as_ep_plan(plan))


# ---------------------------------------------------------------------------
# grouped leaf execution over capacity-padded buffers
# ---------------------------------------------------------------------------

def grouped_leaf_matmul_ref(x_sorted: torch.Tensor,
                            leaf_ids_sorted: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """y[i] = x_sorted[i] @ w[leaf_ids_sorted[i]] in float32: x (B, D), w
    (E, D, H) -> (B, H)."""
    return utils.einsum_as("bd,bdh->bh", x_sorted, w[leaf_ids_sorted.long()],
                           out_dtype=torch.float32)


def group_slots(leaf_idx: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-token slot index within its routed group, O(B log B).

    slot[i] = |{j : leaf[j] == leaf[i], j < i}|, computed from sort ranks:
    rank_in_sorted(i) - group_offset(leaf[i]) — never a (B, E) cumsum of a
    one-hot.  Ids >= ``num_groups`` (the sentinel leaf) are slotted as one
    more group after the real ones."""
    B = leaf_idx.shape[0]
    idx = leaf_idx.long()
    sort_idx = torch.argsort(idx, stable=True)
    rank = torch.empty(B, dtype=torch.int64, device=idx.device)
    rank[sort_idx] = torch.arange(B, device=idx.device)
    sizes = torch.bincount(idx.clamp(max=num_groups), minlength=num_groups + 1)
    offsets = torch.cumsum(sizes, 0) - sizes                  # exclusive scan
    return rank - offsets[idx.clamp(max=num_groups)]


def _leaf_mlp_on_buffers(xbuf: torch.Tensor, params: dict, activation: str,
                         accum_dtype, group_sizes=None) -> torch.Tensor:
    """Per-leaf MLP on capacity-padded buffers: (..., E, C, D) -> (..., E,
    C, O).  ``params`` holds one tree's leaf weights on the same leading E
    axis as ``xbuf``.

    The serving paths' form.  On a CUDA tensor this runs the grouped GEMMs
    of ``kernels/leaf_gemm`` in the buffer's dtype (float32 accumulation
    inside), skipping rows at or past ``group_sizes`` (..., E) (None =
    every row); if a kernel does not build or launch, this raises.  On the
    CPU it is ``_leaf_mlp_einsums``."""
    if xbuf.device.type == "cuda":
        return _leaf_mlp_kernels(xbuf, params, activation, group_sizes)
    return _leaf_mlp_einsums(xbuf, params, activation, accum_dtype)


def _leaf_mlp_einsums(xbuf: torch.Tensor, params: dict, activation: str,
                      accum_dtype) -> torch.Tensor:
    """The JAX package's per-leaf MLP einsums in ``accum_dtype`` on either
    device: (..., E, C, D) -> (..., E, C, O), differentiable."""
    ad = accum_dtype
    if "leaf_wg" in params:
        g = utils.einsum_as("...ecd,edh->...ech", xbuf, params["leaf_wg"], out_dtype=ad)
        u = utils.einsum_as("...ecd,edh->...ech", xbuf, params["leaf_wu"], out_dtype=ad)
        return utils.einsum_as("...ech,eho->...eco", F.silu(g) * u,
                               params["leaf_wd"], out_dtype=ad)
    h = utils.einsum_as("...ecd,edh->...ech", xbuf, params["leaf_w1"], out_dtype=ad)
    if "leaf_b1" in params:
        h = h + params["leaf_b1"][:, None].to(ad)
    h = utils.get_activation(activation)(h)
    y = utils.einsum_as("...ech,eho->...eco", h, params["leaf_w2"], out_dtype=ad)
    if "leaf_b2" in params:
        y = y + params["leaf_b2"][:, None].to(ad)
    return y


def _leaf_mlp_kernels(xbuf, params, activation, group_sizes):
    """The CUDA branch of ``_leaf_mlp_on_buffers``: one grouped GEMM launch
    per projection per leading index (one for an unblocked token axis).
    Activations the kernels cannot fuse, and biases, are applied between
    the launches (rows past a group's size are never gathered)."""
    *lead, E, C, D = xbuf.shape
    dt = xbuf.dtype
    w = {k: v.to(dt).contiguous() for k, v in params.items()}
    if group_sizes is None:
        gss = [torch.full((E,), C, dtype=torch.int32, device=xbuf.device)
               ] * math.prod(lead)
    else:
        gss = list(group_sizes.to(torch.int32).reshape(-1, E))
    out = []
    for xb, gs in zip(xbuf.reshape(-1, E, C, D), gss):
        if "leaf_wg" in w:
            h = gemm_kernel.grouped_matmul_dual(xb, w["leaf_wg"], w["leaf_wu"], gs)
            out.append(gemm_kernel.grouped_matmul(h, w["leaf_wd"], gs))
            continue
        fused = activation in gemm_ref.ACTS and "leaf_b1" not in w
        h = gemm_kernel.grouped_matmul(xb, w["leaf_w1"], gs,
                                       act=activation if fused else "none")
        if not fused:
            if "leaf_b1" in w:
                h = h + w["leaf_b1"][:, None]
            h = utils.get_activation(activation)(h)
        y = gemm_kernel.grouped_matmul(h, w["leaf_w2"], gs)
        out.append(y + w["leaf_b2"][:, None] if "leaf_b2" in w else y)
    return torch.stack(out).reshape(*lead, E, C, out[0].shape[-1])


def _pad_tokens(x: torch.Tensor, leaf_idx: torch.Tensor, multiple: int,
                num_leaves: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad the token axis up to ``multiple`` with capacity-neutral tokens:
    pads carry the sentinel leaf id E, slot into a virtual group past every
    real leaf (``group_slots(..., E + 1)``), never occupy a real leaf's slot
    and gather zeros.  Callers slice results back to the true count."""
    B = x.shape[0]
    Bp = utils.round_up(max(B, 1), multiple)
    if Bp == B:
        return x, leaf_idx
    xb = torch.zeros((Bp,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    xb[:B] = x
    ib = torch.full((Bp,), num_leaves, dtype=leaf_idx.dtype, device=x.device)
    ib[:B] = leaf_idx
    return xb, ib


def _num_leaves(params: dict) -> int:
    return (params["leaf_wg"] if "leaf_wg" in params else params["leaf_w1"]).shape[0]


def grouped_leaf_apply(x: torch.Tensor, leaf_idx: torch.Tensor, params: dict,
                       activation: str, capacity_factor: float = 1.5,
                       accum_dtype=torch.float32, serving: bool = False,
                       return_kept: bool = False):
    """Capacity-bounded grouped leaf execution.

    The token axis is blocked by the data-shard count G (padded with
    capacity-neutral tokens when B % G != 0), so capacity is per (shard,
    leaf): ``max(8, round_up(int(cf * ceil(B/G / E)), 8))``.  Tokens over
    their shard's capacity contribute zeros; the caller's overflow policy
    decides what they get instead.  ``serving`` picks the leaf MLP: True
    (the inference backends) lets a CUDA buffer run the forward-only
    grouped GEMMs; False (the straight-through training backend) keeps the
    differentiable einsums on every device.

    x (B, D); params: one tree's leaf weights {leaf_w1/leaf_w2} or
    {leaf_wg/leaf_wu/leaf_wd}.  Returns (B, dim_out) in ``accum_dtype``, or
    ``(y, kept)`` with ``return_kept=True``, ``kept`` (B,) bool marking the
    tokens that fit under capacity."""
    B, D = x.shape
    E = _num_leaves(params)
    G = dist_act.data_shard_count()
    x, leaf_idx = _pad_tokens(x, leaf_idx, G, E)
    Bg = x.shape[0] // G
    capacity = max(8, utils.round_up(int(capacity_factor * utils.cdiv(Bg, E)), 8))
    idx_g = leaf_idx.long().clamp(max=E).reshape(G, Bg)
    # slot within (shard, leaf) from sort ranks over the combined key; E + 1
    # groups a shard, so pads (leaf id E) slot into a virtual group of their own
    shard = torch.arange(G, device=x.device)[:, None]
    slot = group_slots((shard * (E + 1) + idx_g).reshape(-1),
                       G * (E + 1)).reshape(G, Bg)
    kept = (slot < capacity) & (idx_g < E)
    # dropped tokens all go to one spare row past the buffers, which is cut
    # off: none of them lands on a kept token's slot
    n = E * capacity
    flat = torch.where(kept, shard * n + idx_g * capacity + slot, G * n).reshape(-1)
    xbuf = torch.zeros((G * n + 1, D), dtype=x.dtype, device=x.device)
    xbuf[flat] = x
    xbuf = xbuf[:-1].view(G, E, capacity, D)
    if serving:
        sizes = _counts(torch.where(kept, shard * E + idx_g, G * E), G * E).view(G, E)
        yg = _leaf_mlp_on_buffers(xbuf, params, activation, accum_dtype, sizes)
    else:
        yg = _leaf_mlp_einsums(xbuf, params, activation, accum_dtype)
    O = yg.shape[-1]
    kept = kept.reshape(-1)
    y = yg.reshape(G * n, O)[torch.where(kept, flat, 0)]
    y = torch.where(kept[:, None], y, torch.zeros_like(y)).to(accum_dtype)[:B]
    if return_kept:
        return y, kept[:B]
    return y


# ---------------------------------------------------------------------------
# the overflow repair and expert-parallel grouped leaf execution
# ---------------------------------------------------------------------------

def _dense_leaf_gather(x: torch.Tensor, leaf_idx: torch.Tensor, params: dict,
                       activation: str, accum_dtype) -> torch.Tensor:
    """Exact per-token leaf evaluation: x (B, D), leaf_idx (B,) indexing
    the leaf axis of ``params`` -> (B, O), computed leaf by leaf over the
    tokens routed to it (JAX gathers a (B, D, l) weight copy, ~13 GB a
    weight in bf16 at full width and 1024 tokens).  The overflow repair,
    paid only for tokens that overflowed capacity."""
    # imported here: core/fff imports this module for its grouped paths
    from repro_torch.core import fff as fff_lib
    return fff_lib.leaf_apply_grouped(params, x, leaf_idx, activation,
                                      accum_dtype)


def _repair(y: torch.Tensor, dropped: torch.Tensor, x: torch.Tensor,
            leaf_idx: torch.Tensor, params: dict, activation: str,
            accum_dtype) -> torch.Tensor:
    """y with the ``dropped`` rows replaced by their exact leaf outputs; the
    rest untouched (the JAX package's ``lax.cond`` on ``dropped.any()``)."""
    rows = torch.nonzero(dropped).squeeze(1)
    if rows.numel():
        y = y.clone()
        y[rows] = _dense_leaf_gather(x[rows], leaf_idx[rows], params,
                                     activation, accum_dtype).to(y.dtype)
    return y


def _all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in group-rank order."""
    if t.dtype == torch.bool:
        return _all_gather_cat(t.to(torch.uint8), group).bool()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def grouped_leaf_apply_ep(x: torch.Tensor, leaf_idx: torch.Tensor,
                          params: dict, activation: str,
                          capacity_factor: float = 1.25,
                          accum_dtype=torch.float32, return_kept: bool = False,
                          overflow_policy: str = "exact_dense"):
    """Expert-parallel grouped leaf execution, exact by default.

    Over the model group M that ``distributed/act`` installs (and the data
    group G, if any): the padded token axis is split over the G * M ranks,
    data-major, and model rank m owns leaves ``[m*E/M, (m+1)*E/M)``.  Each
    rank slots its Bl tokens per leaf into an (M, E/M, C, D) send buffer,
    one ``all_to_all`` over the model group delivers each leaf's tokens to
    its owner, the owner runs its leaves at (E/M, M*C), and the inverse
    ``all_to_all`` returns the results.  Capacity is per (source rank, leaf)
    (``dispatch.ep_capacity``).  Every rank passes the full ``params`` and
    the global ``x`` and reads only its own leaves and tokens; the global
    outputs are reassembled with an ``all_gather``, so every rank returns
    the same (B, O).

    ``overflow_policy``: "exact_dense" (default) repairs over-capacity
    tokens when any rank dropped one (an ``all_reduce`` of the count): an
    ``all_gather`` of the dropped tokens over the model group, a dense
    evaluation of each rank's own leaves and an ``all_reduce``.
    "master_leaf" and "drop" never run that round: dropped tokens keep
    their zeros (``api.apply``'s master term, when enabled, stands in).

    With no group installed (or a model group of 1, or E % M != 0) this is
    the local grouped dispatch plus the same repair.  Returns (B, O), or
    ``(y, kept)`` with ``return_kept=True``; ``kept`` False marks tokens
    that overflowed and took the policy's overflow path."""
    E = _num_leaves(params)
    M = dist_act.model_shard_count()
    if not dist_act.mesh_installed() or M <= 1 or E % M:
        y, kept = grouped_leaf_apply(
            x, leaf_idx, params, activation, capacity_factor=capacity_factor,
            accum_dtype=accum_dtype, serving=True, return_kept=True)
        if overflow_policy == "exact_dense":
            # only real overflow: sentinel-padded tokens (leaf id E) are
            # never kept and need no repair
            y = _repair(y, ~kept & (leaf_idx < E), x, leaf_idx, params,
                        activation, accum_dtype)
        return (y, kept) if return_kept else y

    B = x.shape[0]
    model, data = dist_act.current_groups()
    S = dist_act.data_shard_count() * M
    E_local = E // M
    m = dist.get_rank(model)
    s = (dist.get_rank(data) if data is not None else 0) * M + m
    x, leaf_idx = _pad_tokens(x, leaf_idx, S, E)
    Bl = x.shape[0] // S
    C = dispatch_lib.ep_capacity(Bl, E, capacity_factor)
    x_l = x[s * Bl:(s + 1) * Bl]
    idx_l = leaf_idx[s * Bl:(s + 1) * Bl].long()
    leaves_l = {k: v[m * E_local:(m + 1) * E_local] for k, v in params.items()}

    valid = idx_l < E
    slot = group_slots(idx_l, E + 1)       # pads slot into a virtual group
    plan = dispatch_lib.make_ep_plan(idx_l, slot, valid, E, M, C)
    xr = dispatch_lib.ep_exchange(dispatch_lib.ep_scatter(x_l, plan), model, plan)
    yr = _leaf_mlp_on_buffers(xr, leaves_l, activation, accum_dtype)
    y_l = dispatch_lib.ep_gather(dispatch_lib.ep_combine(yr, model, plan),
                                 plan).to(accum_dtype)

    if overflow_policy == "exact_dense":
        dropped = valid & ~plan.kept
        n_drop = dropped.sum().reshape(1)
        for g in (model, data):
            if g is not None:
                dist.all_reduce(n_drop, group=g)
        if int(n_drop) > 0:
            # every model peer sees every dropped token of its data row,
            # evaluates the leaves it owns, and an all_reduce assembles them
            xg = _all_gather_cat(torch.where(dropped[:, None], x_l,
                                             torch.zeros_like(x_l)), model)
            ig = _all_gather_cat(torch.where(dropped, idx_l, 0), model)
            dg = _all_gather_cat(dropped, model)
            off = m * E_local
            own = dg & (ig >= off) & (ig < off + E_local)
            yd = torch.zeros((M * Bl, y_l.shape[-1]), dtype=accum_dtype,
                             device=x.device)
            yd = _repair(yd, own, xg, (ig - off).clamp(0, E_local - 1),
                         leaves_l, activation, accum_dtype)
            dist.all_reduce(yd, group=model)
            mine = yd[m * Bl:(m + 1) * Bl]
            y_l = torch.where(dropped[:, None], mine, y_l)

    y, kept = y_l, plan.kept
    for g in (model, data):
        if g is not None:
            y, kept = _all_gather_cat(y, g), _all_gather_cat(kept, g)
    y, kept = y[:B], kept[:B]
    return (y, kept) if return_kept else y


def leaf_histogram(leaf_idx: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """Load histogram over leaves (ids >= num_leaves are not counted)."""
    return _counts(leaf_idx, num_leaves)


def routing_skew(leaf_idx: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """max-load / mean-load; 1.0 = perfectly balanced."""
    h = leaf_histogram(leaf_idx, num_leaves).float()
    return h.max() / h.mean().clamp(min=1e-9)
