"""Expert-parallel all_to_all dispatch plans (port of
``repro/distributed/dispatch.py``).

Generic token -> group exchange for groups (FFF leaves) owned by the ranks
of a ``torch.distributed`` process group.  The caller brings per-token group
ids and slot ranks (``core/routing.group_slots``: sort ranks, never a
cumsum of a one-hot); this module owns the send-buffer layout, the
collective exchange and its inverse, and the capacity accounting.  It has no
model knowledge: tensors in, tensors out.

Layout contract (shapes per rank):

* groups are numbered globally ``0..E-1`` and owned contiguously: rank
  ``s`` of the ``M``-rank group owns groups ``[s*E/M, (s+1)*E/M)``;
* each source rank slots its ``Bl`` local tokens per group with capacity
  ``C`` per (source rank, group) pair and scatters them into an
  ``(M, E/M, C, D)`` send buffer;
* one ``all_to_all_single`` with equal splits (``collectives``: CUDA
  tensors through pinned host memory) delivers, to each owner, the
  ``(M, E/M, C, D)`` buffer of its groups' tokens from every peer, viewed as
  ``(E/M, M*C, D)`` per-group runs;
* the inverse exchange returns results in exactly the send layout, so the
  scatter indices gather them back to token order.

Over-capacity tokens never occupy a slot: their index is the sentinel
``E*C``, one spare row past the buffer that takes every dropped token and
is cut off, so no dropped token overwrites a kept one.  Exactness is the
caller's job (the overflow repair in ``core/routing``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import utils
from repro_torch.distributed import collectives


class EPPlan(NamedTuple):
    """Per-source-rank dispatch plan for one all_to_all exchange.

    flat_idx:   (Bl,) int64 position ``group*C + slot`` in the flattened
                ``(E*C,)`` send buffer; dropped or invalid tokens carry the
                sentinel ``E*C`` (the spare row)
    kept:       (Bl,) bool: the token is valid and under capacity
    capacity:   C, per (source rank, group)
    num_groups: E, the global group count
    num_shards: M, the size of the exchange group (E % M == 0)
    """
    flat_idx: torch.Tensor
    kept: torch.Tensor
    capacity: int
    num_groups: int
    num_shards: int

    @property
    def groups_local(self) -> int:
        return self.num_groups // self.num_shards


def ep_capacity(tokens_per_shard: int, num_groups: int,
                capacity_factor: float, multiple: int = 8) -> int:
    """Per-(source rank, group) slot count: ``cf * Bl / E`` rounded up to a
    multiple of 8.  Both ends of the exchange must agree on it."""
    return max(multiple, utils.round_up(
        int(capacity_factor * utils.cdiv(tokens_per_shard, num_groups)),
        multiple))


def make_ep_plan(group_idx: torch.Tensor, slot: torch.Tensor,
                 valid: torch.Tensor, num_groups: int, num_shards: int,
                 capacity: int) -> EPPlan:
    """The plan from per-token group ids, slot ranks and a validity mask
    (False = padding token: capacity-neutral, never occupies a slot)."""
    if num_groups % num_shards:
        raise ValueError(f"num_groups={num_groups} must divide over "
                         f"num_shards={num_shards}")
    kept = valid & (slot < capacity)
    flat_idx = torch.where(kept, group_idx.long() * capacity + slot.long(),
                           num_groups * capacity)
    return EPPlan(flat_idx, kept, capacity, num_groups, num_shards)


def ep_scatter(x: torch.Tensor, plan: EPPlan) -> torch.Tensor:
    """x (Bl, D) -> send buffer (M, E/M, C, D), grouped by owner rank."""
    E, C, D = plan.num_groups, plan.capacity, x.shape[-1]
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[plan.flat_idx] = x
    return buf[:-1].view(plan.num_shards, plan.groups_local, C, D)


def ep_exchange(send: torch.Tensor, group, plan: EPPlan) -> torch.Tensor:
    """all_to_all the send buffer to the group owners: (M, E/M, C, D) ->
    (E/M, M*C, D) per-local-group token runs (sources concatenated)."""
    recv = collectives.all_to_all_single(send.contiguous(), group)
    return recv.transpose(0, 1).reshape(
        plan.groups_local, plan.num_shards * plan.capacity, send.shape[-1])


def ep_combine(y: torch.Tensor, group, plan: EPPlan) -> torch.Tensor:
    """Inverse exchange: per-local-group results (E/M, M*C, O) back to the
    source ranks, flattened to the (E*C, O) send-buffer layout."""
    M, C, O = plan.num_shards, plan.capacity, y.shape[-1]
    back = y.reshape(plan.groups_local, M, C, O).transpose(0, 1).contiguous()
    return collectives.all_to_all_single(back, group).reshape(
        plan.num_groups * C, O)


def ep_gather(y_flat: torch.Tensor, plan: EPPlan) -> torch.Tensor:
    """(E*C, O) -> per-token outputs (Bl, O); dropped tokens get zeros."""
    y = y_flat[torch.where(plan.kept, plan.flat_idx, 0)]
    return torch.where(plan.kept[:, None], y, torch.zeros_like(y))


def ep_bytes_moved(num_groups: int, num_shards: int, dim_in: int,
                   dim_out: int, capacity: int, itemsize: int = 4, *,
                   overflow_policy: str = "drop",
                   tokens_per_shard: int = 0) -> int:
    """Cross-rank bytes per source rank for one dispatch round trip: two
    all_to_alls of the (E, C, *) buffers, of which (M-1)/M leaves the rank.

    ``overflow_policy="exact_dense"`` (with ``tokens_per_shard`` > 0) adds
    the worst-case repair round an overflowing dispatch pays: an all_gather
    of each rank's Bl token activations, leaf ids and drop mask over the
    group, plus the all_reduce assembling the (M*Bl, O) repaired outputs.
    Under "master_leaf" and "drop" the repair round never runs
    (``core/routing.grouped_leaf_apply_ep``), so its term is zero."""
    M = max(num_shards, 1)
    slots = num_groups * capacity
    a2a = int(slots * (dim_in + dim_out) * itemsize * (num_shards - 1) / M)
    if overflow_policy != "exact_dense" or not tokens_per_shard:
        return a2a
    Bl = tokens_per_shard
    gathered = Bl * (dim_in * itemsize + 4 + 1) * (num_shards - 1)
    psum = int(2 * M * Bl * dim_out * itemsize * (num_shards - 1) / M)
    return a2a + gathered + psum
