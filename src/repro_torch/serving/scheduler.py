"""Admission schedulers for the continuous-batching engine (port of
``repro/serving/scheduler.py``: ``fcfs`` and ``leaf_aware``; the
multi-tenant ``weighted_leaf_aware`` and the ``max_prefilling`` cap arrive
with the tenant slice).

``select(waiting, n_free, view)`` picks which waiting requests to admit into
free cache slots this step.  The engine passes a ``SchedulerView`` of its
live FFF telemetry; schedulers are host-side policy (numpy only).

* ``fcfs`` — strict arrival order.
* ``leaf_aware`` — FFF-composition-aware: a capacity-bounded dispatch drops
  (or densely repairs) tokens past a leaf's capacity, and which tokens
  share a batch decides that overflow.  The scheduler greedily admits, from
  a bounded look-ahead window, the candidate whose predicted leaf footprint
  (its ``leaf_hint``, else uniform; live occupancy once measured) minimizes
  the composed batch's predicted overflow, then its largest leaf load.  A
  hold counter bounds how often the queue head can be bypassed, so no
  request starves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import utils
from repro_torch.distributed import dispatch as dispatch_lib
from repro_torch.serving.request import Request


@dataclasses.dataclass
class SchedulerView:
    """What the engine exposes to admission policy each step.

    occupancy: (num_slots, E) float64: per-slot EWMA leaf-footprint
               fractions (rows of active slots sum to ~1; free rows are 0)
    active:    (num_slots,) bool
    num_leaves: E of the telemetry (0 = no FFF telemetry; leaf_aware then
               degrades to FCFS)
    capacity_factor: the capacity factor of the decode-side dispatch, or
               None for an exact backend with no capacity bound
               (reference, cuda, cuda_decode)
    num_slots: total cache slots (the decode batch is always this size)
    dispatch_shards: how many ways the dispatch splits the token axis: the
               data-shard count G for grouped dispatch, G * M for
               grouped_ep (capacity is per source shard there); 1 on one
               process
    tokens_per_slot: tokens each active slot adds to one decode-side
               dispatch: 1 for plain decode, ``spec_k + 1`` for a
               speculative verify slab
    """
    occupancy: np.ndarray
    active: np.ndarray
    num_leaves: int
    capacity_factor: Optional[float]
    num_slots: int
    dispatch_shards: int = 1
    tokens_per_slot: int = 1

    def leaf_capacity(self) -> float:
        """Whole-batch per-leaf capacity of one decode-side dispatch in
        units of slot footprints: the dispatch's per-(shard, leaf) law
        (``dispatch.ep_capacity``) on the per-shard share of its ``num_slots
        * tokens_per_slot`` tokens, times the shard count, divided back by
        ``tokens_per_slot``.  Infinite without a capacity bound: the
        leaf_aware objective then reduces to its max-load term."""
        if self.num_leaves <= 0 or self.capacity_factor is None:
            return float("inf")
        shards = max(self.dispatch_shards, 1)
        tps = max(self.tokens_per_slot, 1)
        per_shard = utils.cdiv(self.num_slots * tps, shards)
        return float(dispatch_lib.ep_capacity(
            per_shard, self.num_leaves, self.capacity_factor) * shards) / tps


class Scheduler:
    """Admission-policy base class: subclasses implement ``select`` and
    register in ``SCHEDULERS`` to be reachable from
    ``EngineConfig.scheduler`` and ``serve.py --scheduler``."""
    name = "base"

    def select(self, waiting: Sequence[Request], n_free: int,
               view: SchedulerView) -> List[Request]:
        """Pick <= n_free requests from ``waiting`` (arrival order) to admit
        this step; the returned order is the admission order.  Must not
        mutate ``waiting`` or the requests."""
        raise NotImplementedError


class FCFSScheduler(Scheduler):
    """First-come-first-served: admit in arrival order."""
    name = "fcfs"

    def select(self, waiting, n_free, view):
        return list(waiting[:n_free])


class LeafAwareScheduler(Scheduler):
    """Greedy leaf-load-balancing admission (module docstring).

    window:   how deep into the queue the policy may look (bounds both
              unfairness and per-step host cost)
    max_hold: after this many bypasses the queue head is force-admitted
              (the head waits at most ``max_hold`` admission rounds beyond
              FCFS)
    """
    name = "leaf_aware"

    def __init__(self, window: int = 16, max_hold: int = 8):
        self.window = window
        self.max_hold = max_hold
        self._holds: Dict[int, int] = {}

    @staticmethod
    def _footprint(req: Request, E: int) -> np.ndarray:
        h = req.leaf_hint
        if h is None or h.size != E or h.sum() <= 0:
            return np.full((E,), 1.0 / E)
        return h / h.sum()

    def _pick(self, pool: List[Request], load: np.ndarray, E: int,
              cap: float) -> int:
        """Index into ``pool`` minimizing (predicted overflow, largest leaf
        load, arrival order); the queue head once its hold count reaches
        ``max_hold``."""
        if len(pool) == 1 or self._holds.get(pool[0].rid, 0) >= self.max_hold:
            return 0
        costs = []
        for i, r in enumerate(pool):
            nl = load + self._footprint(r, E)
            costs.append((float(np.maximum(nl - cap, 0.0).sum()),
                          float(nl.max()), i))
        return min(costs)[2]

    def select(self, waiting, n_free, view):
        if view.num_leaves <= 0 or not waiting:
            return list(waiting[:n_free])
        E = view.num_leaves
        cap = view.leaf_capacity()
        # the composed decode batch's per-leaf load (each active slot ~ its
        # footprint row)
        load = (view.occupancy[view.active].sum(axis=0) if view.active.any()
                else np.zeros((E,)))
        pool = list(waiting[: max(self.window, n_free)])
        chosen: List[Request] = []
        for _ in range(min(n_free, len(waiting))):
            if not pool:
                break
            req = pool.pop(self._pick(pool, load, E, cap))
            load = load + self._footprint(req, E)
            chosen.append(req)
        chosen_ids = {r.rid for r in chosen}
        # one more hold for each waiter bypassed ahead of a chosen one
        for r in waiting:
            if r.rid in chosen_ids:
                break
            self._holds[r.rid] = self._holds.get(r.rid, 0) + (1 if chosen
                                                              else 0)
        for r in chosen:
            self._holds.pop(r.rid, None)
        return chosen


SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "leaf_aware": LeafAwareScheduler,
}


def make_scheduler(name: str, **kw) -> Scheduler:
    """Instantiate a registered scheduler by name; ``kw`` goes to its
    constructor (``leaf_aware`` takes ``window`` and ``max_hold``)."""
    try:
        cls = SCHEDULERS[name]
    except KeyError:
        raise KeyError(f"unknown scheduler {name!r}; have "
                       f"{sorted(SCHEDULERS)}") from None
    return cls(**kw)
