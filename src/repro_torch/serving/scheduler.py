"""Admission schedulers for the continuous-batching engine (port of
``repro/serving/scheduler.py``).

``select(waiting, n_free, view)`` picks which waiting requests to admit into
free cache slots this step.  The engine passes a ``SchedulerView`` of its
live FFF telemetry; schedulers are host-side policy (numpy only).

* ``fcfs`` — strict arrival order.
* ``leaf_aware`` — FFF-composition-aware: a capacity-bounded dispatch drops
  (or densely repairs) tokens past a leaf's capacity, and which tokens
  share a batch decides that overflow.  The scheduler greedily admits, from
  a bounded look-ahead window, the candidate whose predicted leaf footprint
  (its ``leaf_hint``, the tenant's learned routing profile, else uniform;
  live occupancy once measured) minimizes the composed batch's predicted
  overflow, then its largest leaf load.  A hold counter bounds how often
  the queue head can be bypassed, so no request starves.
* ``weighted_leaf_aware`` — multi-tenant QoS on the same objective: stride
  scheduling (each admission advances its tenant's virtual pass by
  1 / weight; the tenant with the smallest pass admits next) apportions
  admissions across tenants in proportion to their weights, and within
  the winning tenant the leaf-aware pick composes the batch.  No tenant of
  positive weight starves.

Every scheduler takes ``max_prefilling``: the cap on slots in the
prefilling state under chunked prefill (``admission_cap``).
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
    prefilling: (num_slots,) bool: slots admitted but still mid-chunked-
               prefill (all False under monolithic prefill); the
               ``max_prefilling`` cap counts these
    profiles:  the engine's ``RoutingProfileStore`` (or None): leaf-aware
               schedulers fall back to ``profiles.lookup(req.tenant)`` for
               candidates without a usable ``leaf_hint``
    tokens_per_slot: tokens each active slot adds to one decode-side
               dispatch: 1 for plain decode, ``spec_k + 1`` for a
               speculative verify slab
    pages_free: free pages in the engine's KV page pool (None when not
               tracked): a free slot no longer guarantees admission, since
               the allocator can refuse a long prompt with slots open
    """
    occupancy: np.ndarray
    active: np.ndarray
    num_leaves: int
    capacity_factor: Optional[float]
    num_slots: int
    dispatch_shards: int = 1
    prefilling: Optional[np.ndarray] = None
    profiles: Optional[object] = None    # serving.profiles.RoutingProfileStore
    tokens_per_slot: int = 1
    pages_free: Optional[int] = None

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
    ``EngineConfig.scheduler`` and ``serve.py --scheduler``.

    ``max_prefilling`` caps how many slots may sit in the prefilling state
    at once under chunked prefill: more concurrent prefills fill the shared
    chunk slab (TTFT), but keep each step's chunk work at its budget for
    longer (decode latency).  0 = uncapped.  Monolithic admission never
    leaves a slot prefilling, so the cap does not apply there."""
    name = "base"

    def __init__(self, max_prefilling: int = 0):
        self.max_prefilling = max_prefilling

    def admission_cap(self, view: SchedulerView) -> int:
        """How many new requests may be admitted this step, given the slots
        already mid-prefill; the engine intersects it with its free slots
        and ``max_prefills_per_step``."""
        if self.max_prefilling <= 0:
            return view.num_slots
        busy = (int(view.prefilling.sum()) if view.prefilling is not None
                else 0)
        return max(self.max_prefilling - busy, 0)

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

    def __init__(self, window: int = 16, max_hold: int = 8,
                 max_prefilling: int = 0):
        super().__init__(max_prefilling=max_prefilling)
        self.window = window
        self.max_hold = max_hold
        self._holds: Dict[int, int] = {}

    @staticmethod
    def _footprint(req: Request, E: int,
                   view: Optional[SchedulerView] = None) -> np.ndarray:
        """The candidate's predicted (E,) footprint: its usable hint, else
        its tenant's learned profile, else uniform."""
        h = req.leaf_hint
        if (h is None or h.size != E or h.sum() <= 0) and view is not None \
                and view.profiles is not None:
            h = view.profiles.lookup(req.tenant)
        if h is None or h.size != E or h.sum() <= 0:
            return np.full((E,), 1.0 / E)
        return h / h.sum()

    def _pick(self, pool: List[Request], load: np.ndarray, E: int,
              cap: float, view: SchedulerView) -> int:
        """Index into ``pool`` minimizing (predicted overflow, largest leaf
        load, arrival order); the queue head once its hold count reaches
        ``max_hold``.  Shared by ``leaf_aware`` and the within-tenant pick
        of ``weighted_leaf_aware``."""
        if E <= 0 or len(pool) == 1:
            return 0
        if self._holds.get(pool[0].rid, 0) >= self.max_hold:
            return 0
        costs = []
        for i, r in enumerate(pool):
            nl = load + self._footprint(r, E, view)
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
            req = pool.pop(self._pick(pool, load, E, cap, view))
            load = load + self._footprint(req, E, view)
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


class WeightedLeafAwareScheduler(LeafAwareScheduler):
    """Multi-tenant weighted-fair admission with leaf-aware composition
    (module docstring).

    Tenant selection is stride scheduling: each tenant carries a virtual
    ``pass``; every admission it wins advances its pass by ``1 / weight``,
    and the waiting tenant with the smallest pass (ties by name) wins the
    next free slot.  Over a saturated interval each tenant's admission
    share converges to ``weight_t / sum(weights of backlogged tenants)``.
    A tenant that rejoins after idling resumes at the current virtual
    time, not its stale pass, so it cannot catch up in a burst.

    Within the winning tenant, the pick over its first ``window`` waiters
    is the parent class's leaf-aware objective against the composed batch,
    with the same ``max_hold`` guard on the tenant's queue head.

    weights:        tenant -> positive, finite weight.  Unlisted tenants
                    get ``default_weight``.
    default_weight: weight for unlisted tenants (> 0).
    """
    name = "weighted_leaf_aware"

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0, window: int = 16,
                 max_hold: int = 8, max_prefilling: int = 0):
        super().__init__(window=window, max_hold=max_hold,
                         max_prefilling=max_prefilling)
        weights = dict(weights or {})
        for t, w in weights.items():
            # an infinite weight makes the stride 0: that tenant would win
            # every admission and starve its peers
            if not (w > 0 and np.isfinite(w)):
                raise ValueError(f"tenant {t!r}: weight must be positive "
                                 f"and finite, got {w}")
        if not (default_weight > 0 and np.isfinite(default_weight)):
            raise ValueError(f"default_weight must be positive and finite, "
                             f"got {default_weight}")
        self.weights = weights
        self.default_weight = default_weight
        self._pass: Dict[str, float] = {}
        self._vtime = 0.0                   # pass of the last admission

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    def select(self, waiting, n_free, view):
        if not waiting:
            return []
        E = view.num_leaves
        cap = view.leaf_capacity()
        load = (view.occupancy[view.active].sum(axis=0)
                if E > 0 and view.active.any() else np.zeros((max(E, 1),)))
        groups: Dict[str, List[Request]] = {}
        for r in waiting:                    # insertion order = first arrival
            groups.setdefault(r.tenant, []).append(r)
        for t in groups:                     # rejoin at the current virtual time
            self._pass[t] = max(self._pass.get(t, self._vtime), self._vtime)
        chosen: List[Request] = []
        for _ in range(min(n_free, len(waiting))):
            live = [t for t, g in groups.items() if g]
            if not live:
                break
            t = min(live, key=lambda name: (self._pass[name], name))
            pool = groups[t][: max(self.window, 1)]
            pick = self._pick(pool, load, E, cap, view)
            req = pool[pick]
            groups[t].remove(req)
            if pick > 0:                     # bypassed this tenant's head
                head = pool[0]
                self._holds[head.rid] = self._holds.get(head.rid, 0) + 1
            self._holds.pop(req.rid, None)
            if E > 0:
                load = load + self._footprint(req, E, view)
            chosen.append(req)
            self._vtime = self._pass[t]
            self._pass[t] += 1.0 / self.weight(t)
        # drop the pass of an absent tenant only once the virtual time has
        # caught up with it: one still ahead carries stride debt it just
        # consumed, and forgetting that would let a tenant whose queue
        # drains every time it wins rejoin debt-free and take every other
        # slot whatever its weight
        for t in [t for t in self._pass
                  if t not in groups and self._pass[t] <= self._vtime]:
            del self._pass[t]
        return chosen


SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "leaf_aware": LeafAwareScheduler,
    "weighted_leaf_aware": WeightedLeafAwareScheduler,
}


def make_scheduler(name: str, **kw) -> Scheduler:
    """Instantiate a registered scheduler by name; ``kw`` goes to its
    constructor (``EngineConfig.scheduler_kw``): every scheduler takes
    ``max_prefilling``; ``leaf_aware`` also ``window`` and ``max_hold``;
    ``weighted_leaf_aware`` also ``weights`` (tenant -> weight) and
    ``default_weight``."""
    try:
        cls = SCHEDULERS[name]
    except KeyError:
        raise KeyError(f"unknown scheduler {name!r}; have "
                       f"{sorted(SCHEDULERS)}") from None
    return cls(**kw)
