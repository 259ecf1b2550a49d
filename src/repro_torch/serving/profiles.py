"""Online per-tenant routing profiles (port of
``repro/serving/profiles.py``; host numpy only).

An FFF tree routes noiselessly: a prompt's leaf footprint is a stable
property of its content, so a tenant's traffic has a measurable, slowly
drifting routing signature.  ``RoutingProfileStore`` learns it online:
every finished request's EWMA leaf occupancy (the engine's per-slot
telemetry) folds into its tenant's profile, which then serves as the
admission prior for the tenant's next requests.  ``Request.leaf_hint``
thereby becomes optional.

Profiles are advisory, like hints: a stale or wrong profile costs
scheduling quality, never correctness.  Deterministic for a given update
sequence (no wall clock, no RNG).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class TenantProfile:
    """One tenant's learned leaf footprint: a normalized (E,) EWMA over the
    occupancy rows of its finished requests, and the update count that
    gates serving it (``min_updates``)."""
    footprint: np.ndarray
    n_updates: int = 0


class RoutingProfileStore:
    """Per-tenant EWMA leaf-footprint store.

    Args:
        num_leaves:  E, the telemetry width; ``update`` ignores rows of
                     another size (another model or site).
        ewma:        weight of the newest finished request's footprint.
        min_updates: finished requests a tenant needs before ``lookup``
                     serves its profile; below it the schedulers fall back
                     to the request's own hint, then uniform.
        max_tenants: LRU cap on tracked tenants (each holds an (E,) row);
                     when a new tenant would exceed it, the least recently
                     updated or looked-up profile is dropped, and the first
                     eviction warns once.  0 = unbounded.
    """

    def __init__(self, num_leaves: int, ewma: float = 0.3,
                 min_updates: int = 1, max_tenants: int = 1024):
        if num_leaves <= 0:
            raise ValueError(f"num_leaves must be positive, got {num_leaves}")
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        if min_updates < 1:
            raise ValueError(f"min_updates must be >= 1, got {min_updates}")
        if max_tenants < 0:
            raise ValueError(f"max_tenants must be >= 0, got {max_tenants}")
        self.num_leaves = num_leaves
        self.ewma = ewma
        self.min_updates = min_updates
        self.max_tenants = max_tenants
        self.n_evicted = 0
        self._warned_eviction = False
        self._profiles: Dict[str, TenantProfile] = {}

    def _touch(self, tenant: str) -> None:
        # dict insertion order is the LRU order: re-inserting moves the
        # tenant to the most recent end
        prof = self._profiles.pop(tenant)
        self._profiles[tenant] = prof

    def _evict_to_cap(self) -> None:
        if self.max_tenants <= 0:
            return
        while len(self._profiles) > self.max_tenants:
            victim = next(iter(self._profiles))
            del self._profiles[victim]
            self.n_evicted += 1
            if not self._warned_eviction:
                self._warned_eviction = True
                warnings.warn(
                    f"RoutingProfileStore evicted tenant {victim!r}: more "
                    f"than max_tenants={self.max_tenants} distinct tenants "
                    f"seen; evicted tenants relearn from scratch (raise "
                    f"profile_max_tenants if the working set is legitimate)",
                    RuntimeWarning, stacklevel=3)

    def update(self, tenant: str, occupancy_row: np.ndarray) -> None:
        """Fold one finished request's (E,) leaf-occupancy row into the
        tenant's profile.  Zero-mass or wrong-width rows are ignored."""
        row = np.asarray(occupancy_row, np.float64).reshape(-1)
        if row.size != self.num_leaves:
            return
        tot = row.sum()
        if tot <= 0 or not np.isfinite(tot):
            return
        frac = row / tot
        prof = self._profiles.get(tenant)
        if prof is None:
            self._profiles[tenant] = TenantProfile(footprint=frac.copy(),
                                                   n_updates=1)
            self._evict_to_cap()
        else:
            a = self.ewma
            prof.footprint = (1.0 - a) * prof.footprint + a * frac
            prof.n_updates += 1
            self._touch(tenant)

    def lookup(self, tenant: str) -> Optional[np.ndarray]:
        """The tenant's learned (E,) footprint (a copy), or None until
        ``min_updates`` requests have reported."""
        prof = self._profiles.get(tenant)
        if prof is None or prof.n_updates < self.min_updates:
            return None
        self._touch(tenant)
        return prof.footprint.copy()

    def n_updates(self, tenant: str) -> int:
        prof = self._profiles.get(tenant)
        return 0 if prof is None else prof.n_updates

    def tenants(self):
        return sorted(self._profiles)

    def as_dict(self) -> dict:
        """JSON-ready snapshot: tenant -> {n_updates, dominant leaf,
        footprint list} (``serve.py --metrics-json``)."""
        return {t: {"n_updates": p.n_updates,
                    "dominant_leaf": int(p.footprint.argmax()),
                    "footprint": [round(float(x), 6) for x in p.footprint]}
                for t, p in sorted(self._profiles.items())}
