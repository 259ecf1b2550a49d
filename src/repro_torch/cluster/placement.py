"""Decode/prefill placement over live worker telemetry (the port's own copy
of ``repro/cluster/placement.py``: host numpy, no device work).

The router keeps one ``WorkerView`` per worker, refreshed from heartbeats,
and asks this module two questions:

* ``choose_decode(views, footprint)`` — which decode worker takes this
  completed prefill?  Scores free pages (the binding resource: an install
  needs the full generation horizon funded up front), slot slack, queue
  depth, and FFF *leaf-profile overlap*: a request whose tenant profile
  lights up the same leaves a worker's current occupants already use would
  deepen that worker's dispatch skew, so overlap subtracts.  This is the
  load-balanced-FFF idea (PAPERS.md, arxiv 2405.16836) applied at the
  cluster layer — balance the leaf load by *routing*, not by a loss term.
* ``choose_prefill(views, hint_wid)`` — which prefill worker admits this
  prompt?  Prefix affinity wins (the global radix map points at the worker
  whose local ``PrefixIndex`` already holds the longest matching chunk
  run, so its engine admits with shared pages), else least-loaded.

Scores are pure functions of the views; ties break on wid so LocalBus
runs are deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class WorkerView:
    """Router-side mirror of one worker, built from heartbeats."""
    wid: str
    role: str                       # "prefill" | "decode"
    pages_free: int = 0
    pages_total: int = 0
    queue_depth: int = 0
    active_slots: int = 0
    num_slots: int = 0
    occupancy: Optional[np.ndarray] = None   # EWMA leaf footprint
    profiles: Optional[dict] = None
    draining: bool = False
    last_seen: float = 0.0
    n_ticks: int = 0
    outstanding: int = 0            # router-side credits in flight
    handoff_bytes: int = 0
    restarts: int = 0               # respawn generation this wid replaced

    @property
    def free_slots(self) -> int:
        return max(0, self.num_slots - self.active_slots - self.outstanding)

    def update_occupancy(self, occ: Optional[np.ndarray],
                         alpha: float = 0.25) -> None:
        """EWMA the heartbeat's live footprint so placement sees a smoothed
        leaf profile rather than the last step's active set."""
        if occ is None:
            return
        occ = np.asarray(occ, np.float32)
        if self.occupancy is None or self.occupancy.shape != occ.shape:
            self.occupancy = occ.copy()
        else:
            self.occupancy = (1.0 - alpha) * self.occupancy + alpha * occ


def overlap(footprint: Optional[np.ndarray],
            occupancy: Optional[np.ndarray]) -> float:
    """Normalized dot of a request's leaf footprint against a worker's
    occupancy EWMA — 0 when either side is flat/absent."""
    if footprint is None or occupancy is None:
        return 0.0
    f = np.asarray(footprint, np.float64).ravel()
    o = np.asarray(occupancy, np.float64).ravel()
    if f.size != o.size or f.size == 0:
        return 0.0
    fn, on = np.linalg.norm(f), np.linalg.norm(o)
    if fn == 0.0 or on == 0.0:
        return 0.0
    return float(f @ o / (fn * on))


def score_decode(v: WorkerView, footprint: Optional[np.ndarray] = None,
                 *, w_pages: float = 1.0, w_slots: float = 1.0,
                 w_queue: float = 0.5, w_overlap: float = 0.5) -> float:
    """Higher is better; page headroom dominates (an install that can't
    fund its horizon bounces back to the router as backpressure)."""
    pages_frac = v.pages_free / v.pages_total if v.pages_total else 0.0
    slot_frac = v.free_slots / v.num_slots if v.num_slots else 0.0
    queue_frac = v.queue_depth / max(1, v.num_slots)
    return (w_pages * pages_frac + w_slots * slot_frac
            - w_queue * queue_frac - w_overlap * overlap(footprint,
                                                         v.occupancy))


def choose_decode(views: Dict[str, WorkerView],
                  footprint: Optional[np.ndarray] = None) -> Optional[str]:
    """Best decode worker for this handoff, or None when none can take it
    (all draining, or no free slot — the handoff stays queued)."""
    best_wid, best = None, -np.inf
    for wid in sorted(views):
        v = views[wid]
        if v.role != "decode" or v.draining or v.free_slots <= 0:
            continue
        s = score_decode(v, footprint)
        if s > best:
            best_wid, best = wid, s
    return best_wid


def choose_prefill(views: Dict[str, WorkerView],
                   hint_wid: Optional[str] = None) -> Optional[str]:
    """Prefill worker for a new prompt: the prefix-affinity hint when it
    names a live non-draining worker with credit, else least-loaded."""
    if hint_wid is not None:
        v = views.get(hint_wid)
        if v is not None and v.role == "prefill" and not v.draining \
                and v.free_slots > 0:
            return hint_wid
    best_wid, best = None, -np.inf
    for wid in sorted(views):
        v = views[wid]
        if v.role != "prefill" or v.draining or v.free_slots <= 0:
            continue
        s = v.free_slots - 0.5 * v.queue_depth
        if s > best:
            best_wid, best = wid, s
    return best_wid
