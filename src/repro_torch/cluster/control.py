"""Cluster monitor: liveness, restart budget, elastic autoscaling (port of
``repro/cluster/control.py``; host only).

``ClusterMonitor`` is a pure decision loop: the router feeds it heartbeats
and the current worker views, and ``tick()`` returns *actions* for the
router to execute — the monitor never touches the bus, so every policy
(timeout, backoff, watermark) unit-tests against a ``VirtualClock`` with
zero sleeps.

Three sub-policies:

* **Liveness** — a worker whose last heartbeat is older than
  ``heartbeat_timeout`` is declared dead (``MarkDead``).  Respawns go
  through a per-role ``RestartBackoff`` (distributed/fault.py): each death
  spends one restart from the budget and schedules a ``Respawn`` after the
  exponential delay; an exhausted budget stops respawning that role and
  the router surfaces the stall in metrics instead of flapping.
* **Straggler escalation** — heartbeat *intervals* feed the training
  stack's ``MitigationPolicy`` (distributed/straggler.py): a worker that
  heartbeats persistently slower than the fleet p50 is demoted to
  draining (``DrainWorker``) before it becomes a timeout — the serving
  analogue of ejecting a slow host from the training mesh.
* **Elastic watermarks** — queue depth and decode-fleet pages_free are
  EWMA-smoothed; sustained pressure (queue above ``scale_up_watermark``,
  or free-page fraction under ``pages_free_low_frac``) emits
  ``SpawnDecode``, and a slack fleet (queue under ``scale_down_watermark``
  with all decode workers near-idle) drains the highest-wid decode worker.
  A cooldown and ``min_decode``/``max_decode`` bounds stop oscillation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.cluster.placement import WorkerView
from repro_torch.distributed.fault import RestartBackoff
from repro_torch.distributed.straggler import (MitigationPolicy,
                                               StepTimeTracker,
                                               StragglerConfig)


# -- actions the router executes ------------------------------------------

@dataclasses.dataclass
class MarkDead:
    """Heartbeat timeout: drop the worker, replay its in-flight work."""
    wid: str


@dataclasses.dataclass
class Respawn:
    """Start a replacement worker for ``role`` (backoff delay elapsed)."""
    role: str


@dataclasses.dataclass
class SpawnDecode:
    """Elastic scale-up: add a decode worker."""


@dataclasses.dataclass
class DrainWorker:
    """Elastic scale-down / straggler demotion: drain ``wid`` gracefully."""
    wid: str
    reason: str = "scale_down"


@dataclasses.dataclass
class ControlConfig:
    heartbeat_timeout: float = 1.0
    max_restarts: int = 3
    backoff_base: float = 0.0       # 0: respawn on the next tick (tests)
    backoff_factor: float = 2.0
    straggler: Optional[StragglerConfig] = None   # None disables escalation
    # elastic watermarks (smoothed): queue depth in requests, pages as a
    # fraction of the decode fleet's total
    scale_up_watermark: float = 4.0
    scale_down_watermark: float = 0.5
    pages_free_low_frac: float = 0.1
    watermark_ewma: float = 0.3
    scale_cooldown: float = 2.0
    min_decode: int = 1
    max_decode: int = 8


class ClusterMonitor:
    def __init__(self, cfg: ControlConfig, clock: Callable[[], float]):
        self.cfg = cfg
        self.clock = clock
        self._backoff: Dict[str, RestartBackoff] = {}   # per role
        self._pending_respawn: List[tuple] = []          # (due_t, role)
        self._last_beat: Dict[str, float] = {}
        self._beat_hist: Dict[str, List[float]] = {}     # recent intervals
        self._queue_ewma: Optional[float] = None
        self._pages_ewma: Optional[float] = None
        self._last_scale_t: Optional[float] = None
        self._dead: set = set()
        self._straggler_wids: tuple = ()
        self._straggler_policy: Optional[MitigationPolicy] = None
        self.scale_events: List[dict] = []

    def _role_backoff(self, role: str) -> RestartBackoff:
        if role not in self._backoff:
            self._backoff[role] = RestartBackoff(
                self.cfg.max_restarts, self.cfg.backoff_base,
                self.cfg.backoff_factor)
        return self._backoff[role]

    def observe_heartbeat(self, wid: str, t: float) -> None:
        prev = self._last_beat.get(wid)
        if prev is not None and t > prev:
            hist = self._beat_hist.setdefault(wid, [])
            hist.append(t - prev)
            if len(hist) > 64:
                del hist[:-64]
        self._last_beat[wid] = t

    def forget(self, wid: str) -> None:
        """Worker left (death or drain-complete): drop its liveness state."""
        self._last_beat.pop(wid, None)
        self._beat_hist.pop(wid, None)
        self._dead.discard(wid)

    # -- policy ticks ------------------------------------------------------

    def _liveness(self, views: Dict[str, WorkerView], now: float) -> list:
        actions = []
        for wid in sorted(views):
            if wid in self._dead:
                continue
            seen = self._last_beat.get(wid, views[wid].last_seen)
            if now - seen > self.cfg.heartbeat_timeout:
                self._dead.add(wid)
                actions.append(MarkDead(wid))
                delay = self._role_backoff(views[wid].role).next_delay()
                if delay is not None:
                    self._pending_respawn.append((now + delay,
                                                  views[wid].role))
        due = [r for t, r in self._pending_respawn if t <= now]
        self._pending_respawn = [(t, r) for t, r in self._pending_respawn
                                 if t > now]
        actions.extend(Respawn(r) for r in due)
        return actions

    def _stragglers(self, views: Dict[str, WorkerView]) -> list:
        cfg = self.cfg.straggler
        if cfg is None:
            return []
        wids = tuple(w for w in sorted(views)
                     if w not in self._dead and not views[w].draining)
        if len(wids) < 2:
            return []
        if wids != self._straggler_wids:
            # membership changed: fresh tracker (streaks restart — a new
            # fleet shape resets what "slow relative to the fleet" means)
            self._straggler_wids = wids
            self._straggler_policy = MitigationPolicy(
                StepTimeTracker(len(wids), cfg))
        sample = []
        for w in wids:
            hist = self._beat_hist.get(w)
            if not hist:
                return []          # wait until every member has an interval
            sample.append(hist[-1])
        decision = self._straggler_policy.step(sample)
        if decision.action != "eject":
            return []
        return [DrainWorker(wids[h], reason="straggler")
                for h in decision.hosts if views[wids[h]].role == "decode"]

    def _elastic(self, views: Dict[str, WorkerView], queue_depth: int,
                 now: float) -> list:
        a = self.cfg.watermark_ewma
        decode = [v for v in views.values()
                  if v.role == "decode" and v.wid not in self._dead
                  and not v.draining]
        if not decode:
            return []
        total = sum(v.pages_total for v in decode)
        free_frac = (sum(v.pages_free for v in decode) / total) if total \
            else 1.0
        q = float(queue_depth + sum(v.queue_depth for v in decode))
        self._queue_ewma = q if self._queue_ewma is None else \
            (1 - a) * self._queue_ewma + a * q
        self._pages_ewma = free_frac if self._pages_ewma is None else \
            (1 - a) * self._pages_ewma + a * free_frac
        if self._last_scale_t is not None and \
                now - self._last_scale_t < self.cfg.scale_cooldown:
            return []
        if (self._queue_ewma > self.cfg.scale_up_watermark
                or self._pages_ewma < self.cfg.pages_free_low_frac) \
                and len(decode) < self.cfg.max_decode:
            self._last_scale_t = now
            self.scale_events.append(
                {"t": now, "action": "scale_up",
                 "queue_ewma": self._queue_ewma,
                 "pages_free_ewma": self._pages_ewma})
            return [SpawnDecode()]
        idle = all(v.active_slots == 0 and v.queue_depth == 0
                   for v in decode)
        if self._queue_ewma < self.cfg.scale_down_watermark and idle \
                and len(decode) > self.cfg.min_decode:
            victim = max(v.wid for v in decode)
            self._last_scale_t = now
            self.scale_events.append(
                {"t": now, "action": "scale_down", "wid": victim,
                 "queue_ewma": self._queue_ewma,
                 "pages_free_ewma": self._pages_ewma})
            return [DrainWorker(victim, reason="scale_down")]
        return []

    def tick(self, views: Dict[str, WorkerView], queue_depth: int) -> list:
        """One monitor pass → ordered action list for the router."""
        now = self.clock()
        actions = self._liveness(views, now)
        actions.extend(self._stragglers(views))
        actions.extend(self._elastic(views, queue_depth, now))
        return actions
