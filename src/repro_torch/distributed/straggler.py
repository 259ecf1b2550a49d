"""Straggler detection & mitigation policy (host-side control plane).  The
port's own copy of ``repro/distributed/straggler.py`` (pure numpy).

At 1000+ nodes, slow hosts dominate step time (synchronous SPMD waits for the
slowest).  This module implements the control logic:

  * ``StepTimeTracker`` — per-host rolling step-time stats with outlier
    flagging (p50 * factor rule, robust to global slowdowns).
  * ``MitigationPolicy`` — escalation ladder: observe -> warn -> eject.
    Ejection raises ``fault.ElasticRemesh`` for the launcher to rebuild its
    process group onto the surviving hosts.

The decision logic is deterministic and unit-tested; the actuation (restart
with a smaller host set) is the supervisor's job (fault.py).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50              # steps of history per host
    slow_factor: float = 1.5      # flagged if host_p50 > global_p50 * factor
    eject_after: int = 20         # consecutive flagged steps before ejection
    min_history: int = 10


class StepTimeTracker:
    def __init__(self, num_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.history = [collections.deque(maxlen=cfg.window)
                        for _ in range(num_hosts)]
        self.flagged_streak = np.zeros(num_hosts, dtype=int)

    def record(self, host_times: list[float]) -> None:
        for h, t in enumerate(host_times):
            self.history[h].append(t)

    def host_p50(self, h: int) -> Optional[float]:
        if len(self.history[h]) < self.cfg.min_history:
            return None
        return float(np.median(self.history[h]))

    def global_p50(self) -> Optional[float]:
        vals = [t for h in self.history for t in h]
        if len(vals) < self.cfg.min_history:
            return None
        return float(np.median(vals))

    def update_flags(self) -> list[int]:
        """Returns currently-flagged host ids and advances eject streaks."""
        g = self.global_p50()
        flagged = []
        if g is None:
            return flagged
        for h in range(len(self.history)):
            p = self.host_p50(h)
            if p is not None and p > g * self.cfg.slow_factor:
                flagged.append(h)
                self.flagged_streak[h] += 1
            else:
                self.flagged_streak[h] = 0
        return flagged

    def to_eject(self) -> list[int]:
        return [h for h in range(len(self.history))
                if self.flagged_streak[h] >= self.cfg.eject_after]


@dataclasses.dataclass
class MitigationDecision:
    action: str                   # "none" | "warn" | "eject"
    hosts: list[int]


class MitigationPolicy:
    """observe -> warn -> eject escalation with hysteresis."""

    def __init__(self, tracker: StepTimeTracker):
        self.tracker = tracker

    def step(self, host_times: list[float]) -> MitigationDecision:
        self.tracker.record(host_times)
        flagged = self.tracker.update_flags()
        eject = self.tracker.to_eject()
        if eject:
            return MitigationDecision("eject", eject)
        if flagged:
            return MitigationDecision("warn", flagged)
        return MitigationDecision("none", [])
