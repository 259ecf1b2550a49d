"""Fault tolerance: the training supervisor, a checkpoint/restart loop (port
of ``repro/distributed/fault.py``).

``TrainSupervisor`` wraps a step function with:
  * periodic checkpointing through CheckpointManager (async, atomic)
  * crash recovery: on any step exception, wait for the save in flight,
    restore the newest committed checkpoint onto the devices the state
    lives on and resume (bounded retries, exponential backoff budget);
    it never carries on on another device
  * straggler escalation hooks (distributed/straggler.py): on "eject", the
    supervisor commits a blocking checkpoint and raises ElasticRemesh so
    the launcher rebuilds its process group with the surviving hosts and
    re-enters from that checkpoint

Failure injection for tests: pass ``failure_hook(step) -> bool``.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager

log = logging.getLogger("repro_torch.fault")

PyTree = Any


class ElasticRemesh(Exception):
    """Raised to request a re-mesh onto ``surviving_hosts``."""

    def __init__(self, surviving_hosts: list[int]):
        super().__init__(f"elastic re-mesh onto {len(surviving_hosts)} hosts")
        self.surviving_hosts = surviving_hosts


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_every: int = 100
    max_restarts: int = 5
    keep: int = 3
    backoff_base: float = 0.0     # first retry delay (s); 0 disables sleeps
    backoff_factor: float = 2.0


class RestartBackoff:
    """Exponential-backoff restart budget of the training supervisor.

    ``next_delay()`` spends one restart from the budget and returns the
    delay before the retry (``base * factor**n``), or None once the budget
    is exhausted — the caller escalates (raise / mark the worker
    permanently dead).  ``reset()`` refunds the budget after sustained
    health."""

    def __init__(self, max_restarts: int = 5, base: float = 0.0,
                 factor: float = 2.0):
        self.max_restarts = max_restarts
        self.base = base
        self.factor = factor
        self.restarts = 0

    def next_delay(self) -> Optional[float]:
        if self.restarts >= self.max_restarts:
            return None
        delay = self.base * (self.factor ** self.restarts)
        self.restarts += 1
        return delay

    def reset(self) -> None:
        self.restarts = 0


@dataclasses.dataclass
class RunResult:
    state: PyTree
    step: int
    restarts: int
    ejections: int


class TrainSupervisor:
    def __init__(self, manager: CheckpointManager,
                 cfg: SupervisorConfig = SupervisorConfig(),
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.manager = manager
        self.cfg = cfg
        self.sleep_fn = sleep_fn

    def run(self, state: PyTree, step_fn: Callable[[PyTree, int], PyTree],
            num_steps: int, *,
            failure_hook: Optional[Callable[[int], bool]] = None,
            straggler_hook: Optional[Callable[[int], Optional[list[int]]]] = None
            ) -> RunResult:
        """Run ``num_steps`` of ``step_fn`` with checkpoint/restart semantics.

        step_fn(state, step) -> state.  Deterministic given (state, step), so
        replay after restore is consistent.
        """
        start = 0
        ejections = 0
        backoff = RestartBackoff(self.cfg.max_restarts,
                                 self.cfg.backoff_base,
                                 self.cfg.backoff_factor)
        if self.manager.latest_step() is not None:
            state, start, _ = self.manager.restore(state)
            log.info("resuming from step %d", start)

        step = start
        while step < num_steps:
            try:
                if failure_hook is not None and failure_hook(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state = step_fn(state, step)
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == num_steps:
                    self.manager.save(step, state)
                if straggler_hook is not None:
                    eject = straggler_hook(step)
                    if eject:
                        ejections += 1
                        self.manager.save(step, state, block=True)
                        raise ElasticRemesh(eject)
            except ElasticRemesh:
                raise
            except Exception as e:                        # noqa: BLE001
                delay = backoff.next_delay()
                if delay is None:
                    raise RuntimeError(
                        f"exceeded {self.cfg.max_restarts} restarts") from e
                log.warning("step %d failed (%s); restoring", step, e)
                if delay > 0:
                    self.sleep_fn(delay)
                self.manager.wait()
                if self.manager.latest_step() is not None:
                    state, step, _ = self.manager.restore(state)
                else:
                    step = 0
        self.manager.wait()
        return RunResult(state, step, backoff.restarts, ejections)
