"""Cluster transport: message types and the two buses (port of
``repro/cluster/bus.py``).

The topology is a star: the router owns one control-plane mailbox; every
worker has an inbox the router posts to (``send``), and all worker-to-
router traffic comes back through ``poll``.  Two buses share that
contract:

* ``LocalBus``: in process, deterministic.  Workers are plain objects
  stepped round-robin in wid order by ``pump()``; with a ``VirtualClock``
  the whole cluster (heartbeats, timeouts, elastic watermarks) runs in
  virtual time with no sleeps.  A worker whose ``failure_hook`` fires
  raises ``WorkerKilled`` and the bus drops it cold, undelivered inbox and
  all, as a crashed process would lose it.
* ``ProcBus``: ``multiprocessing`` with the spawn context (CUDA is not
  fork-safe), one process per worker, a ``Queue`` inbox and a pipe back
  for each (``ProcBus`` has the reason).  Each child rebuilds its weights
  from ``(cfg, seed)`` on its own device (``lm.init`` draws them from a
  seeded generator, so every process gets the same bits), with its own
  CUDA context.  The parent builds every kernel library before the first
  spawn, so the children load them rather than race to compile them.
  ``kill()`` sends SIGKILL: the fault injection path of ``serve.py
  --cluster-kill``.  A child that fails to start (CUDA init, kernel load,
  weights) reports ``Failed`` and exits, and ``poll`` raises
  ``WorkerFailed``; so does a child that dies or stays silent past
  ``READY_TIMEOUT_S`` seconds before its first message.  ``ready_s`` keeps
  each worker's spawn-to-first-heartbeat seconds.

Both buses report liveness (``alive``) without acting on it: dead-worker
detection is the monitor's heartbeat timeout (control.py), so tests can
exercise replay without a real process dying.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cluster.handoff import KVHandoff
from repro_torch.kernels import common
from repro_torch.serving.request import Request, RequestResult

# the bound on a ProcBus child's spawn-to-first-message seconds (CUDA
# context, kernel load and a full-depth weight draw fit well inside it)
READY_TIMEOUT_S = 300.0


# -- router -> worker ------------------------------------------------------

@dataclasses.dataclass
class Submit:
    """Admit this request on a prefill worker."""
    req: Request


@dataclasses.dataclass
class Install:
    """Take ownership of a completed prefill (decode worker)."""
    handoff: KVHandoff


@dataclasses.dataclass
class Drain:
    """Finish in-flight work, accept nothing new, report ``Drained``."""


@dataclasses.dataclass
class Stop:
    """Exit after the current step (final stats ride the ``Bye``)."""


# -- worker -> router ------------------------------------------------------

@dataclasses.dataclass
class PrefillDone:
    """A prompt's KV pages are ready to travel (the router places them)."""
    wid: str
    handoff: KVHandoff


@dataclasses.dataclass
class Done:
    """A request finished on this worker."""
    wid: str
    result: RequestResult


@dataclasses.dataclass
class Heartbeat:
    """Per-step liveness and the placement signals.  ``checksum`` is the
    worker's weights fingerprint (``worker.weights_checksum``; a ProcBus
    child sends it, a LocalBus worker leaves it empty)."""
    wid: str
    role: str
    t: float                        # the sender's engine clock
    n_ticks: int
    pages_free: int = 0
    pages_total: int = 0
    queue_depth: int = 0            # engine queue + pending installs
    active_slots: int = 0
    num_slots: int = 0
    occupancy: Optional[np.ndarray] = None   # live leaf footprint (mean)
    profiles: Optional[dict] = None          # learned per-tenant footprints
    compiled_shapes: Optional[dict] = None
    handoff_bytes: int = 0
    draining: bool = False
    checksum: str = ""


@dataclasses.dataclass
class Drained:
    wid: str


@dataclasses.dataclass
class Bye:
    """Final stats on a clean shutdown (``Stop``)."""
    wid: str
    compiled_shapes: dict
    metrics: dict


@dataclasses.dataclass
class Failed:
    """A ``ProcBus`` child could not start or step; ``error`` is its
    traceback."""
    wid: str
    error: str


class WorkerFailed(RuntimeError):
    """Raised by ``ProcBus.poll`` for a child that failed or never started;
    the bus has already killed it."""

    def __init__(self, wid: str, why: str):
        super().__init__(f"cluster worker {wid} {why}")
        self.wid = wid


class WorkerKilled(Exception):
    """Raised inside a LocalBus worker tick to simulate a crash."""

    def __init__(self, wid: str):
        super().__init__(f"worker {wid} killed")
        self.wid = wid


class LocalBus:
    """Deterministic in-process transport (module docstring).

    ``factory(wid, role)`` builds a ``cluster.worker.ClusterWorker``; the
    bus steps live workers in sorted-wid order each ``pump()`` and
    advances ``clock`` by ``tick_dt`` when it can (a ``VirtualClock``), so
    heartbeat times move without wall time."""

    def __init__(self, factory: Callable[[str, str], object],
                 clock: Optional[Callable[[], float]] = None,
                 tick_dt: float = 0.01):
        self._factory = factory
        self._workers: Dict[str, object] = {}
        self._out: deque = deque()
        self._clock = clock
        self._tick_dt = tick_dt
        self.dead: set = set()

    def spawn(self, wid: str, role: str) -> None:
        if wid in self._workers:
            raise ValueError(f"worker {wid} already exists")
        self._workers[wid] = self._factory(wid, role)

    def send(self, wid: str, msg) -> bool:
        w = self._workers.get(wid)
        if w is None:
            return False
        w.inbox.append(msg)
        return True

    def pump(self) -> None:
        for wid in sorted(self._workers):
            w = self._workers[wid]
            try:
                self._out.extend(w.tick())
            except WorkerKilled:
                # a crash loses everything in the process: slot state,
                # queued installs, the undelivered inbox; replay is the
                # router's job once the heartbeat times out
                del self._workers[wid]
                self.dead.add(wid)
                continue
            if w.stopped:
                del self._workers[wid]
        adv = getattr(self._clock, "advance", None)
        if adv is not None and self._tick_dt > 0:
            adv(self._tick_dt)

    def poll(self) -> List[object]:
        msgs = list(self._out)
        self._out.clear()
        return msgs

    def alive(self, wid: str) -> bool:
        return wid in self._workers

    def workers(self) -> List[str]:
        return sorted(self._workers)

    def kill(self, wid: str) -> None:
        self._workers.pop(wid, None)
        self.dead.add(wid)

    def close(self) -> None:
        self._workers.clear()
        self._out.clear()


class ProcBus:
    """``multiprocessing`` transport (module docstring).  ``make_spec(wid,
    role)`` returns a picklable ``cluster.worker.WorkerSpec``; each spawn
    starts a daemon process running ``cluster.worker.worker_main``.

    Each child has its own inbox (a ``Queue``, fed by this process's
    feeder thread) and its own one-way pipe back.  A SIGKILL can land in
    the middle of a child's write; with a pipe of its own, only the dead
    child's pipe is left half-written or locked, and ``kill`` drops it
    unread: what a killed worker sent and the router had not read is lost
    with it, as its slots are."""

    def __init__(self, make_spec: Callable[[str, str], object]):
        import multiprocessing as mp
        self._ctx = mp.get_context("spawn")   # CUDA is not fork-safe
        self._make_spec = make_spec
        self._procs: Dict[str, Tuple[object, object, object]] = {}
        self._spawned_at: Dict[str, float] = {}
        self._built = False
        self.ready_s: Dict[str, float] = {}
        self.dead: set = set()

    def spawn(self, wid: str, role: str) -> None:
        if wid in self._procs:
            raise ValueError(f"worker {wid} already exists")
        from repro_torch.cluster.worker import worker_main
        spec = self._make_spec(wid, role)
        if not self._built and torch.device(spec.device).type == "cuda":
            common.build_all()      # once, here, not in every child at once
        self._built = True
        inbox = self._ctx.Queue()
        recv, send = self._ctx.Pipe(duplex=False)
        p = self._ctx.Process(target=worker_main, args=(spec, inbox, send),
                              daemon=True)
        self._spawned_at[wid] = time.monotonic()
        p.start()
        send.close()                # the child's end: EOF once it exits
        self._procs[wid] = (p, inbox, recv)

    def send(self, wid: str, msg) -> bool:
        entry = self._procs.get(wid)
        if entry is None:
            return False
        entry[1].put(msg)
        return True

    def pump(self) -> None:
        pass                                  # workers run their own loops

    def _read(self, timeout: float) -> List[object]:
        """Every message the children have sent, waiting up to ``timeout``
        seconds for the first (so an idle router does not spin)."""
        from multiprocessing.connection import wait
        open_ = {e[2]: wid for wid, e in self._procs.items() if not e[2].closed}
        msgs = []
        ready = wait(list(open_), timeout=timeout)
        while ready:
            for conn in ready:
                try:
                    msgs.append(conn.recv())
                except EOFError:            # the child exited; nothing more
                    conn.close()
                    del open_[conn]
            ready = wait(list(open_), timeout=0) if open_ else []
        return msgs

    def poll(self) -> List[object]:
        msgs = self._read(timeout=0.01)
        now = time.monotonic()
        for m in msgs:
            if isinstance(m, Failed):
                self._fail(m.wid, f"failed:\n{m.error}")
            if m.wid not in self.ready_s:
                self.ready_s[m.wid] = now - self._spawned_at[m.wid]
        for wid, (p, _, _) in list(self._procs.items()):
            if wid in self.ready_s:
                continue
            if not p.is_alive():
                self._fail(wid, f"exited (code {p.exitcode}) before its first "
                                f"heartbeat")
            if now - self._spawned_at[wid] > READY_TIMEOUT_S:
                self._fail(wid, f"sent no heartbeat within {READY_TIMEOUT_S} s "
                                f"of its spawn")
        return msgs

    def _fail(self, wid: str, why: str) -> None:
        """A worker that cannot serve: stop it for good and raise (once)."""
        self.kill(wid)
        raise WorkerFailed(wid, why)

    def alive(self, wid: str) -> bool:
        entry = self._procs.get(wid)
        return entry is not None and entry[0].is_alive()

    def workers(self) -> List[str]:
        return sorted(self._procs)

    def kill(self, wid: str) -> None:
        """SIGKILL: the fault-injection path (no cleanup, no goodbye)."""
        entry = self._procs.pop(wid, None)
        if entry is not None:
            p, inbox, recv = entry
            p.kill()
            p.join(timeout=5)
            recv.close()
            # what the dead child never read must not hold this process's
            # exit on a full pipe
            inbox.cancel_join_thread()
        self.dead.add(wid)

    def close(self) -> None:
        """Stop every child, reading (and dropping) what they still send so
        none blocks on a full pipe, and SIGKILL any still alive 10 s on."""
        for _, inbox, _ in self._procs.values():
            inbox.put(Stop())
        deadline = time.monotonic() + 10.0
        while any(e[0].is_alive() for e in self._procs.values()) \
                and time.monotonic() < deadline:
            self._read(timeout=0.05)
        for wid in list(self._procs):
            self.kill(wid)          # joins the exited; SIGKILLs the rest
