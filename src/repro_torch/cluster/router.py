"""Cluster control plane: admission, placement, replay, elastic actuation
(port of ``repro/cluster/router.py``; host only).

The ``Router`` owns everything above ``EngineConfig``:

* **Admission + tenant QoS** — one global waiting queue fed by
  ``submit``; each step the serving scheduler (``make_scheduler`` — the
  same stride-fair ``weighted_leaf_aware`` policy the single engine runs)
  picks which waiting requests get prefill credits.  The cluster view has
  no slot-level telemetry, so the scheduler sees a synthetic
  ``num_leaves=0`` view and degrades to its weighted-FIFO core; leaf
  balance is placement's job (placement.py scores the decode side).
* **Prefix affinity** — ``GlobalPrefixMap`` is a router-side radix over
  page-sized token chunks mapping longest-known-prefix → prefill worker,
  so prompts sharing a system prefix land where the local ``PrefixIndex``
  already holds those pages (admission there allocates shared pages
  instead of recomputing).  Entries die with their worker.
* **Handoff routing** — completed prefills (``PrefillDone``) carry their
  KV pages and measured leaf footprint; ``choose_decode`` places them on
  the decode fleet and the router optimistically debits the target's view
  so a burst doesn't pile onto one worker between heartbeats.
* **Fault tolerance** — the ``ClusterMonitor`` times out heartbeats; a
  dead worker's in-flight requests (prefilling on it, or decoding on it —
  the pages died with the process) go back to ``queued`` and re-run from
  the prompt.  Determinism makes replay exact: the regenerated tokens are
  byte-identical, and Done dedup (first result per rid wins) makes a
  kill-after-finish race harmless.  Respawns come back under a fresh
  worker id through the monitor's restart budget.
* **Elastic actuation** — monitor watermark decisions become
  ``bus.spawn`` (scale-up) or a ``Drain`` handshake (scale-down: worker
  finishes in-flight work, reports ``Drained``, gets ``Stop``).

Results are re-stamped on the ROUTER clock (submit→admit→first
token→finish as observed here), so cluster latency metrics include queue,
wire, and handoff time — not just the engine-local slice.  ``checksums``
keeps each worker's weights fingerprint from its heartbeats and its
goodbye (when the workers compute one), dead workers' included.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.cluster import bus as bus_lib
from repro_torch.cluster.control import (ClusterMonitor, ControlConfig,
                                         DrainWorker, MarkDead, Respawn,
                                         SpawnDecode)
from repro_torch.cluster.placement import (WorkerView, choose_decode,
                                           choose_prefill)
from repro_torch.serving import metrics as metrics_lib
from repro_torch.serving.request import Request, RequestResult
from repro_torch.serving.scheduler import SchedulerView, make_scheduler


@dataclasses.dataclass
class ClusterConfig:
    """Cluster policy knobs (everything above EngineConfig)."""
    n_prefill: int = 1
    n_decode: int = 2
    scheduler: str = "weighted_leaf_aware"
    scheduler_kw: dict = dataclasses.field(default_factory=dict)
    control: ControlConfig = dataclasses.field(default_factory=ControlConfig)
    page_size: int = 16             # must match every worker engine


class GlobalPrefixMap:
    """Longest-known-prefix → prefill worker, over page-sized chunks.

    Mirrors the per-engine radix ``PrefixIndex`` one level up: the router
    can't see pool pages, but it knows WHICH worker published a prefix, and
    that is all affinity needs."""

    def __init__(self, page_size: int):
        self.page = page_size
        self._map: Dict[bytes, str] = {}

    def insert(self, prompt, wid: str) -> None:
        p = np.asarray(prompt, np.int32)
        for n in range(self.page, len(p) + 1, self.page):
            self._map[p[:n].tobytes()] = wid

    def lookup(self, prompt) -> Optional[str]:
        p = np.asarray(prompt, np.int32)
        best = None
        for n in range(self.page, len(p) + 1, self.page):
            wid = self._map.get(p[:n].tobytes())
            if wid is None:
                break
            best = wid
        return best

    def drop_worker(self, wid: str) -> None:
        self._map = {k: w for k, w in self._map.items() if w != wid}

    def __len__(self) -> int:
        return len(self._map)


@dataclasses.dataclass
class _ReqState:
    req: Request
    phase: str = "queued"   # queued|prefilling|pending_handoff|decoding|done
    wid: Optional[str] = None
    submit_t: float = 0.0
    dispatch_t: float = 0.0
    first_token_t: float = 0.0


class Router:
    def __init__(self, bus, ccfg: ClusterConfig,
                 clock: Callable[[], float],
                 spawn_decode_fn: Optional[Callable[[], None]] = None):
        self.bus = bus
        self.ccfg = ccfg
        self.clock = clock
        self.scheduler = make_scheduler(ccfg.scheduler, **ccfg.scheduler_kw)
        self.monitor = ClusterMonitor(ccfg.control, clock)
        self.prefix_map = GlobalPrefixMap(ccfg.page_size)
        self.views: Dict[str, WorkerView] = {}
        self.waiting: deque = deque()
        self.pending_handoffs: deque = deque()
        self.states: Dict[int, _ReqState] = {}
        self.results: List[RequestResult] = []
        self.byes: Dict[str, bus_lib.Bye] = {}
        self._wid_seq: Dict[str, int] = {"prefill": 0, "decode": 0}
        self._spawn_decode_fn = spawn_decode_fn
        self.replayed_requests = 0
        self.worker_restarts = 0
        self.duplicate_results = 0
        self.ticks = 0
        self.checksums: Dict[str, str] = {}

    # -- topology ----------------------------------------------------------

    def _new_wid(self, role: str) -> str:
        n = self._wid_seq[role]
        self._wid_seq[role] = n + 1
        return f"{role[0]}{n}"

    def spawn_worker(self, role: str) -> str:
        wid = self._new_wid(role)
        self.bus.spawn(wid, role)
        self.views[wid] = WorkerView(wid=wid, role=role,
                                     last_seen=self.clock())
        return wid

    def start(self) -> None:
        for _ in range(self.ccfg.n_prefill):
            self.spawn_worker("prefill")
        for _ in range(self.ccfg.n_decode):
            self.spawn_worker("decode")

    # -- submission --------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.rid in self.states:
            raise ValueError(f"request rid {req.rid} already submitted")
        self.states[req.rid] = _ReqState(req=req, submit_t=self.clock())
        self.waiting.append(req)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting) + len(self.pending_handoffs)

    def outstanding(self) -> int:
        return sum(1 for s in self.states.values() if s.phase != "done")

    # -- message handling --------------------------------------------------

    def _handle(self, msg) -> None:
        now = self.clock()
        if isinstance(msg, bus_lib.Heartbeat):
            if msg.checksum:
                self.checksums[msg.wid] = msg.checksum
            v = self.views.get(msg.wid)
            if v is None:        # late beat from a worker we already buried
                return
            v.pages_free = msg.pages_free
            v.pages_total = msg.pages_total
            v.queue_depth = msg.queue_depth
            v.active_slots = msg.active_slots
            v.num_slots = msg.num_slots
            v.handoff_bytes = msg.handoff_bytes
            v.n_ticks = msg.n_ticks
            v.last_seen = now
            v.update_occupancy(msg.occupancy)
            if msg.profiles:
                v.profiles = msg.profiles
            # liveness runs on receipt time: worker clocks aren't ours
            self.monitor.observe_heartbeat(msg.wid, now)
        elif isinstance(msg, bus_lib.PrefillDone):
            st = self.states.get(msg.handoff.request.rid)
            if st is None or st.phase != "prefilling" or st.wid != msg.wid:
                return           # late: the request was replayed elsewhere
            self._credit(msg.wid, -1)
            self.prefix_map.insert(msg.handoff.request.prompt, msg.wid)
            st.phase, st.wid = "pending_handoff", None
            self.pending_handoffs.append(msg.handoff)
        elif isinstance(msg, bus_lib.Done):
            st = self.states.get(msg.result.rid)
            if st is None:
                return
            if st.phase == "done":
                self.duplicate_results += 1     # kill-after-finish race
                return
            if st.wid != msg.wid:
                # stale: the sender was buried and the request replayed —
                # only the currently-assigned worker's result counts (a
                # heartbeat timeout can bury a slow worker that still runs)
                self.duplicate_results += 1
                return
            self._credit(msg.wid, -1)
            st.phase = "done"
            self.results.append(dataclasses.replace(
                msg.result, arrival_time=st.submit_t,
                admitted_time=st.dispatch_t,
                first_token_time=st.first_token_t or now, finish_time=now))
        elif isinstance(msg, bus_lib.Drained):
            if msg.wid in self.views:
                self.bus.send(msg.wid, bus_lib.Stop())
        elif isinstance(msg, bus_lib.Bye):
            self.byes[msg.wid] = msg
            if msg.metrics.get("checksum"):
                self.checksums[msg.wid] = msg.metrics["checksum"]
            self.views.pop(msg.wid, None)
            self.monitor.forget(msg.wid)
            self.prefix_map.drop_worker(msg.wid)

    def _credit(self, wid: str, delta: int) -> None:
        v = self.views.get(wid)
        if v is not None:
            v.outstanding = max(0, v.outstanding + delta)

    # -- dispatch ----------------------------------------------------------

    def _scheduler_view(self) -> SchedulerView:
        """Synthetic slot-less view: the scheduler's leaf logic needs
        engine telemetry the router doesn't have, so num_leaves=0 degrades
        it to its fair-queueing core over the prefill fleet's credit."""
        free = sum(v.free_slots for v in self.views.values()
                   if v.role == "prefill" and not v.draining)
        n = max(1, free)
        return SchedulerView(
            occupancy=np.zeros((n, 1)), active=np.zeros((n,), bool),
            num_leaves=0, capacity_factor=1.0, num_slots=n,
            prefilling=np.zeros((n,), bool),
            pages_free=sum(v.pages_free for v in self.views.values()))

    def _dispatch_prefill(self) -> None:
        free = sum(v.free_slots for v in self.views.values()
                   if v.role == "prefill" and not v.draining)
        if free <= 0 or not self.waiting:
            return
        chosen = self.scheduler.select(list(self.waiting), free,
                                       self._scheduler_view())
        for req in chosen:
            if self.states[req.rid].phase != "queued":
                self.waiting.remove(req)        # completed while waiting
                continue
            hint = self.prefix_map.lookup(req.prompt)
            wid = choose_prefill(self.views, hint)
            if wid is None:
                break
            if not self.bus.send(wid, bus_lib.Submit(req)):
                continue         # raced a death; retry next tick
            self.waiting.remove(req)
            st = self.states[req.rid]
            st.phase, st.wid = "prefilling", wid
            st.dispatch_t = self.clock()
            self._credit(wid, +1)

    def _route_handoffs(self) -> None:
        held = len(self.pending_handoffs)
        for _ in range(held):
            h = self.pending_handoffs.popleft()
            st = self.states.get(h.request.rid)
            if st is None or st.phase != "pending_handoff":
                continue         # replayed or completed meanwhile
            wid = choose_decode(self.views, h.occupancy)
            if wid is None or not self.bus.send(wid, bus_lib.Install(h)):
                self.pending_handoffs.append(h)   # backpressure: hold it
                continue
            st.phase, st.wid = "decoding", wid
            if not st.first_token_t:
                st.first_token_t = self.clock()
            v = self.views[wid]
            self._credit(wid, +1)
            # optimistic debit until the next heartbeat refreshes truth
            need = -(-(h.prompt_len + h.request.max_new_tokens)
                     // max(1, h.page_size))
            v.pages_free = max(0, v.pages_free - need)

    # -- fault handling ----------------------------------------------------

    def _bury(self, wid: str) -> None:
        """Worker is dead: fence it, forget it, replay its in-flight
        work from the prompt (its pages died with it)."""
        self.bus.kill(wid)
        self.views.pop(wid, None)
        self.monitor.forget(wid)
        self.prefix_map.drop_worker(wid)
        for st in self.states.values():
            if st.wid == wid and st.phase in ("prefilling", "decoding"):
                st.phase, st.wid = "queued", None
                self.waiting.append(st.req)
                self.replayed_requests += 1

    def _execute(self, actions) -> None:
        for a in actions:
            if isinstance(a, MarkDead):
                self._bury(a.wid)
            elif isinstance(a, Respawn):
                self.spawn_worker(a.role)
                self.worker_restarts += 1
            elif isinstance(a, SpawnDecode):
                if self._spawn_decode_fn is not None:
                    self._spawn_decode_fn()
                else:
                    self.spawn_worker("decode")
            elif isinstance(a, DrainWorker):
                v = self.views.get(a.wid)
                if v is not None and not v.draining:
                    v.draining = True
                    self.bus.send(a.wid, bus_lib.Drain())

    # -- the loop ----------------------------------------------------------

    def step(self) -> None:
        self.ticks += 1
        self.bus.pump()
        for msg in self.bus.poll():
            self._handle(msg)
        self._dispatch_prefill()
        self._route_handoffs()
        self._execute(self.monitor.tick(self.views, len(self.waiting)))

    def run(self, requests: List[Request], max_ticks: int = 100_000,
            on_tick: Optional[Callable[["Router"], None]] = None
            ) -> List[RequestResult]:
        """Serve ``requests`` to completion; returns results sorted by rid.
        ``max_ticks`` bounds a wedged cluster (dead fleet + exhausted
        restart budget) instead of spinning forever.  ``on_tick`` runs
        after every step — fault-injection callers (serve.py
        ``--cluster-kill``, the benchmark's kill run) hook it."""
        for r in requests:
            self.submit(r)
        t0 = self.ticks
        while any(s.phase != "done" for s in self.states.values()):
            if self.ticks - t0 >= max_ticks:
                stuck = sorted(r for r, s in self.states.items()
                               if s.phase != "done")
                raise RuntimeError(
                    f"cluster wedged after {max_ticks} ticks; "
                    f"unfinished rids: {stuck[:10]}")
            self.step()
            if on_tick is not None:
                on_tick(self)
        return sorted(self.results, key=lambda r: r.rid)

    def kill_worker(self, wid: str) -> None:
        """Caller-initiated fault injection: SIGKILL/drop ``wid`` NOW, bury
        it (replaying its in-flight work) and respawn its role — the
        deterministic e2e kill path that doesn't wait out the heartbeat
        timeout (the monitor path is what the LocalBus tests exercise)."""
        role = self.views[wid].role
        self._bury(wid)
        self.spawn_worker(role)
        self.worker_restarts += 1

    def drain_all(self) -> None:
        for wid in list(self.views):
            self._execute([DrainWorker(wid)])

    def shutdown(self, max_ticks: int = 10_000) -> None:
        """Stop every worker and collect final Byes (LocalBus; ProcBus
        workers answer over the queue within the tick budget); then close
        the bus, even when a worker failed on the way."""
        try:
            for wid in list(self.views):
                self.bus.send(wid, bus_lib.Stop())
            for _ in range(max_ticks):
                if not self.views:
                    break
                self.bus.pump()
                try:
                    msgs = self.bus.poll()
                except bus_lib.WorkerFailed as e:
                    self.views.pop(e.wid, None)    # stopped by the bus already
                    continue
                for msg in msgs:
                    self._handle(msg)
                if not any(self.bus.alive(w) for w in self.views):
                    # a dead worker never says goodbye: read what the
                    # others sent before they exited, and stop waiting
                    for msg in self.bus.poll():
                        self._handle(msg)
                    break
        finally:
            self.bus.close()        # whatever failed above, no worker outlives it

    # -- reporting ---------------------------------------------------------

    def cluster_metrics(self) -> dict:
        per_worker = {}
        for wid, v in self.views.items():
            per_worker[wid] = {"role": v.role, "pages_free": v.pages_free,
                               "queue_depth": v.queue_depth,
                               "handoff_bytes": v.handoff_bytes,
                               "n_ticks": v.n_ticks}
        for wid, bye in self.byes.items():
            per_worker.setdefault(wid, {})["compiled_shapes"] = \
                bye.compiled_shapes
        return {
            "per_worker": per_worker,
            "handoff_bytes": sum(v.handoff_bytes
                                 for v in self.views.values())
                             + sum(b.metrics.get("handoff_bytes", 0)
                                   for b in self.byes.values()),
            "replayed_requests": self.replayed_requests,
            "worker_restarts": self.worker_restarts,
            "duplicate_results": self.duplicate_results,
            "scale_events": list(self.monitor.scale_events),
            "router_ticks": self.ticks,
        }

    def metrics(self, elapsed_s: Optional[float] = None
                ) -> metrics_lib.EngineMetrics:
        n_ticks = sum(v.n_ticks for v in self.views.values()) + \
            sum(b.metrics.get("n_ticks", 0) for b in self.byes.values())
        return metrics_lib.from_results(
            self.results,
            elapsed_s=self.clock() if elapsed_s is None else elapsed_s,
            n_steps=n_ticks, n_prefills=len(self.results),
            decode_lat_s=[], overflow_mean=0.0,
            pages_free=sum(v.pages_free for v in self.views.values()),
            pages_in_use=sum(v.pages_total - v.pages_free
                             for v in self.views.values()))
