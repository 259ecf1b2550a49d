"""A role-restricted engine wrapper and the ProcBus child's entry point
(port of ``repro/cluster/worker.py``).

A ``ClusterWorker`` owns one ``ContinuousBatchingEngine`` and drives it in
exactly one role:

* **prefill**: admits router-submitted requests (monolithic admission or
  the chunk slab), and the moment a slot's prompt is consumed and its
  first token sampled, ``handoff.extract``s its KV pages and releases the
  slot without minting a result: the request leaves as a ``PrefillDone``
  and a decode worker takes it over.  The engine's decode step never runs,
  so a prefill worker's dispatch shapes hold admission slabs only.
* **decode**: installs router-placed handoffs into free slots
  (``handoff.install``; an install the pool cannot fund stays queued,
  backpressure the next heartbeat reports as queue depth) and steps the
  engine, whose queue stays empty: its dispatch shapes hold ``decode`` (or
  ``draft`` and ``verify``) and ``install``.

So a role runs only its own kernels: a prefill worker's slabs launch the
router and the gathered or grouped leaf kernels and never the fused decode
kernel; a decode worker's steps launch the fused decode kernel (and, under
speculative decoding, its verify slab the gathered kernels) and never a
grouped GEMM.

``worker_main`` is the ProcBus child's entry point: module level (the
spawn context pickles it by name), it rebuilds the weights from ``(cfg,
seed)`` on ``WorkerSpec.device``, prints its ``weights_checksum`` (also
sent on every heartbeat and the goodbye) and loops inbox, tick, outbox
until ``Stop``.  A failure there is reported as ``bus.Failed`` before the
process exits, so the router raises instead of waiting out a heartbeat
timeout.
"""
from __future__ import annotations

import dataclasses
import hashlib
import traceback
from collections import deque
from typing import Callable, List, Optional

import torch

from repro_torch.cluster import bus as bus_lib
from repro_torch.cluster import handoff as handoff_lib


@dataclasses.dataclass
class WorkerSpec:
    """Everything a spawned process needs to rebuild its engine (picklable:
    configs and a seed, never weights).  ``ecfg.device`` must be
    ``device``."""
    wid: str
    role: str                      # "prefill" | "decode"
    cfg: object                    # the model's ModelConfig
    ecfg: object                   # EngineConfig (already role-sized)
    seed: int = 0
    heartbeat_every: int = 1
    draft_cfg: object = None       # the draft's ModelConfig under spec decoding
    device: str = "cuda"


def build_engine(spec: WorkerSpec):
    """Rebuild (params, engine) from a spec: ``worker_main`` does, and so
    can a LocalBus factory that wants engines identical to a ProcBus
    fleet's.  A ``draft_cfg`` draft draws its weights from ``seed + 1``."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import ContinuousBatchingEngine

    params = lm.init(spec.cfg, seed=spec.seed, device=spec.device)
    draft = None
    if spec.draft_cfg is not None:
        draft = (lm.init(spec.draft_cfg, seed=spec.seed + 1,
                         device=spec.device), spec.draft_cfg)
    return params, ContinuousBatchingEngine(params, spec.cfg, spec.ecfg,
                                            draft=draft)


_SAMPLE = 4096          # elements a tensor that weights_checksum keeps in order


def weights_checksum(params) -> str:
    """A fingerprint of a parameter tree's bits, in the tree's key order:
    per tensor, its raw bits summed as integers on its device (every value
    counts) and a strided sample of at most ``_SAMPLE`` of them in memory
    order (so a permuted or transposed layout changes it too), all hashed.
    Equal trees give equal strings in every process."""
    sums, samples = [], []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()]
            flat = t.contiguous().view(bits).reshape(-1)
            sums.append(flat.sum(dtype=torch.int64))
            step = max(1, flat.numel() // _SAMPLE)
            samples.append(flat[::step][:_SAMPLE].to(torch.int64))

    walk(params)
    host = torch.cat([torch.stack(sums)] + samples).cpu().numpy()
    return hashlib.sha256(host.tobytes()).hexdigest()[:16]


class ClusterWorker:
    """One engine, one role, driven by messages (module docstring)."""

    def __init__(self, wid: str, role: str, engine, *,
                 heartbeat_every: int = 1,
                 failure_hook: Optional[Callable[[int], bool]] = None,
                 checksum: str = ""):
        if role not in ("prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        self.wid = wid
        self.role = role
        self.engine = engine
        self.heartbeat_every = max(1, heartbeat_every)
        self.failure_hook = failure_hook
        self.checksum = checksum
        self.inbox: deque = deque()
        self.pending_installs: deque = deque()
        self.draining = False
        self.stopped = False
        self.n_ticks = 0
        self.handoff_bytes = 0

    # -- message handling --------------------------------------------------

    def _handle(self, msg) -> None:
        if isinstance(msg, bus_lib.Submit):
            if self.role != "prefill":
                raise ValueError(f"{self.wid}: decode worker got Submit")
            self.engine.submit(msg.req)
        elif isinstance(msg, bus_lib.Install):
            if self.role != "decode":
                raise ValueError(f"{self.wid}: prefill worker got Install")
            self.pending_installs.append(msg.handoff)
        elif isinstance(msg, bus_lib.Drain):
            self.draining = True
        elif isinstance(msg, bus_lib.Stop):
            self.stopped = True
        else:
            raise ValueError(f"{self.wid}: unknown message {type(msg)}")

    def _heartbeat(self) -> bus_lib.Heartbeat:
        e = self.engine
        profiles = e.profiles.as_dict() if e.profiles is not None else None
        return bus_lib.Heartbeat(
            wid=self.wid, role=self.role, t=e.now(), n_ticks=self.n_ticks,
            pages_free=e.pool.pages_free, pages_total=e.pool.num_pages,
            queue_depth=len(e.queue) + len(self.pending_installs),
            active_slots=sum(s is not None for s in e.slots),
            num_slots=e.ecfg.num_slots, occupancy=e.occupancy_snapshot(),
            profiles=profiles, compiled_shapes=e.compiled_shapes(),
            handoff_bytes=self.handoff_bytes, draining=self.draining,
            checksum=self.checksum)

    def _bye(self) -> bus_lib.Bye:
        metrics = {"n_ticks": self.n_ticks, "handoff_bytes": self.handoff_bytes,
                   "checksum": self.checksum}
        if self.engine.device.type == "cuda":
            metrics["peak_bytes"] = torch.cuda.max_memory_allocated(
                self.engine.device)
        return bus_lib.Bye(self.wid, self.engine.compiled_shapes(), metrics)

    @property
    def idle(self) -> bool:
        return (not self.engine.has_work() and not self.pending_installs
                and not self.inbox)

    # -- the tick ----------------------------------------------------------

    def tick(self) -> List[object]:
        """Drain the inbox, advance the engine one step for this role, and
        return the outbound messages.  Raises ``WorkerKilled`` when the
        failure hook fires; LocalBus turns that into a dropped worker."""
        if self.stopped:
            return []
        out: List[object] = []
        while self.inbox:
            self._handle(self.inbox.popleft())
            if self.stopped:
                out.append(self._bye())
                return out
        self.n_ticks += 1
        if self.failure_hook is not None and self.failure_hook(self.n_ticks):
            raise bus_lib.WorkerKilled(self.wid)
        if self.role == "decode":
            self._tick_decode()
        else:
            out.extend(self._tick_prefill())
        for r in self.engine.results:
            out.append(bus_lib.Done(self.wid, r))
        del self.engine.results[:]
        if self.n_ticks % self.heartbeat_every == 0:
            out.append(self._heartbeat())
        if self.draining and self.idle:
            out.append(bus_lib.Drained(self.wid))
            self.draining = False          # report once; the router stops us
        return out

    def _tick_decode(self) -> None:
        while self.pending_installs:
            slot = handoff_lib.install(self.engine, self.pending_installs[0])
            if slot is None:
                break                       # no slot or pages yet: backpressure
            self.handoff_bytes += self.pending_installs.popleft().nbytes
        self.engine.step()                  # empty queue: decode and evict only

    def _tick_prefill(self) -> List[object]:
        e = self.engine
        e._evict_finished()
        if not self.draining:
            e._admit()                      # monolithic: the whole prefill here
        if e.ecfg.prefill_chunk:
            for _ in range(e.ecfg.prefill_budget):
                e._chunk_prefill()
        out: List[object] = []
        for i, st in enumerate(e.slots):
            if st is None or st.prefilling or not st.tokens or st.done:
                continue                    # a finish at prefill takes the evict path
            h = handoff_lib.extract(e, i)
            e.release_slot(i, record_result=False)
            out.append(bus_lib.PrefillDone(self.wid, h))
        return out


def worker_main(spec: WorkerSpec, inbox, outbox) -> None:
    """ProcBus child entry point: rebuild the engine, serve messages from
    ``inbox`` (a queue) until ``Stop`` (or SIGKILL, which needs no
    goodbye), sending on ``outbox`` (this worker's own pipe).  Any failure
    is sent as ``bus.Failed`` with its traceback before the process
    exits."""
    import queue as queue_lib

    try:
        params, engine = build_engine(spec)
        checksum = weights_checksum(params)
        print(f"[cluster] worker {spec.wid} ({spec.role}): weights "
              f"checksum {checksum}", flush=True)
        del params
        worker = ClusterWorker(spec.wid, spec.role, engine,
                               heartbeat_every=spec.heartbeat_every,
                               checksum=checksum)
        while not worker.stopped:
            try:
                if worker.idle:
                    worker.inbox.append(inbox.get(timeout=0.02))
                while True:
                    worker.inbox.append(inbox.get_nowait())
            except queue_lib.Empty:
                pass
            for msg in worker.tick():       # the tick sends the Bye on Stop
                outbox.send(msg)
    except Exception:                       # noqa: BLE001 - reported, then exit
        outbox.send(bus_lib.Failed(spec.wid, traceback.format_exc()))
        raise
