"""Continuous-batching serving engine (port of ``repro/serving/engine.py``
on the contiguous slot-pooled cache, ``page_size`` 0).

* Every slot owns one ``max_len`` row of the pooled KV cache on one
  explicit device (``EngineConfig.device``, CUDA by default).  Admission
  restarts the slot's row at length 0 (``lm.cache_admit``); eviction is
  host bookkeeping only, since every later write is masked to live rows.
* The decode batch is always ``(num_slots, 1)``: free slots decode a
  filler token whose output is ignored and never written.
* Monolithic admission prefills a prompt as a ``(num_slots, bucket)`` chunk
  slab, the prompt right-padded to one of a small static set of buckets
  (powers of two up to ``max_prompt_len``); only the admitted row is valid.
* With ``prefill_chunk > 0`` admission is chunked: every in-flight prefill
  advances through one ``(num_slots, prefill_chunk)`` slab per dispatch, at
  most ``prefill_budget`` dispatches per step, interleaved with decode.
* With ``spec_k > 0`` the decode step becomes a speculative round
  (``serving/spec.py``): ``spec_k + 1`` draft steps at ``(num_slots, 1)``,
  the target's verify of the ``(num_slots, spec_k + 1)`` slab, host
  rejection sampling, and host-authoritative cache lengths that roll the
  optimistic appends back at the next round.  The draft's cache rows
  mirror the target's.

Fixed shapes matter less without a compiler, but they keep the path the
same every step: ``dispatch_shapes()`` records the shapes each dispatch saw
(the counterpart of JAX's ``compiled_shapes()``), and CUDA-graph capture of
the decode and verify shapes will rely on them.  On the card the FFF sites
resolve per shape (``core/api.py``): decode and draft steps to the fused
decode kernel, slabs of at most 32 tokens (the verify slab at 8 slots and
``spec_k`` 3) to the gathered kernels, larger slabs to the grouped GEMMs.

Admission policy is pluggable (``serving/scheduler.py``); ``leaf_aware``
reads the per-slot FFF leaf occupancy the engine collects through
``api.collect_routing``, reduced on the device and copied to the host
with the dispatch's logits in one transfer.  Sampling is host numpy, deterministic under
``EngineConfig.seed``; the draft samples on the device from a seeded
``torch.Generator``.  ``capacity_factor`` and ``overflow_policy`` steer the
live FFF dispatch (``api.overrides``) of capacity-bounded backends
(``grouped``, ``grouped_ep``); the scheduler's overflow proxy and the
overflow-policy metrics read the same values.  Left for later slices:
paging and prefix sharing, tenants and their profiles, the cluster.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import api
from repro_torch.distributed import act as dist_act
from repro_torch.models import lm
from repro_torch.nn import mlp as mlp_lib
from repro_torch.serving import metrics as metrics_lib
from repro_torch.serving import spec as spec_lib
from repro_torch.serving.request import Request, RequestResult, SlotState
from repro_torch.serving.scheduler import Scheduler, SchedulerView, make_scheduler


# weight of the newest routing histogram in a slot's occupancy average
_OCCUPANCY_EWMA = 0.5


def _pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


def _to_host(parts: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy a dispatch's outputs to the host in one transfer, the round's
    one synchronization: every part goes as float32 (token ids and leaf
    counts stay exact below 2**24) and comes back in its own shape."""
    flat = torch.cat([p.reshape(-1).float() for p in parts]).cpu().numpy()
    out, o = [], 0
    for p in parts:
        out.append(flat[o:o + p.numel()].reshape(tuple(p.shape)))
        o += p.numel()
    return out


@dataclasses.dataclass
class EngineConfig:
    """Engine shape and policy knobs.  ``max_len`` bounds prompt +
    generation per slot; monolithic prefill pads a prompt to the static
    set of slab widths ``buckets()``: powers of two from 16 up to
    ``max_prompt_len``.

    ``prefill_chunk``: 0 = monolithic prefill (one bucket-padded slab per
    admission); > 0 = chunked prefill through a shared ``(num_slots,
    prefill_chunk)`` slab, at most ``prefill_budget`` slabs per step; a
    power of two <= ``max_prompt_len``.  ``spec_k`` > 0 turns on
    speculative decoding with the ``draft_config`` draft (None = "self",
    the target's first period).  ``fff_backend`` other than "auto" steers
    every FFF site (``api.overrides``).

    ``capacity_factor``: None = the configured backend's default; a value
    steers the live dispatch of capacity-bounded backends (cf < 1.0
    under-provisions per-leaf capacity on purpose) and the scheduler's
    overflow proxy.  ``overflow_policy``: what such a dispatch does with
    over-capacity tokens, "exact_dense" (their exact leaf output),
    "master_leaf" (the master term alone; needs FFF sites built with
    ``fff_master_leaf``) or "drop" (zeros); None = the backend's default
    (``api.default_overflow_policy``)."""
    num_slots: int = 8
    max_len: int = 128
    max_prompt_len: int = 64
    max_prefills_per_step: int = 2
    prefill_chunk: int = 0
    prefill_budget: int = 1
    scheduler: str = "fcfs"
    fff_backend: str = "auto"
    capacity_factor: Optional[float] = None
    overflow_policy: Optional[str] = None
    spec_k: int = 0
    draft_config: Optional[str] = None
    seed: int = 0
    device: str = "cuda"

    def buckets(self) -> Tuple[int, ...]:
        return _pow2_buckets(min(16, self.max_prompt_len), self.max_prompt_len)


class ContinuousBatchingEngine:
    """Continuous-batching serving loop (module docstring has the design).

    Args:
        params:    the LM parameters (``lm.init``), on ``ecfg.device``.
        cfg:       the ``ModelConfig``: a decoder-only attention stack.
        ecfg:      shape and policy knobs (``EngineConfig``).
        scheduler: an admission ``Scheduler``; default built from
                   ``ecfg.scheduler`` with its default knobs.

    Drive it with ``run(requests)`` (serve to completion; returns results
    and ``EngineMetrics``) or by hand: ``submit``, then ``step()`` while
    ``has_work()``, reading ``poll_metrics()`` for live telemetry."""

    def __init__(self, params, cfg, ecfg: EngineConfig,
                 scheduler: Optional[Scheduler] = None):
        if any(b.mixer != "attn" or b.cross_attention for b in cfg.period):
            raise ValueError("serving engine requires attention mixers "
                             "(padded slabs are length-masked)")
        if ecfg.max_prompt_len >= ecfg.max_len:
            raise ValueError("max_prompt_len must leave room to generate "
                             "(max_prompt_len < max_len)")
        if ecfg.prefill_chunk:
            c = ecfg.prefill_chunk
            if c < 1 or (c & (c - 1)):
                raise ValueError(f"prefill_chunk {c} must be a power of two")
            if c > ecfg.max_prompt_len:
                raise ValueError(
                    f"prefill_chunk {c} exceeds max_prompt_len "
                    f"{ecfg.max_prompt_len}: use monolithic prefill "
                    f"(prefill_chunk=0)")
            if ecfg.prefill_budget < 1:
                raise ValueError("prefill_budget must be >= 1 when chunked "
                                 "prefill is on")
        if ecfg.spec_k < 0:
            raise ValueError(f"spec_k {ecfg.spec_k} must be >= 0")
        if ecfg.draft_config is not None and not ecfg.spec_k:
            raise ValueError("draft_config is set but spec_k == 0")
        if (ecfg.overflow_policy is not None
                and ecfg.overflow_policy not in api.OVERFLOW_POLICIES):
            raise ValueError(
                f"overflow_policy {ecfg.overflow_policy!r} not in "
                f"{api.OVERFLOW_POLICIES}")
        want = utils.resolve_device(ecfg.device)
        self.device = params["embed"]["tok"].device
        if self.device.type != want.type or want.index not in (
                None, self.device.index):
            raise ValueError(f"params live on {self.device}, the engine is "
                             f"asked to run on {want}")
        self.params, self.cfg, self.ecfg = params, cfg, ecfg
        self.num_leaves = next(
            (2 ** b.ffn.fff_depth for b in cfg.period if b.ffn.kind == "fff"),
            0)
        fff_spec = next((b.ffn for b in cfg.period if b.ffn.kind == "fff"),
                        None)
        # the first FFF site's layer config, to predict what the auto
        # resolver dispatches (the scheduler's capacity proxy)
        self._site_cfg = None if fff_spec is None else mlp_lib.make_fff_config(
            fff_spec, cfg.d_model, param_dtype=cfg.param_dtype,
            accum_dtype=cfg.accum_dtype)
        if (ecfg.overflow_policy == "master_leaf"
                and self._site_cfg is not None
                and not self._site_cfg.master_leaf):
            # fail at construction, not at the first dispatch
            raise ValueError(
                'overflow_policy="master_leaf" needs FFF sites built with '
                "fff_master_leaf=True: this model has no master term to "
                "stand in for dropped tokens")
        self._topology: Optional[Tuple[int, Optional[float]]] = None
        self._policy: Optional[str] = None    # set alongside _topology
        self.scheduler = scheduler or make_scheduler(ecfg.scheduler)
        S, L = ecfg.num_slots, ecfg.max_len
        self.caches = lm.init_caches(cfg, S, L, device=self.device)
        # speculative decoding: the draft's cache rows live alongside the
        # target's, slot for slot.  _tlen/_dlen are the host-authoritative
        # cache lengths: verify appends k+1 positions optimistically, host
        # rejection decides how many survive, and the next round's rollout
        # rolls both trees back to them.
        self.spec = ecfg.spec_k > 0
        self.draft_params = self.draft_cfg = self.draft_caches = None
        if self.spec:
            self.draft_params, self.draft_cfg = spec_lib.build_draft(
                ecfg.draft_config, params, cfg)
            self.draft_caches = lm.init_caches(self.draft_cfg, S, L,
                                               device=self.device)
            self._tlen = np.zeros((S,), np.int32)
            self._dlen = np.zeros((S,), np.int32)
            self._gen = torch.Generator(device=self.device).manual_seed(
                ecfg.seed)
        self.n_draft_tokens = 0
        self.n_accepted_tokens = 0
        self.slots: List[Optional[SlotState]] = [None] * S
        self.queue: List[Request] = []
        self.results: List[RequestResult] = []
        self.occupancy = np.zeros((S, max(self.num_leaves, 1)), np.float64)
        self._hint_mismatches = 0
        self._hint_warned = False
        # what a free slot decodes: its last occupant's last non-EOS token
        # (distinct ids before first use), so phantom rows route like real
        # tokens instead of piling onto one leaf
        self._free_tok = (np.arange(S) % cfg.vocab_size).astype(np.int32)
        self._live_rids: set = set()
        self._arrivals: Dict[int, float] = {}      # id(req) -> engine clock
        # per-slot raw leaf counts over a request's prefill chunks
        self._prefill_counts = np.zeros((S, max(self.num_leaves, 1)),
                                        np.float64)
        self._shapes: Dict[str, Set[tuple]] = {}
        self._t0 = time.monotonic()
        self.n_steps = self.n_prefills = self.n_chunks = 0
        self.n_prefill_tokens = 0
        self.decode_lat: List[float] = []
        self.decode_interval_s: List[float] = []
        self._last_decode_end: Optional[float] = None
        # slot-weighted overflow accumulators by phase ("draft" keeps the
        # draft model's routing out of the target's numbers)
        self._overflow = {"prefill": [0.0, 0.0], "decode": [0.0, 0.0],
                          "draft": [0.0, 0.0]}

    # -- clock and submission ------------------------------------------------

    def now(self) -> float:
        """Engine-clock seconds since construction."""
        return time.monotonic() - self._t0

    def validate(self, req: Request) -> None:
        """Checks a request must pass to be servable; raises ValueError."""
        if len(req.prompt) > self.ecfg.buckets()[-1]:
            raise ValueError(
                f"request {req.rid}: prompt len {len(req.prompt)} exceeds "
                f"max prefill bucket {self.ecfg.buckets()[-1]}")
        if len(req.prompt) + req.max_new_tokens > self.ecfg.max_len:
            raise ValueError(f"request {req.rid}: prompt + max_new_tokens "
                             f"exceeds max_len {self.ecfg.max_len}")
        if req.rid in self._live_rids:
            raise ValueError(f"request rid {req.rid} is already queued or "
                             f"active")

    def submit(self, req: Request, arrival_time: Optional[float] = None
               ) -> None:
        """Enqueue a request; its arrival is the engine clock now unless
        given (``Request.arrival_time`` is never mutated)."""
        self.validate(req)
        h = req.leaf_hint
        if h is not None and self.num_leaves and (
                h.size != self.num_leaves or h.sum() <= 0):
            # advisory, so never rejected: counted, and warned about once
            self._hint_mismatches += 1
            if not self._hint_warned:
                self._hint_warned = True
                warnings.warn(f"request {req.rid}: unusable leaf_hint (size "
                              f"{h.size}, {self.num_leaves} leaves, or zero "
                              f"mass); ignoring it", stacklevel=2)
        self._live_rids.add(req.rid)
        self._arrivals[id(req)] = (self.now() if arrival_time is None
                                   else arrival_time)
        self.queue.append(req)

    # -- device plumbing -----------------------------------------------------

    def _overrides(self) -> dict:
        """The ``api.overrides`` arguments the engine's dispatches run
        under: the backend, and the capacity factor and overflow policy that
        steer the live dispatch (not just the scheduler proxy)."""
        kw = {}
        if self.ecfg.fff_backend != "auto":
            kw.update(backend=self.ecfg.fff_backend, mode="infer")
        if self.ecfg.capacity_factor is not None:
            kw["capacity_factor"] = self.ecfg.capacity_factor
        if self.ecfg.overflow_policy is not None:
            kw["overflow_policy"] = self.ecfg.overflow_policy
        return kw

    def _ctx(self):
        es = contextlib.ExitStack()
        es.enter_context(torch.inference_mode())
        kw = self._overrides()
        if kw:
            es.enter_context(api.overrides(**kw))
        es.enter_context(api.collect_routing())
        return es

    def _dispatch_topology(self) -> Tuple[int, Optional[float]]:
        """(token-axis shard count, capacity factor) the live FFF dispatch
        runs with, which the scheduler's overflow proxy must match.
        ``auto`` resolves through ``api.resolve_backend`` under the engine's
        overrides and installed groups, for a slab on the engine's device;
        cached, since neither changes over the engine's life.  Capacity
        factor None = an exact backend, no bound to predict against."""
        if self._topology is None:
            backend = self.ecfg.fff_backend
            kw = self._overrides()
            with api.overrides(**kw) if kw else contextlib.nullcontext():
                g = dist_act.data_shard_count()
                m = dist_act.model_shard_count()
                if backend == "auto":
                    backend = (api.resolve_backend({}, self._site_cfg,
                                                   x_device=self.device)
                               if self._site_cfg is not None else "reference")
            if backend in ("reference", "cuda", "cuda_decode"):
                self._topology = (1, None)     # exact: no capacity bound
                self._policy = None
            else:
                shards = g * m if backend == "grouped_ep" else g
                cf = (self.ecfg.capacity_factor
                      if self.ecfg.capacity_factor is not None
                      else api.default_capacity_factor(backend))
                self._topology = (shards, cf)
                self._policy = (self.ecfg.overflow_policy
                                if self.ecfg.overflow_policy is not None
                                else api.default_overflow_policy(backend))
        return self._topology

    def _overflow_policy(self) -> Optional[str]:
        """The overflow policy the live dispatch runs with; None when no
        capacity bound exists (exact backends never drop)."""
        self._dispatch_topology()
        return self._policy

    def _repair_counters(self, ovf0: Optional[dict] = None
                         ) -> Tuple[int, float]:
        """Overflow-policy accounting from the slot-weighted overflow
        accumulators: (estimated repaired (token, tree) slots, fraction of
        slots served by the master leaf alone).  ``ovf0`` rebases onto a
        per-run snapshot of ``self._overflow``.  Repairs are 0 under "drop"
        (nothing stands in); the master fraction is nonzero only under
        "master_leaf"."""
        policy = self._overflow_policy()
        if policy in (None, "drop"):
            return 0, 0.0
        w = n = 0.0
        for k, acc in self._overflow.items():
            base = ovf0[k] if ovf0 else (0.0, 0.0)
            w += acc[0] - base[0]
            n += acc[1] - base[1]
        frac = (w / n if n else 0.0) if policy == "master_leaf" else 0.0
        return int(round(w)), frac

    def _verify_cf(self) -> Optional[float]:
        """Capacity factor of the speculative round's dispatches: the decode
        capacity factor times the slab width ``k + 1``, so each verify token
        sees the per-leaf capacity it would have in plain decode and
        speculation batches serving numerics instead of changing them.
        None for exact backends."""
        _, cf = self._dispatch_topology()
        return None if cf is None else float(cf) * (self.ecfg.spec_k + 1)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _record_shape(self, name: str, shape) -> None:
        self._shapes.setdefault(name, set()).add(tuple(shape))

    def _admit_rows(self, slot: int) -> None:
        """Restart the slot's cache rows at length 0 (both trees)."""
        admit = np.zeros((self.ecfg.num_slots,), bool)
        admit[slot] = True
        admit = self._dev(admit)
        self.caches = lm.cache_admit(self.caches, admit)
        if self.spec:
            self.draft_caches = lm.cache_admit(self.draft_caches, admit)
            self._tlen[slot] = self._dlen[slot] = 0

    def _slab(self, name: str, toks: np.ndarray, valid: np.ndarray):
        """One prefill slab through the target (and the draft under spec):
        returns (logits (S, V), the target's per-row leaf counts (S, E) or
        None), both on the host after one copy."""
        t, v = self._dev(toks), self._dev(valid)
        self._record_shape(name, t.shape)
        dstats = None
        with self._ctx():
            if self.spec:
                logits, self.caches, self.draft_caches, stats, dstats = \
                    spec_lib.chunk_both(self.params, self.cfg,
                                        self.draft_params, self.draft_cfg, t,
                                        v, self.caches, self.draft_caches)
            else:
                logits, self.caches, stats = lm.prefill_chunk(
                    self.params, self.cfg, t, v, self.caches)
            sv, dv = self._reduce_stats(stats), self._reduce_stats(dstats)
            host = _to_host([logits] + [p for p in (sv, dv) if p is not None])
        logits, host = host[0], host[1:]
        counts = self._fold_stats(host.pop(0), "prefill") if sv is not None \
            else None
        if dv is not None:
            self._fold_stats(host.pop(0), "draft")
        return logits, counts

    # -- telemetry -----------------------------------------------------------

    def _reduce_stats(self, stats) -> Optional[torch.Tensor]:
        """A dispatch's per-site routing stats, reduced on the device (no
        sync) to one vector: per-row leaf counts (B, E) summed over the
        sites of the engine's leaf count, flattened, then the sum over all
        sites of overflow * slots and of slots.  Slots count valid tokens
        only: the validity mask sends filler rows to the sentinel leaf."""
        if stats is None or self.num_leaves == 0:
            return None
        sites = [s for s in stats if s is not None]
        counts = torch.stack([s.leaf_counts for s in sites
                              if s.leaf_counts.shape[-1] == self.num_leaves]
                             ).sum(0)
        ovf = torch.stack([s.overflow.float().reshape(()) for s in sites])
        w = torch.stack([s.slots.float().reshape(()) for s in sites])
        return torch.cat([counts.reshape(-1).float(), (ovf * w).sum()[None],
                          w.sum()[None]])

    def _fold_stats(self, v: np.ndarray, phase: str) -> np.ndarray:
        """``_reduce_stats``'s vector on the host: folds the slot-weighted
        overflow into the phase's running mean; returns the per-row leaf
        counts (B, E)."""
        acc = self._overflow[phase]
        acc[0] += float(v[-2])
        acc[1] += float(v[-1])
        return v[:-2].astype(np.float64).reshape(-1, self.num_leaves)

    def _update_occupancy(self, rows: Sequence[int],
                          counts: Optional[np.ndarray]) -> None:
        if counts is None:
            return
        a = _OCCUPANCY_EWMA
        for r in rows:
            tot = counts[r].sum()
            if tot <= 0:
                continue
            frac = counts[r] / tot
            prev = self.occupancy[r]
            self.occupancy[r] = frac if not prev.any() else \
                (1.0 - a) * prev + a * frac

    def overflow_mean(self, phase: Optional[str] = None) -> float:
        """Slot-weighted mean overflow_fraction; ``phase`` in {"prefill",
        "decode", "draft", None = all}.  0 under exact backends; under
        ``grouped`` and ``grouped_ep`` the share of real slots over
        capacity, whatever the overflow policy then did with them."""
        keys = [phase] if phase else list(self._overflow)
        w = sum(self._overflow[k][0] for k in keys)
        n = sum(self._overflow[k][1] for k in keys)
        return w / n if n else 0.0

    # -- sampling (host numpy, deterministic under seed) ---------------------

    def _sample(self, st: SlotState, logits_row: np.ndarray) -> int:
        if st.request.temperature <= 0.0:
            return int(logits_row.argmax())
        rng = np.random.default_rng(
            (self.ecfg.seed, st.request.rid, len(st.tokens)))
        z = logits_row / st.request.temperature
        return int((z + rng.gumbel(size=z.shape)).argmax())

    def _record_token(self, st: SlotState, tok: int) -> None:
        st.tokens.append(tok)
        st.total_len += 1
        req = st.request
        if req.eos_id is not None and tok == req.eos_id:
            st.done, st.finish_reason = True, "eos"
        elif len(st.tokens) >= req.max_new_tokens:
            st.done, st.finish_reason = True, "length"
        if st.done:
            st.finish_time = self.now()

    # -- the loop ------------------------------------------------------------

    def release_slot(self, i: int) -> None:
        """Free slot ``i`` and record its result.  No device work: the row
        is masked out of every later write and restarted at admission."""
        st = self.slots[i]
        if st is None:
            return
        self.occupancy[i] = 0.0
        self._prefill_counts[i] = 0.0
        spread = [t for t in st.tokens if t != st.request.eos_id]
        self._free_tok[i] = (spread[-1] if spread
                             else int(st.request.prompt[-1]))
        self._live_rids.discard(st.request.rid)
        arrival = self._arrivals.pop(id(st.request), st.admitted_time)
        self.results.append(RequestResult(
            rid=st.request.rid, prompt=st.request.prompt,
            tokens=np.asarray(st.tokens, np.int32),
            finish_reason=st.finish_reason, arrival_time=arrival,
            admitted_time=st.admitted_time,
            first_token_time=st.first_token_time,
            finish_time=st.finish_time, n_drafted=st.n_drafted,
            n_accepted=st.n_accepted))
        self.slots[i] = None

    def _seed_hint(self, slot: int, req: Request) -> None:
        """The slot's occupancy before telemetry lands: the request's usable
        ``leaf_hint``, else nothing."""
        h = req.leaf_hint
        if h is not None and self.num_leaves and h.size == self.num_leaves \
                and h.sum() > 0:
            self.occupancy[slot] = h / h.sum()

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        n = min(len(free), self.ecfg.max_prefills_per_step)
        shards, cf = self._dispatch_topology()
        view = SchedulerView(
            occupancy=self.occupancy,
            active=np.asarray([s is not None for s in self.slots]),
            num_leaves=self.num_leaves, capacity_factor=cf,
            num_slots=self.ecfg.num_slots, dispatch_shards=shards,
            tokens_per_slot=self.ecfg.spec_k + 1)
        for req in self.scheduler.select(list(self.queue), n, view):
            self.queue.remove(req)
            slot = free.pop(0)
            self._admit_rows(slot)
            if self.ecfg.prefill_chunk:
                self._admit_chunked(req, slot)
            else:
                self._admit_monolithic(req, slot)

    def _admit_monolithic(self, req: Request, slot: int) -> None:
        """One ``(num_slots, bucket)`` slab prefills the prompt; only the
        admitted row is valid.  Pad positions repeat the last real token
        and filler rows carry in-distribution tokens, so their FFF routing
        stays spread; neither writes the cache."""
        prompt = req.prompt
        L = len(prompt)
        bucket = next(b for b in self.ecfg.buckets() if b >= L)
        toks = np.repeat(self._free_tok[:, None], bucket, axis=1)
        toks[slot, :L] = prompt
        toks[slot, L:] = prompt[-1]
        valid = np.zeros((self.ecfg.num_slots,), np.int32)
        valid[slot] = L
        logits, counts = self._slab(f"prefill_{bucket}", toks, valid)
        if self.spec:
            self._tlen[slot] = self._dlen[slot] = L
        self.n_prefills += 1
        self.n_prefill_tokens += L
        t = self.now()
        st = SlotState(request=req, admitted_time=t, first_token_time=t,
                       tokens=[], total_len=L, prefill_pos=L)
        self.slots[slot] = st
        if counts is not None and counts[slot].sum() > 0:
            self.occupancy[slot] = counts[slot] / counts[slot].sum()
        else:
            self._seed_hint(slot, req)
        self._record_token(st, self._sample(st, logits[slot]))

    def _admit_chunked(self, req: Request, slot: int) -> None:
        """No model call: the prompt advances through the shared chunk slab
        in later ``_chunk_prefill`` dispatches."""
        self.slots[slot] = SlotState(request=req, admitted_time=self.now(),
                                     first_token_time=0.0, tokens=[],
                                     total_len=0, prefill_pos=0)
        self._prefill_counts[slot] = 0.0
        self._seed_hint(slot, req)

    def _chunk_prefill(self) -> None:
        """One ``(num_slots, prefill_chunk)`` slab: every mid-prefill slot
        consumes its next chunk; rows whose prompt completes sample their
        first token from the slab's logits."""
        prefilling = [i for i, s in enumerate(self.slots)
                      if s is not None and s.prefilling]
        if not prefilling:
            return
        S, C = self.ecfg.num_slots, self.ecfg.prefill_chunk
        toks = np.repeat(self._free_tok[:, None], C, axis=1)
        valid = np.zeros((S,), np.int32)
        for i in prefilling:
            st = self.slots[i]
            p = st.request.prompt
            n = min(C, len(p) - st.prefill_pos)
            toks[i, :n] = p[st.prefill_pos:st.prefill_pos + n]
            toks[i, n:] = p[st.prefill_pos + n - 1]
            valid[i] = n
        logits, counts = self._slab("chunk", toks, valid)
        self.n_chunks += 1
        for i in prefilling:
            st = self.slots[i]
            st.prefill_pos += int(valid[i])
            self.n_prefill_tokens += int(valid[i])
            if self.spec:
                self._tlen[i] += int(valid[i])
                self._dlen[i] += int(valid[i])
            if counts is not None:
                self._prefill_counts[i] += counts[i]
            if not st.prefilling:          # prompt fully consumed this chunk
                self.n_prefills += 1
                tot = self._prefill_counts[i].sum()
                if tot > 0:
                    self.occupancy[i] = self._prefill_counts[i] / tot
                st.total_len = len(st.request.prompt)
                st.first_token_time = self.now()
                self._record_token(st, self._sample(st, logits[i]))

    def _live(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.done and not s.prefilling]

    def _decode_done(self, t0: float) -> None:
        t1 = time.monotonic()
        self.decode_lat.append(t1 - t0)
        if self._last_decode_end is not None:
            self.decode_interval_s.append(t1 - self._last_decode_end)
        self._last_decode_end = t1
        self.n_steps += 1

    def _decode(self) -> None:
        """One ``(num_slots, 1)`` decode step.  Only live rows write and
        advance their caches (mid-prefill rows must not take the filler
        token); the validity mask keeps phantom rows out of the FFF
        telemetry."""
        live = self._live()
        if not live:
            return
        S = self.ecfg.num_slots
        toks = self._free_tok[:, None].copy()
        for i in live:
            toks[i, 0] = self.slots[i].tokens[-1]
        lv = np.zeros((S,), bool)
        lv[live] = True
        t0 = time.monotonic()
        t, m = self._dev(toks), self._dev(lv)
        self._record_shape("decode", t.shape)
        with self._ctx():
            logits, self.caches, stats = lm.decode_step(
                self.params, self.cfg, t, self.caches, write_mask=m,
                token_valid=m, with_stats=True)
            sv = self._reduce_stats(stats)
            host = _to_host([logits] + ([sv] if sv is not None else []))
        logits = host[0]
        self._decode_done(t0)
        if sv is not None:
            self._update_occupancy(live, self._fold_stats(host[1], "decode"))
        for i in live:
            self._record_token(self.slots[i], self._sample(self.slots[i],
                                                           logits[i]))

    def _spec_round(self) -> None:
        """One speculative round (``spec.spec_round``) in place of
        ``_decode``, then host rejection sampling: each live slot emits 1 ..
        spec_k + 1 tokens, and its cache lengths are set to what survived
        (applied by the next round's rollback)."""
        live = self._live()
        if not live:
            return
        S, k, L = self.ecfg.num_slots, self.ecfg.spec_k, self.ecfg.max_len
        toks = self._free_tok[:, None].copy()
        pos0 = np.zeros((S,), np.int32)
        temps = np.zeros((S,), np.float32)
        lv = np.zeros((S,), bool)
        vlen = np.zeros((S,), np.int32)
        for i in live:
            st = self.slots[i]
            toks[i, 0] = st.tokens[-1]
            pos0[i] = st.total_len - 1       # position of the pending token
            temps[i] = max(st.request.temperature, 0.0)
            lv[i] = True
            vlen[i] = min(k + 1, L - int(pos0[i]))
        # draft step j appends at pos0 + j; rows at the cache edge stop
        # writing (their later drafts go unverified: vlen clips identically)
        wm = lv[None, :] & ((pos0[None, :] + np.arange(k + 1)[:, None]) < L)
        t0 = time.monotonic()
        tok0 = self._dev(toks)
        self._record_shape("draft", tok0.shape)
        with self._ctx():
            (drafts, q_logits, p_logits, self.caches, self.draft_caches,
             dstats, vstats) = spec_lib.spec_round(
                self.params, self.cfg, self.draft_params, self.draft_cfg,
                tok0, self.caches, self.draft_caches, self._dev(self._tlen),
                self._dev(self._dlen), self._dev(wm), self._dev(vlen),
                self._dev(lv), self._dev(temps) if temps.any() else None,
                self._gen, verify_cf=self._verify_cf())
            self._record_shape("verify", p_logits.shape[:2])
            dv, vv = self._reduce_stats(dstats), self._reduce_stats(vstats)
            host = _to_host(
                [p_logits, drafts]                     # (S, k+1, V), (k, S)
                + ([q_logits] if temps.any() else [])  # (k+1, S, V)
                + [p for p in (dv, vv) if p is not None])
        p_logits, drafts = host[0], host[1].astype(np.int64)
        q_logits = host[2] if temps.any() else None
        host = host[3 if temps.any() else 2:]
        self._decode_done(t0)
        # the draft's histograms are a prior on the verify's routing; the
        # verify is the target's decode
        if dv is not None:
            self._update_occupancy(live, self._fold_stats(host.pop(0), "draft"))
        if vv is not None:
            self._update_occupancy(live, self._fold_stats(host.pop(0), "decode"))
        for i in live:
            st = self.slots[i]
            vl = int(vlen[i])
            m = vl - 1                        # drafts actually verified
            rng = None
            if st.request.temperature > 0.0:
                # a 4-tuple stream: disjoint from the plain sampler's 3-tuples
                rng = np.random.default_rng(
                    (self.ecfg.seed, st.request.rid, len(st.tokens), 2))
            emitted, n_acc = spec_lib.rejection_sample(
                p_logits[i, :vl],
                None if q_logits is None else q_logits[:m, i],
                drafts[:m, i], st.request.temperature, rng)
            st.n_drafted += m
            st.n_accepted += n_acc
            self.n_draft_tokens += m
            self.n_accepted_tokens += n_acc
            n_emitted = 0
            for tok in emitted:
                self._record_token(st, int(tok))
                n_emitted += 1
                if st.done:   # EOS or length mid-run: later tokens never exist
                    break
            self._tlen[i] = self._dlen[i] = int(pos0[i]) + n_emitted

    def step(self) -> None:
        """One engine iteration: evict finished slots, admit, advance
        chunked prefills (up to ``prefill_budget`` slabs), then one decode
        step or speculative round for every live slot."""
        for i, st in enumerate(self.slots):
            if st is not None and st.done:
                self.release_slot(i)
        self._admit()
        if self.ecfg.prefill_chunk:
            for _ in range(self.ecfg.prefill_budget):
                self._chunk_prefill()
        if self.spec:
            self._spec_round()
        else:
            self._decode()

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def run(self, requests: Sequence[Request]
            ) -> Tuple[List[RequestResult], metrics_lib.EngineMetrics]:
        """Serve ``requests`` (``arrival_time`` = offsets from this call's
        start, seconds) to completion; returns (results sorted by rid,
        metrics of this call alone).  Re-entrant: a later call is a warm
        engine serving a new wave."""
        for r in requests:            # fail fast, before serving anything
            self.validate(r)
        if len({r.rid for r in requests}) != len(requests):
            raise ValueError("duplicate rids in the request batch")
        pending = deque(sorted(requests,
                               key=lambda r: (r.arrival_time, r.rid)))
        n_results0, n_steps0 = len(self.results), self.n_steps
        n_prefills0, n_lat0 = self.n_prefills, len(self.decode_lat)
        n_chunks0, n_int0 = self.n_chunks, len(self.decode_interval_s)
        hints0 = self._hint_mismatches
        draft0, acc0 = self.n_draft_tokens, self.n_accepted_tokens
        ptoks0 = self.n_prefill_tokens
        ovf0 = {k: list(v) for k, v in self._overflow.items()}
        t_start = self.now()
        self._last_decode_end = None    # decode gaps don't span runs
        while pending or self.has_work():
            while pending and t_start + pending[0].arrival_time <= self.now():
                r = pending.popleft()
                self.submit(r, arrival_time=t_start + r.arrival_time)
            if not self.has_work():
                self._last_decode_end = None    # idle gap, not a stall
                if pending:
                    time.sleep(min(max(t_start + pending[0].arrival_time
                                       - self.now(), 0.0), 0.05))
                continue
            self.step()
        elapsed = self.now() - t_start
        results = sorted(self.results[n_results0:], key=lambda r: r.rid)
        del self.results[n_results0:]
        lat = self.decode_lat[n_lat0:]
        del self.decode_lat[n_lat0:]
        intervals = self.decode_interval_s[n_int0:]
        del self.decode_interval_s[n_int0:]

        def ovf_delta(keys):
            w = sum(self._overflow[k][0] - ovf0[k][0] for k in keys)
            n = sum(self._overflow[k][1] - ovf0[k][1] for k in keys)
            return w / n if n else 0.0

        repairs, m_frac = self._repair_counters(ovf0)
        m = metrics_lib.from_results(
            results, elapsed_s=elapsed, n_steps=self.n_steps - n_steps0,
            n_prefills=self.n_prefills - n_prefills0, decode_lat_s=lat,
            overflow_mean=ovf_delta(list(self._overflow)),
            overflow_decode_mean=ovf_delta(["decode"]),
            overflow_repairs=repairs, master_leaf_fraction=m_frac,
            n_chunks=self.n_chunks - n_chunks0, decode_interval_s=intervals,
            hint_mismatches=self._hint_mismatches - hints0,
            draft_tokens=self.n_draft_tokens - draft0,
            accepted_tokens=self.n_accepted_tokens - acc0,
            prefill_tokens=self.n_prefill_tokens - ptoks0)
        return results, m

    def poll_metrics(self) -> metrics_lib.EngineMetrics:
        """Live telemetry since construction (or since ``run`` last drained
        its slice), plus instantaneous queue depth, active and prefilling
        slots.  Host only: no device work."""
        repairs, m_frac = self._repair_counters()
        m = metrics_lib.from_results(
            self.results, elapsed_s=self.now(), n_steps=self.n_steps,
            n_prefills=self.n_prefills, decode_lat_s=self.decode_lat,
            overflow_mean=self.overflow_mean(),
            overflow_decode_mean=self.overflow_mean("decode"),
            overflow_repairs=repairs, master_leaf_fraction=m_frac,
            n_chunks=self.n_chunks, decode_interval_s=self.decode_interval_s,
            hint_mismatches=self._hint_mismatches,
            draft_tokens=self.n_draft_tokens,
            accepted_tokens=self.n_accepted_tokens,
            prefill_tokens=self.n_prefill_tokens)
        m.queue_depth = len(self.queue)
        m.active_slots = sum(s is not None for s in self.slots)
        m.prefilling_slots = sum(s is not None and s.prefilling
                                 for s in self.slots)
        return m

    def dispatch_shapes(self) -> Dict[str, Set[tuple]]:
        """The distinct token-slab shapes each dispatch has seen (the
        counterpart of JAX's ``compiled_shapes()``).  The fixed-shape
        contract: ``decode`` and ``draft`` exactly {(num_slots, 1)},
        ``verify`` exactly {(num_slots, spec_k + 1)}, ``chunk`` exactly
        {(num_slots, prefill_chunk)}, and ``prefill_<b>`` {(num_slots, b)}
        for each bucket used."""
        return {k: set(v) for k, v in self._shapes.items()}
