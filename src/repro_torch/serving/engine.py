"""Continuous-batching serving engine (port of ``repro/serving/engine.py``).

* KV state lives on one explicit device (``EngineConfig.device``, CUDA by
  default).  With ``page_size`` 0 every slot owns one ``max_len`` row (the
  contiguous layout); with ``page_size > 0`` the cache is a pool of fixed
  pages indexed through per-slot page tables.  A host-side allocator and
  radix prefix index (``serving/paging.py``) own the mapping; admission
  installs a slot's table and shared-prefix length in one batched call
  (``lm.cache_admit``), and eviction is refcount bookkeeping on the host.
* Prefix sharing: a prompt whose leading full pages are already cached
  maps them read-only (refcounted, shared across slots) and prefills only
  its novel suffix.  A prompt covered entirely by shared pages copies its
  last matched page (copy-on-write) so its final token re-prefills
  privately: first-token logits need it, and shared pages are never
  written.  A prompt's pages are published for sharing only when its
  prefill completes.  A request whose pages the pool cannot fund, even
  after reclaiming LRU index entries, stays queued.
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

Every dispatch runs at a fixed shape: ``dispatch_shapes()`` records the
shapes each dispatch saw.  As the JAX engine compiles each dispatch once
per shape with ``jax.jit``, the port captures each once per shape as a CUDA
graph and replays it (``serving/graphs.py``): the decode step, the whole
speculative round (the rollback, the ``spec_k + 1`` draft steps with
on-device sampling, the verify), each prefill bucket's slab
(``prefill_<b>``), the chunk slab (``prefill_chunk``), admission
(``admit``: ``lm.cache_admit`` into both trees under speculation) and a
cluster decode worker's ``install`` of a handoff; inputs
staged in pinned and static buffers, cache leaves settled back into the
engine's canonical tensors inside the capture, one host copy of the
outputs a dispatch.  ``compiled_shapes()`` counts the captured graphs
under JAX's names as JAX counts traces.  Only what cannot synchronize
with the host is captured (``graphs.eager_reason``: an installed process
group keeps a dispatch eager); an eager dispatch settles its results into
the same canonical tensors.  A MoE site runs the grouped GEMMs at shapes
the slab fixes (``core/moe.forward_sparse``), so it is captured too.  On
the card the FFF sites resolve per shape (``core/api.py``): decode and
draft steps to the fused decode kernel, slabs of at most 32 tokens (the
verify slab at 8 slots and ``spec_k`` 3) to the gathered kernels, larger
slabs to the grouped GEMMs, whose over-capacity tokens take an overflow
pass sized by the slab's shape.

Admission policy is pluggable (``serving/scheduler.py``); ``leaf_aware``
reads the per-slot FFF leaf occupancy the engine collects through
``api.collect_routing``, reduced on the device and copied to the host
with the dispatch's logits in one transfer, and ``weighted_leaf_aware``
adds weighted-fair admission across ``Request.tenant`` classes (the queue
keeps per-tenant FIFO views, ``TenantQueues``).  Finished requests fold
their measured leaf occupancy into a per-tenant ``RoutingProfileStore``
(``serving/profiles.py``), the prior for the tenant's hint-less requests.
Sampling is host numpy, deterministic under ``EngineConfig.seed``; the
draft samples on the device from a seeded ``torch.Generator``.
``capacity_factor`` and ``overflow_policy`` steer the live FFF dispatch
(``api.overrides``) of capacity-bounded backends (``grouped``,
``grouped_ep``); the scheduler's overflow proxy and the overflow-policy
metrics read the same values.  ``cuda_decode`` steers decode and draft
steps to the fused decode kernel.  The engine clock is injectable
(``clock=``, e.g. a ``VirtualClock``).  The disaggregated cluster
(``repro_torch.cluster``) drives one engine per worker through
``release_slot(i, record_result=False)``, ``_evict_finished``,
``occupancy_snapshot`` and ``compiled_shapes``, and installs handed-off
KV pages with ``lm.cache_install`` through ``_dispatch`` (``install``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import api
from repro_torch.distributed import act as dist_act
from repro_torch.models import lm
from repro_torch.nn import mlp as mlp_lib
from repro_torch.serving import graphs
from repro_torch.serving import metrics as metrics_lib
from repro_torch.serving import paging
from repro_torch.serving import spec as spec_lib
from repro_torch.serving.profiles import RoutingProfileStore
from repro_torch.serving.request import Request, RequestResult, SlotState
from repro_torch.serving.scheduler import Scheduler, SchedulerView, make_scheduler

#: the one host copy of a dispatch's outputs (``graphs.to_host``)
_to_host = graphs.to_host


class TenantQueues:
    """The engine's waiting queue: arrival order globally, FIFO per tenant.

    Schedulers receive the arrival-ordered view (``list(queue)``); the
    weighted scheduler groups it by tenant, and ``poll_metrics`` reads the
    ``per_tenant`` depths.  ``remove`` is by identity (``Request`` is
    ``eq=False``)."""

    def __init__(self):
        self._order: List[Request] = []
        self.per_tenant: Dict[str, deque] = {}

    def append(self, req: Request) -> None:
        self._order.append(req)
        self.per_tenant.setdefault(req.tenant, deque()).append(req)

    def remove(self, req: Request) -> None:
        self._order.remove(req)
        q = self.per_tenant[req.tenant]
        q.remove(req)
        if not q:
            del self.per_tenant[req.tenant]

    def depth(self, tenant: str) -> int:
        return len(self.per_tenant.get(tenant, ()))

    def __len__(self):
        return len(self._order)

    def __bool__(self):
        return bool(self._order)

    def __iter__(self):
        return iter(self._order)


class VirtualClock:
    """A deterministic engine clock for tests: reading it never blocks and
    time moves only when told (``advance``).  Passed as
    ``ContinuousBatchingEngine(..., clock=vc)``, it makes the engine jump to
    the next pending arrival instead of sleeping when idle."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock by {dt}")
        self._t += float(dt)
        return self._t


def _pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


@dataclasses.dataclass
class EngineConfig:
    """Engine shape and policy knobs.  ``max_len`` bounds prompt +
    generation per slot; monolithic prefill pads a prompt to the static
    set of slab widths ``buckets()``: ``prefill_buckets`` when given (the
    largest must be ``max_prompt_len``), else powers of two from 16 up to
    ``max_prompt_len``.  ``telemetry`` collects the FFF sites' routing
    histograms, which fold into each slot's leaf occupancy with weight
    ``occupancy_ewma`` for the newest.

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
    (``api.default_overflow_policy``).  ``cuda_decode`` steers the decode
    step and the draft steps (not the slabs) to the fused decode kernel
    (the JAX config's ``pallas_decode``).  ``scheduler_kw`` goes to the
    scheduler's constructor (``weights``, ``max_prefilling``, ...).

    Paged KV cache: ``page_size`` 0 = one ``max_len`` row per slot (the
    contiguous layout; no prompt ever fills a page, so nothing is shared);
    ``page_size > 0`` carves a pool of ``num_pages`` pages (0 = ``num_slots
    * ceil(max_len / page_size)``, the contiguous footprint) shared through
    page tables.  ``prefix_sharing`` gates page reuse across requests.
    Routing profiles: with ``learn_profiles`` each finished request's
    measured occupancy updates its tenant's profile (``profile_ewma``;
    served after ``profile_min_updates`` requests; at most
    ``profile_max_tenants`` tenants, LRU)."""
    num_slots: int = 8
    max_len: int = 128
    max_prompt_len: int = 64
    prefill_buckets: Tuple[int, ...] = ()
    max_prefills_per_step: int = 2
    prefill_chunk: int = 0
    prefill_budget: int = 1
    scheduler: str = "fcfs"
    scheduler_kw: dict = dataclasses.field(default_factory=dict)
    fff_backend: str = "auto"
    cuda_decode: bool = False
    capacity_factor: Optional[float] = None
    overflow_policy: Optional[str] = None
    telemetry: bool = True
    occupancy_ewma: float = 0.5
    learn_profiles: bool = True
    profile_ewma: float = 0.3
    profile_min_updates: int = 1
    spec_k: int = 0
    draft_config: Optional[str] = None
    page_size: int = 0
    num_pages: int = 0
    prefix_sharing: bool = True
    profile_max_tenants: int = 1024
    seed: int = 0
    device: str = "cuda"

    def buckets(self) -> Tuple[int, ...]:
        if self.prefill_buckets:
            return tuple(sorted(set(self.prefill_buckets)))
        return _pow2_buckets(min(16, self.max_prompt_len), self.max_prompt_len)


class ContinuousBatchingEngine:
    """Continuous-batching serving loop (module docstring has the design).

    Args:
        params:    the LM parameters (``lm.init``), on ``ecfg.device``.
        cfg:       the ``ModelConfig``: a decoder-only attention stack.
        ecfg:      shape and policy knobs (``EngineConfig``).
        scheduler: an admission ``Scheduler``; default built from
                   ``ecfg.scheduler`` and ``ecfg.scheduler_kw``.
        clock:     the engine clock (seconds; default ``time.monotonic``),
                   e.g. a ``VirtualClock``.
        draft:     ``(draft_params, draft_cfg)`` for speculative decoding in
                   place of ``ecfg.draft_config`` (a cluster worker passes
                   the draft it rebuilt from its seed).

    Drive it with ``run(requests)`` (serve to completion; returns results
    and ``EngineMetrics``) or by hand: ``submit``, then ``step()`` while
    ``has_work()``, reading ``poll_metrics()`` for live telemetry."""

    def __init__(self, params, cfg, ecfg: EngineConfig,
                 scheduler: Optional[Scheduler] = None,
                 clock: Optional[Callable[[], float]] = None,
                 draft: Optional[Tuple[dict, object]] = None):
        if cfg.encoder is not None or cfg.frontend != "none":
            raise ValueError("serving engine supports decoder-only token LMs")
        if cfg.pos_emb not in ("rope", "none"):
            # its slabs and decode steps take positions from the cache
            # lengths, which only RoPE reads (the JAX engine passes offsets)
            raise ValueError(f"the port's serving engine takes positions from "
                             f"the cache lengths (RoPE); pos_emb "
                             f"{cfg.pos_emb!r} serves through the fixed-batch loop")
        if any(b.mixer != "attn" for b in cfg.period):
            # recurrent mixers fold right-pad garbage into their state
            raise ValueError("serving engine requires attention mixers "
                             "(padded prefill is length-masked, recurrent "
                             "state is not)")
        if ecfg.max_prompt_len >= ecfg.max_len:
            raise ValueError("max_prompt_len must leave room to generate "
                             "(max_prompt_len < max_len)")
        if ecfg.buckets()[-1] != ecfg.max_prompt_len:
            raise ValueError(
                f"prefill_buckets {ecfg.buckets()} must top out at "
                f"max_prompt_len {ecfg.max_prompt_len} — the two knobs "
                f"would otherwise disagree on the servable prompt length")
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
        if ecfg.page_size < 0 or ecfg.page_size > ecfg.max_len:
            raise ValueError(f"page_size {ecfg.page_size} must be in "
                             f"[0, max_len {ecfg.max_len}]")
        page = ecfg.page_size or ecfg.max_len
        ppr = utils.cdiv(ecfg.max_len, page)       # pages per slot, at most
        if ecfg.num_pages and ecfg.num_pages < ppr:
            raise ValueError(
                f"num_pages {ecfg.num_pages} cannot cover even one "
                f"max-length slot ({ppr} pages of {page} tokens)")
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
        self.scheduler = scheduler or make_scheduler(ecfg.scheduler,
                                                     **ecfg.scheduler_kw)
        S, L = ecfg.num_slots, ecfg.max_len
        # the page pool: the host allocator and prefix index own the
        # mapping; the device tables start unmapped (prealloc=False).  With
        # page_size 0 the device rows stay contiguous and the pool (one
        # max_len page per admission) only accounts for them.
        self._page, self._ppr = page, ppr
        self._num_pages = ecfg.num_pages or S * ppr
        self.pool = paging.PagePool(self._num_pages, page)
        self.prefix = paging.PrefixIndex(self.pool)
        self._slot_pages: List[list] = [[] for _ in range(S)]
        self._alloc_len = np.zeros((S,), np.int32)   # pages * page_size
        self.n_prefix_hit_tokens = 0
        self.n_cow_copies = 0
        self._cache_kw = (dict(page_size=page, num_pages=self._num_pages,
                               prealloc=False) if ecfg.page_size else {})
        self.caches = lm.init_caches(cfg, S, L, device=self.device,
                                     **self._cache_kw)
        # speculative decoding: the draft's cache rows live alongside the
        # target's, slot for slot, on the same page geometry and tables
        # (a token's draft K/V is as deterministic as its target K/V, so
        # shared prompt pages hold for both trees).  _tlen/_dlen are the host-authoritative
        # cache lengths: verify appends k+1 positions optimistically, host
        # rejection decides how many survive, and the next round's rollout
        # rolls both trees back to them.
        self.spec = ecfg.spec_k > 0
        self.draft_params = self.draft_cfg = self.draft_caches = None
        if self.spec:
            self.draft_params, self.draft_cfg = draft or spec_lib.build_draft(
                ecfg.draft_config, params, cfg, seed=ecfg.seed)
            dcfg = self.draft_cfg
            if any(b.mixer != "attn" for b in dcfg.period):
                raise ValueError("draft model requires attention mixers "
                                 "(same pooled-cache contract as the target)")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: rejection sampling compares the two "
                    f"distributions token-for-token")
            if dcfg.pos_emb not in ("rope", "none"):
                raise ValueError(f"the draft's pos_emb {dcfg.pos_emb!r}: the "
                                 f"engine takes positions from the cache "
                                 f"lengths (RoPE)")
            self.draft_caches = lm.init_caches(self.draft_cfg, S, L,
                                               device=self.device,
                                               **self._cache_kw)
            self._tlen = np.zeros((S,), np.int32)
            self._dlen = np.zeros((S,), np.int32)
            self._gen = torch.Generator(device=self.device).manual_seed(
                ecfg.seed)
        self.n_draft_tokens = 0
        self.n_accepted_tokens = 0
        self.slots: List[Optional[SlotState]] = [None] * S
        self.queue = TenantQueues()
        self.results: List[RequestResult] = []
        self.occupancy = np.zeros((S, max(self.num_leaves, 1)), np.float64)
        # whether a slot's occupancy row holds measured telemetry rather
        # than a seeded hint or profile: only measured rows update the
        # profile store, which would otherwise learn its own output
        self._measured = np.zeros((S,), bool)
        self.profiles: Optional[RoutingProfileStore] = (
            RoutingProfileStore(self.num_leaves, ewma=ecfg.profile_ewma,
                                min_updates=ecfg.profile_min_updates,
                                max_tenants=ecfg.profile_max_tenants)
            if ecfg.learn_profiles and self.num_leaves else None)
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
        # the decode step's and the spec round's graphs, one per key
        self._graphs = graphs.DispatchCache(self.device)
        self._eager: Dict[tuple, Optional[str]] = {}
        self._clock: Callable[[], float] = clock or time.monotonic
        self._t0 = self._clock()
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
        return self._clock() - self._t0

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
                warnings.warn(f"request {req.rid} (tenant {req.tenant!r}): "
                              f"unusable leaf_hint (size {h.size}, "
                              f"{self.num_leaves} leaves, or zero mass); "
                              f"ignoring it", stacklevel=2)
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

    def _ctx(self, decode: bool = False):
        """The context of a dispatch; ``decode`` adds the ``cuda_decode``
        steer for the one-token decode step."""
        es = contextlib.ExitStack()
        es.enter_context(torch.inference_mode())
        kw = self._overrides()
        if kw:
            es.enter_context(api.overrides(**kw))
        if decode and self.ecfg.cuda_decode:
            es.enter_context(api.overrides(backend="cuda_decode", mode="infer"))
        if self.ecfg.telemetry:
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
        return graphs.upload(a, self.device)

    def _record_shape(self, name: str, shape) -> None:
        self._shapes.setdefault(name, set()).add(tuple(shape))

    def _slab(self, name: str, toks: np.ndarray, valid: np.ndarray):
        """One prefill slab, ``prefill_<b>`` or ``prefill_chunk``, through
        the target (and the draft under spec) as a dispatch (``_dispatch``):
        returns (logits (S, V), the target's per-row leaf counts (S, E) or
        None), both on the host after one copy."""
        self._record_shape("chunk" if name == "prefill_chunk" else name,
                           toks.shape)
        host = self._dispatch(name, self._slab_dispatch,
                              {"tokens": toks, "valid": valid}, toks.shape)
        counts = (self._fold_stats(host["stats"], "prefill")
                  if "stats" in host else None)
        if "dstats" in host:
            self._fold_stats(host["dstats"], "draft")
        return host["logits"], counts

    def _slab_dispatch(self, inp: dict) -> dict:
        """A prefill slab on device inputs, both trees' cache leaves settled
        into the canonical tensors under spec: what a ``prefill_<b>`` or
        ``prefill_chunk`` graph holds."""
        dstats = None
        with self._ctx():
            if self.spec:
                logits, caches, dcaches, stats, dstats = spec_lib.chunk_both(
                    self.params, self.cfg, self.draft_params, self.draft_cfg,
                    inp["tokens"], inp["valid"], self.caches, self.draft_caches)
                graphs.settle(self.draft_caches, dcaches)
            else:
                logits, caches, stats = lm.prefill_chunk(
                    self.params, self.cfg, inp["tokens"], inp["valid"],
                    self.caches)
            graphs.settle(self.caches, caches)
            return {"logits": logits, "stats": self._reduce_stats(stats),
                    "dstats": self._reduce_stats(dstats)}

    def _eager_reason(self, name: str, ctx: tuple, width: int
                      ) -> Optional[str]:
        """Why dispatch ``name`` runs eagerly, or None when it is captured
        (``graphs.eager_reason``, read under the dispatch's context): the
        decode step at one token a row, the spec round's draft steps under
        their ``cuda_decode`` steer and then its verify slab, a prefill slab
        of ``width`` tokens a row through the draft (under spec) and the
        target.  ``admit`` and a cluster worker's ``install`` run no model
        and are always captured.  Cached per (name, width, context)."""
        key = (name, width, ctx, dist_act.mesh_installed())
        if key not in self._eager:
            S, why = self.ecfg.num_slots, None
            if name == "decode":
                why = graphs.eager_reason(self.params, self.cfg, S, 1)
            elif name == "spec_round":
                with (api.overrides(backend="cuda_decode", mode="infer")
                      if self.ecfg.cuda_decode else contextlib.nullcontext()):
                    why = graphs.eager_reason(self.draft_params,
                                              self.draft_cfg, S, 1)
                why = (f"the draft: {why}" if why else graphs.eager_reason(
                    self.params, self.cfg, S, width))
            elif name not in ("admit", "install"):
                if self.spec:
                    why = graphs.eager_reason(self.draft_params,
                                              self.draft_cfg, S, width)
                    why = why and f"the draft: {why}"
                why = why or graphs.eager_reason(self.params, self.cfg, S,
                                                 width)
            self._eager[key] = why
        return self._eager[key]

    def _dispatch(self, name: str, fn, inputs: dict, shape: tuple, *,
                  decode: bool = False, sampling: bool = False
                  ) -> Dict[str, np.ndarray]:
        """Dispatch ``name`` through the graph cache, keyed by (shape,
        sampling, the ``api`` context it runs under): captured once and
        replayed, or eager by the capture rule.  Its outputs come to the
        host in one copy, after the replay (a dispatch with none, such as
        ``admit``, does not wait for the device)."""
        with self._ctx(decode=decode):
            ctx = graphs.context_key()
            why = self._eager_reason(name, ctx, shape[-1])
        out = self._graphs.run(
            name, (tuple(shape), sampling, ctx), fn, inputs, eager=why,
            generators=(self._gen,) if sampling else ())
        return _to_host(out) if out else {}

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
        match = [s.leaf_counts for s in sites
                 if s.leaf_counts.shape[-1] == self.num_leaves]
        # a registry draft's sites may have another leaf count: they fold
        # their overflow, and count on no leaf (zero rows fold as no data)
        counts = (torch.stack(match).sum(0) if match else torch.zeros(
            sites[0].leaf_counts.shape[:-1] + (self.num_leaves,),
            device=sites[0].leaf_counts.device))
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
                          counts: Optional[np.ndarray],
                          measured: bool = True) -> None:
        """Fold per-row leaf counts into the occupancy EWMA.  ``measured``
        False (the draft's histograms, a prior on the verify's routing)
        refines the footprint the schedulers read without making the row
        eligible to update the profile store."""
        if counts is None:
            return
        a = self.ecfg.occupancy_ewma
        for r in rows:
            tot = counts[r].sum()
            if tot <= 0:
                continue
            if measured:
                self._measured[r] = True
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

    def _evict_finished(self) -> None:
        """Release every slot whose request is done, recording its result."""
        for i, st in enumerate(self.slots):
            if st is not None and st.done:
                self.release_slot(i)

    def release_slot(self, i: int, record_result: bool = True) -> None:
        """Free slot ``i``: its pages' refcounts drop (pages nobody else
        holds, neither a slot nor the prefix index, go back to the free
        list), and its measured footprint updates its tenant's routing
        profile.  ``record_result`` False is the cluster's handoff path
        (``cluster/handoff.py``): a prefill worker that shipped the slot's
        KV pages releases it without minting a ``RequestResult``, since the
        decode worker now owns the request.  No device work: the slot's
        stale table and length are masked out of every later write and
        replaced at admission."""
        st = self.slots[i]
        if st is None:
            return
        self.pool.decref(self._slot_pages[i])
        self._slot_pages[i] = []
        self._alloc_len[i] = 0
        if self.profiles is not None and self._measured[i] and \
                self.occupancy[i].any():
            self.profiles.update(st.request.tenant, self.occupancy[i])
        self.occupancy[i] = 0.0
        self._measured[i] = False
        self._prefill_counts[i] = 0.0
        if self.spec:
            self._tlen[i] = self._dlen[i] = 0
        spread = [t for t in st.tokens if t != st.request.eos_id]
        self._free_tok[i] = (spread[-1] if spread
                             else int(st.request.prompt[-1]))
        self._live_rids.discard(st.request.rid)
        arrival = self._arrivals.pop(id(st.request), st.admitted_time)
        if record_result:
            self.results.append(RequestResult(
                rid=st.request.rid, prompt=st.request.prompt,
                tokens=np.asarray(st.tokens, np.int32),
                finish_reason=st.finish_reason, arrival_time=arrival,
                admitted_time=st.admitted_time,
                first_token_time=st.first_token_time,
                finish_time=st.finish_time, tenant=st.request.tenant,
                n_drafted=st.n_drafted, n_accepted=st.n_accepted))
        self.slots[i] = None

    def _seed_hint(self, slot: int, req: Request) -> None:
        """The slot's occupancy before telemetry lands: the request's usable
        ``leaf_hint``, else its tenant's learned routing profile."""
        h = req.leaf_hint
        if h is None or not self.num_leaves or h.size != self.num_leaves \
                or h.sum() <= 0:
            # the schedulers' _footprint predicate, so admission and slot
            # seeding agree on the footprint
            h = (self.profiles.lookup(req.tenant)
                 if self.profiles is not None else None)
        if h is not None and self.num_leaves and h.size == self.num_leaves \
                and h.sum() > 0:
            self.occupancy[slot] = h / h.sum()

    # -- paged admission -----------------------------------------------------

    def _plan_pages(self, req: Request) -> Optional[dict]:
        """Page plan for admitting ``req``: the longest indexed full-page
        prefix maps shared pages read-only; fresh pages cover the rest of
        ``len(prompt) + max_new_tokens``.  A prompt covered entirely copies
        its last matched page (copy-on-write) so its final token
        re-prefills privately.  None (the request stays queued) when the
        pool cannot fund the fresh pages even after reclaiming LRU index
        entries."""
        page = self._page
        L = len(req.prompt)
        n_total = utils.cdiv(L + req.max_new_tokens, page)
        matched = (self.prefix.match(req.prompt) if self.ecfg.prefix_sharing
                   else [])
        shared = min(len(matched) * page, L - 1)   # >= 1 novel token always
        n_shared = shared // page
        shared_pages = list(matched[:n_shared])
        cow_src = matched[n_shared] if shared % page else None
        n_fresh = n_total - n_shared
        # hold the mapped and copy-source pages through reclaim and alloc:
        # the reclaim must not free what this admission depends on
        self.pool.incref(shared_pages)
        if cow_src is not None:
            self.pool.incref([cow_src])
        if self.pool.pages_free < n_fresh:
            self.prefix.reclaim(n_fresh)
        fresh = self.pool.alloc(n_fresh)
        if fresh is None:
            self.pool.decref(shared_pages)
            if cow_src is not None:
                self.pool.decref([cow_src])
            return None
        return {"pages": shared_pages + fresh, "shared_len": shared,
                "cow_src": cow_src,
                "cow_dst": fresh[0] if cow_src is not None else None}

    def _apply_admit(self, slot: int, plan: dict) -> None:
        """Install the plan's page table and shared-prefix length at
        ``slot`` (``lm.cache_admit``, both trees under speculation) as the
        ``admit`` dispatch, at fixed ``(S,)`` and ``(S, pages)`` inputs;
        with ``page_size`` 0 the slot's contiguous row restarts at length
        0."""
        S, sentinel = self.ecfg.num_slots, self._num_pages
        admit = np.zeros((S,), bool)
        admit[slot] = True
        if plan["cow_src"] is not None:
            self.n_cow_copies += 1
        inputs = {"admit": admit, "tables": None, "lengths": None,
                  "cow_src": None, "cow_dst": None}
        if self.ecfg.page_size:
            tables = np.full((S, self._ppr), sentinel, np.int32)
            tables[slot, :len(plan["pages"])] = plan["pages"]
            lengths = np.zeros((S,), np.int32)
            lengths[slot] = plan["shared_len"]
            cow_src = np.full((S,), sentinel, np.int32)
            cow_dst = np.full((S,), sentinel, np.int32)
            if plan["cow_src"] is not None:
                cow_src[slot] = plan["cow_src"]
                cow_dst[slot] = plan["cow_dst"]
            inputs.update(tables=tables, lengths=lengths, cow_src=cow_src,
                          cow_dst=cow_dst)
        self._dispatch("admit", self._admit_dispatch, inputs, (S,))
        if plan["cow_src"] is not None:
            # the copy is queued on the device ahead of any later reuse of
            # the source page: drop the admission's hold
            self.pool.decref([plan["cow_src"]])
        self._slot_pages[slot] = list(plan["pages"])
        self._alloc_len[slot] = len(plan["pages"]) * self._page
        self.n_prefix_hit_tokens += plan["shared_len"]

    def _admit_dispatch(self, inp: dict) -> dict:
        """``lm.cache_admit`` on device inputs into both trees under spec,
        in one dispatch as JAX's ``_admit_jit``, settled into the canonical
        tensors: what the ``admit`` graph holds.  No outputs."""
        args = [inp[k] for k in ("admit", "tables", "lengths", "cow_src",
                                 "cow_dst") if inp[k] is not None]
        with self._ctx():
            graphs.settle(self.caches, lm.cache_admit(self.caches, *args))
            if self.spec:
                graphs.settle(self.draft_caches,
                              lm.cache_admit(self.draft_caches, *args))
        return {}

    def _publish_prefix(self, slot: int) -> None:
        """Index the slot's full prompt pages for sharing, only now that its
        prefill has completed: published at admission, a racing request
        could attend to pages not yet written."""
        if not self.ecfg.prefix_sharing:
            return
        prompt = self.slots[slot].request.prompt
        n_full = len(prompt) // self._page
        if n_full:
            self.prefix.insert(prompt, self._slot_pages[slot][:n_full])

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
            prefilling=np.asarray([s is not None and s.prefilling
                                   for s in self.slots]),
            profiles=self.profiles,
            tokens_per_slot=self.ecfg.spec_k + 1,
            pages_free=self.pool.pages_free)
        if self.ecfg.prefill_chunk:
            # monolithic admission never leaves a slot prefilling, so the
            # cap applies to chunked prefill alone
            n = min(n, self.scheduler.admission_cap(view))
        if n <= 0:
            return
        for req in self.scheduler.select(list(self.queue), n, view):
            plan = self._plan_pages(req)
            if plan is None:
                # out of pages: this and the step's later picks stay queued
                # until evictions or index reclaim free pages
                break
            self.queue.remove(req)
            slot = free.pop(0)
            self._apply_admit(slot, plan)
            if self.ecfg.prefill_chunk:
                self._admit_chunked(req, slot, plan["shared_len"])
            else:
                self._admit_monolithic(req, slot, plan["shared_len"])

    def _admit_monolithic(self, req: Request, slot: int, shared: int) -> None:
        """One ``(num_slots, bucket)`` slab prefills the prompt's novel
        suffix, from the shared-prefix boundary on; only the admitted row
        is valid.  Pad positions repeat the last real token and filler rows
        carry in-distribution tokens, so their FFF routing stays spread;
        neither writes the cache."""
        L = len(req.prompt)
        suffix = req.prompt[shared:]
        n = len(suffix)                                # >= 1 by the plan
        bucket = next(b for b in self.ecfg.buckets() if b >= n)
        toks = np.repeat(self._free_tok[:, None], bucket, axis=1)
        toks[slot, :n] = suffix
        toks[slot, n:] = suffix[-1]
        valid = np.zeros((self.ecfg.num_slots,), np.int32)
        valid[slot] = n
        logits, counts = self._slab(f"prefill_{bucket}", toks, valid)
        if self.spec:
            self._tlen[slot] = self._dlen[slot] = L
        self.n_prefills += 1
        self.n_prefill_tokens += n
        t = self.now()
        st = SlotState(request=req, admitted_time=t, first_token_time=t,
                       tokens=[], total_len=L, prefill_pos=L)
        self.slots[slot] = st
        if counts is not None and counts[slot].sum() > 0:
            self.occupancy[slot] = counts[slot] / counts[slot].sum()
            self._measured[slot] = True
        else:
            self._measured[slot] = False
            self._seed_hint(slot, req)
        self._record_token(st, self._sample(st, logits[slot]))
        self._publish_prefix(slot)

    def _admit_chunked(self, req: Request, slot: int, shared: int) -> None:
        """No model call: the prompt's novel suffix advances through the
        shared chunk slab in later ``_chunk_prefill`` dispatches, from the
        shared-prefix boundary on."""
        self.slots[slot] = SlotState(request=req, admitted_time=self.now(),
                                     first_token_time=0.0, tokens=[],
                                     total_len=0, prefill_pos=shared)
        if self.spec:
            self._tlen[slot] = self._dlen[slot] = shared
        self._prefill_counts[slot] = 0.0
        self._measured[slot] = False
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
        logits, counts = self._slab("prefill_chunk", toks, valid)
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
                    self._measured[i] = True
                st.total_len = len(st.request.prompt)
                st.first_token_time = self.now()
                self._record_token(st, self._sample(st, logits[i]))
                self._publish_prefix(i)

    def _live(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.done and not s.prefilling]

    def _decode_done(self, t0: float) -> None:
        t1 = self._clock()
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
        t0 = self._clock()
        self._record_shape("decode", toks.shape)
        host = self._dispatch("decode", self._decode_dispatch,
                              {"tokens": toks, "live": lv}, toks.shape,
                              decode=True)
        logits = host["logits"]
        self._decode_done(t0)
        if "stats" in host:
            self._update_occupancy(live, self._fold_stats(host["stats"],
                                                          "decode"))
        for i in live:
            self._record_token(self.slots[i], self._sample(self.slots[i],
                                                           logits[i]))

    def _decode_dispatch(self, inp: dict) -> dict:
        """The decode step on device inputs, its cache leaves settled into
        the canonical tensors: what the decode graph holds."""
        with self._ctx(decode=True):
            logits, caches, stats = lm.decode_step(
                self.params, self.cfg, inp["tokens"], self.caches,
                write_mask=inp["live"], token_valid=inp["live"],
                with_stats=True)
            graphs.settle(self.caches, caches)
            return {"logits": logits, "stats": self._reduce_stats(stats)}

    def _spec_dispatch(self, inp: dict) -> dict:
        """The whole speculative round on device inputs (``spec_round``),
        both trees' cache leaves settled into the canonical tensors: what
        the round's graph holds."""
        with self._ctx():
            (drafts, q_logits, p_logits, caches, dcaches, dstats,
             vstats) = spec_lib.spec_round(
                self.params, self.cfg, self.draft_params, self.draft_cfg,
                inp["tok0"], self.caches, self.draft_caches, inp["tlen"],
                inp["dlen"], inp["wm"], inp["vlen"], inp["live"],
                inp["temps"], self._gen, verify_cf=self._verify_cf(),
                draft_backend="cuda_decode" if self.ecfg.cuda_decode else None)
            graphs.settle(self.caches, caches)
            graphs.settle(self.draft_caches, dcaches)
            return {"p_logits": p_logits,                       # (S, k+1, V)
                    "drafts": drafts,                           # (k, S)
                    "q_logits": (q_logits if inp["temps"] is not None
                                 else None),                    # (k+1, S, V)
                    "dstats": self._reduce_stats(dstats),
                    "vstats": self._reduce_stats(vstats)}

    def _spec_round(self) -> None:
        """One speculative round (``spec.spec_round``) in place of
        ``_decode``, then host rejection sampling: each live slot emits 1 ..
        spec_k + 1 tokens, and its cache lengths are set to what survived
        (applied by the next round's rollback)."""
        live = self._live()
        if not live:
            return
        S, k = self.ecfg.num_slots, self.ecfg.spec_k
        alloc = self._alloc_len
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
            # the row's writable horizon is its allocated pages (>= prompt
            # + max_new by the admission plan), not max_len
            vlen[i] = min(k + 1, int(alloc[i]) - int(pos0[i]))
        # draft step j appends at pos0 + j; rows at their allocation's edge
        # stop writing (their later drafts go unverified: vlen clips
        # identically)
        wm = lv[None, :] & ((pos0[None, :] + np.arange(k + 1)[:, None])
                            < alloc[None, :])
        t0 = self._clock()
        self._record_shape("draft", toks.shape)
        self._record_shape("verify", (S, k + 1))
        sampling = bool(temps.any())
        host = self._dispatch(
            "spec_round", self._spec_dispatch,
            {"tok0": toks, "tlen": self._tlen, "dlen": self._dlen, "wm": wm,
             "vlen": vlen, "live": lv, "temps": temps if sampling else None},
            (S, k + 1), sampling=sampling)
        p_logits, drafts = host["p_logits"], host["drafts"].astype(np.int64)
        q_logits = host.get("q_logits")
        self._decode_done(t0)
        # the draft's histograms are a prior on the verify's routing; the
        # verify is the target's decode
        if "dstats" in host:
            self._update_occupancy(live, self._fold_stats(host["dstats"],
                                                          "draft"),
                                   measured=False)
        if "vstats" in host:
            self._update_occupancy(live, self._fold_stats(host["vstats"],
                                                          "decode"))
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
        self._evict_finished()
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
        phit0, cow0 = self.n_prefix_hit_tokens, self.n_cow_copies
        ovf0 = {k: list(v) for k, v in self._overflow.items()}
        t_start = self.now()
        self._last_decode_end = None    # decode gaps don't span runs
        while pending or self.has_work():
            due = 0
            while due < len(pending) and \
                    t_start + pending[due].arrival_time <= self.now():
                due += 1
            # ranks serving together admit alike, whatever their clocks read
            for _ in range(dist_act.agree_min(due)):
                r = pending.popleft()
                self.submit(r, arrival_time=t_start + r.arrival_time)
            if not self.has_work():
                self._last_decode_end = None    # idle gap, not a stall
                if pending:
                    wait = max(t_start + pending[0].arrival_time - self.now(),
                               0.0)
                    advance = getattr(self._clock, "advance", None)
                    if advance is not None:
                        advance(wait)           # virtual time: jump ahead
                    else:
                        time.sleep(min(wait, 0.05))
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
            prefill_tokens=self.n_prefill_tokens - ptoks0,
            prefix_hit_tokens=self.n_prefix_hit_tokens - phit0,
            cow_copies=self.n_cow_copies - cow0,
            pages_in_use=self.pool.pages_in_use,
            pages_free=self.pool.pages_free)
        return results, m

    def poll_metrics(self) -> metrics_lib.EngineMetrics:
        """Live telemetry since construction (or since ``run`` last drained
        its slice), plus instantaneous queue depth, active and prefilling
        slots, the page pool, and each tenant's queue depth and learned
        profile.  Host only: no device work."""
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
            prefill_tokens=self.n_prefill_tokens,
            prefix_hit_tokens=self.n_prefix_hit_tokens,
            cow_copies=self.n_cow_copies,
            pages_in_use=self.pool.pages_in_use,
            pages_free=self.pool.pages_free)
        m.queue_depth = len(self.queue)
        m.active_slots = sum(s is not None for s in self.slots)
        m.prefilling_slots = sum(s is not None and s.prefilling
                                 for s in self.slots)
        # live per-tenant queue depths on top of the finished-request
        # breakdown (a tenant may have nothing finished yet)
        for t, q in self.queue.per_tenant.items():
            m.tenants.setdefault(t, {})["queue_depth"] = len(q)
        if self.profiles is not None:
            for t, snap in self.profiles.as_dict().items():
                m.tenants.setdefault(t, {})["profile"] = snap
        return m

    def occupancy_snapshot(self) -> Optional[np.ndarray]:
        """Mean leaf-occupancy EWMA over the occupied slots: the worker's
        live FFF footprint, which cluster placement reads
        (``cluster/placement.py``).  None when the model has no FFF site;
        zeros when no slot is occupied."""
        if not self.num_leaves:
            return None
        act = [i for i, s in enumerate(self.slots) if s is not None]
        if not act:
            return np.zeros((self.num_leaves,), np.float64)
        return self.occupancy[act].mean(axis=0)

    def compiled_shapes(self) -> Dict[str, int]:
        """Compiled dispatches per entry point, under the JAX engine's names,
        as JAX counts traces: ``decode``, ``spec_round``, ``prefill_<b>``
        (one per bucket used), ``prefill_chunk``, ``admit`` and a cluster
        worker's handoff ``install`` count their captured graphs (on the
        CPU, their staged dispatches; one per (shape, sampling on,
        context) key, so 1 after warm-up, 2 when a run both samples and
        does not); a dispatch that ran eagerly counts the shapes it saw
        (``dispatch_shapes()``; ``chunk`` as ``prefill_chunk``, and
        ``draft`` and ``verify`` for a spec round the capture rule or
        ``graphs.disabled()`` kept eager)."""
        out = {_JAX_NAMES.get(k, k): len(v) for k, v in self._shapes.items()}
        for name, n in self._graphs.counts().items():
            for k in _GRAPH_SHAPES.get(name, ()):
                out.pop(k, None)
            out[name] = n
        return out

    def dispatch_shapes(self) -> Dict[str, Set[tuple]]:
        """The distinct token-slab shapes each dispatch has seen, captured
        or not.  The fixed-shape contract: ``decode`` and ``draft`` exactly
        {(num_slots, 1)}, ``verify`` exactly {(num_slots, spec_k + 1)},
        ``chunk`` exactly {(num_slots, prefill_chunk)}, and ``prefill_<b>``
        {(num_slots, b)} for each bucket used."""
        return {k: set(v) for k, v in self._shapes.items()}


#: ``dispatch_shapes`` names that ``compiled_shapes`` reports under JAX's
_JAX_NAMES = {"chunk": "prefill_chunk"}
#: the dispatch shapes a graphed dispatch stands for in ``compiled_shapes``,
#: where they differ from its own name
_GRAPH_SHAPES = {"spec_round": ("draft", "verify")}
