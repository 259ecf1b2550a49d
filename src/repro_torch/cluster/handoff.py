"""KV-cache handoff between cluster workers (port of
``repro/cluster/handoff.py``).

The disaggregated tier splits prefill from decode: a prefill worker's
engine computes a prompt's KV pages, then the pages travel to the decode
worker placement picked.  This module is both ends of that wire:

* ``extract(engine, slot)``: gather the pages that hold the slot's prompt
  K/V (``ceil(prompt_len / page_size)`` of them) on the device, layer by
  layer, and copy them to the host in one transfer per cache tree (the
  target's, and the draft's under speculative decoding), then pack them
  with the request, the first sampled token and the slot's measured
  leaf-occupancy row into a ``KVHandoff``.  The caller then releases the
  slot without minting a result (``engine.release_slot(slot,
  record_result=False)``): ownership of the request moves with the
  handoff.
* ``install(engine, handoff)``: on the decode worker, fund pages for the
  whole ``prompt + max_new`` horizon from the local pool (all or nothing:
  a short pool returns None and the worker keeps the handoff queued, the
  cluster's backpressure), pad the shipped rows to the table's width
  ``ppr`` with zeros, copy them into the funded pages (the padding past
  them lands in the generation room, the sentinel entries in the sink
  page) and install table and length in one batched call
  (``lm.cache_install``), as the engine's ``install`` dispatch: one CUDA
  graph an engine, its rows staged through the entry's pinned buffer in one
  upload (``serving/graphs.py``).  Then it rebuilds the host-side
  ``SlotState`` so the engine decodes the request as if it had prefilled
  it.

Sampling is keyed by ``(seed, rid, len(tokens))`` on whichever engine
holds the slot, so a request decoded after a handoff emits the tokens one
engine serving it end to end would.

On the wire the rows are CPU tensors, one per layer, ``(n_pages,
page_size, K, hd)`` in the cache dtype (bfloat16 stays bfloat16).  A
pickled handoff carries each as its raw bytes, so a ``ProcBus`` queue
moves it through its pipe like any other message (no shared-memory
segment outlives a killed sender); a CUDA tensor is refused.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch import utils
from repro_torch.models import lm
from repro_torch.serving import graphs
from repro_torch.serving.request import Request, SlotState

_ROWS = ("k_rows", "v_rows", "draft_k_rows", "draft_v_rows")


def _pack(t: torch.Tensor) -> tuple:
    if t.device.type != "cpu":
        raise ValueError(f"a handoff ships CPU tensors, not {t.device}")
    t = t.contiguous()
    return str(t.dtype).removeprefix("torch."), t.view(torch.uint8).numpy()


def _unpack(packed: tuple) -> torch.Tensor:
    dtype, raw = packed
    return torch.from_numpy(raw).view(getattr(torch, dtype))


@dataclasses.dataclass
class KVHandoff:
    """A completed prefill, packed for the wire.

    ``k_rows[i]`` / ``v_rows[i]`` are layer i's ``(n_pages, page_size, K,
    hd)`` CPU tensors: only the pages holding prompt K/V ship (``n_pages =
    ceil(prompt_len / page_size)``).  ``draft_*`` carry the draft's cache
    tree under speculative decoding (same page geometry)."""
    request: Request
    tokens: List[int]                 # sampled at prefill completion (>= 1)
    prompt_len: int
    page_size: int
    n_pages: int
    k_rows: List[torch.Tensor]
    v_rows: List[torch.Tensor]
    draft_k_rows: Optional[List[torch.Tensor]] = None
    draft_v_rows: Optional[List[torch.Tensor]] = None
    occupancy: Optional[np.ndarray] = None   # the slot's leaf footprint row
    measured: bool = False

    @property
    def nbytes(self) -> int:
        rows = (self.k_rows + self.v_rows
                + (self.draft_k_rows or []) + (self.draft_v_rows or []))
        return int(sum(t.numel() * t.element_size() for t in rows))

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        for f in _ROWS:
            if state[f] is not None:
                state[f] = [_pack(t) for t in state[f]]
        return state

    def __setstate__(self, state: dict) -> None:
        for f in _ROWS:
            if state[f] is not None:
                state[f] = [_unpack(p) for p in state[f]]
        self.__dict__.update(state)


def _gather_rows(caches: list, idx: torch.Tensor) -> tuple:
    """Host copies of the pool pages ``idx`` names, layer by layer: one
    gather per pool on the device, one transfer for the tree."""
    parts = [t for c in caches for t in (c["kv"].k[idx], c["kv"].v[idx])]
    rows = list(torch.stack(parts).cpu().unbind(0))
    return rows[0::2], rows[1::2]


def extract(engine, slot: int) -> KVHandoff:
    """Package slot ``slot``'s completed prefill for shipment (module
    docstring).  The slot must hold a live occupant whose prefill has
    completed (>= 1 sampled token); the caller releases the slot after."""
    st = engine.slots[slot]
    if st is None or st.prefilling or not st.tokens:
        raise ValueError(f"slot {slot} has no completed prefill to extract")
    if not engine.ecfg.page_size:
        raise ValueError("the handoff moves pages: the engine needs a paged "
                         "KV cache (page_size > 0)")
    page = engine._page
    L = len(st.request.prompt)
    n_keep = utils.cdiv(L, page)        # pages that hold prompt K/V
    idx = torch.tensor(engine._slot_pages[slot][:n_keep], dtype=torch.long,
                       device=engine.device)
    with torch.inference_mode():
        k_rows, v_rows = _gather_rows(engine.caches, idx)
        dk = dv = None
        if engine.spec:
            dk, dv = _gather_rows(engine.draft_caches, idx)
    occ = engine.occupancy[slot].copy() if engine.num_leaves else None
    return KVHandoff(
        request=st.request, tokens=list(st.tokens), prompt_len=L,
        page_size=page, n_pages=n_keep, k_rows=k_rows, v_rows=v_rows,
        draft_k_rows=dk, draft_v_rows=dv, occupancy=occ,
        measured=bool(engine._measured[slot]))


def _pad(rows: torch.Tensor, ppr: int) -> torch.Tensor:
    """A layer's shipped (n_pages, page_size, K, hd) rows, zero-padded to
    ``ppr`` pages."""
    out = torch.zeros((ppr,) + tuple(rows.shape[1:]), dtype=rows.dtype)
    out[:rows.shape[0]] = rows
    return out


def _install_dispatch(engine, inp: dict) -> dict:
    """``lm.cache_install`` of the staged rows into both trees under spec,
    settled into the engine's canonical tensors (which its decode graphs
    read): what the ``install`` graph holds.  No outputs."""
    args = [inp[k] for k in ("admit", "tables", "lengths", "dst")]

    def rows(f, n):
        return [inp[f"{f}.{i}"] for i in range(n)]

    trees = [(engine.caches, "k_rows", "v_rows")]
    if engine.spec:
        trees.append((engine.draft_caches, "draft_k_rows", "draft_v_rows"))
    for caches, k, v in trees:
        n = len(caches)
        graphs.settle(caches, lm.cache_install(caches, *args, rows(k, n), rows(v, n)))
    return {}


def install(engine, h: KVHandoff) -> Optional[int]:
    """Install ``h`` into a free slot of ``engine`` (module docstring).

    Returns the slot index, or None when the engine cannot take it yet (no
    free slot, or the pool cannot fund the whole generation horizon even
    after reclaiming index entries): the caller keeps the handoff queued."""
    if h.page_size != engine._page or not engine.ecfg.page_size:
        raise ValueError(f"handoff page size {h.page_size} != receiving "
                         f"engine page size {engine.ecfg.page_size}")
    if engine.spec and h.draft_k_rows is None:
        raise ValueError("speculative engine requires the draft cache tree "
                         "in the handoff")
    free = [i for i, s in enumerate(engine.slots) if s is None]
    if not free:
        return None
    req = h.request
    L = h.prompt_len
    n_total = utils.cdiv(L + req.max_new_tokens, engine._page)
    if engine.pool.pages_free < n_total:
        engine.prefix.reclaim(n_total)
    pages = engine.pool.alloc(n_total)
    if pages is None:
        return None
    slot = free[0]
    S, ppr, sentinel = engine.ecfg.num_slots, engine._ppr, engine._num_pages
    admit = np.zeros((S,), bool)
    admit[slot] = True
    tables = np.full((S, ppr), sentinel, np.int32)
    tables[slot, :n_total] = pages
    lengths = np.zeros((S,), np.int32)
    lengths[slot] = L
    # the rows, padded to ppr pages, land on the funded pages (the zero
    # padding past n_pages in the generation room, which decode writes
    # before anything reads it) and, past those, on the sink page
    dst = np.full((ppr,), sentinel, np.int32)
    dst[:n_total] = pages
    inputs = {"admit": admit, "tables": tables, "lengths": lengths, "dst": dst}
    for f in _ROWS:
        for i, r in enumerate(getattr(h, f) or ()):
            inputs[f"{f}.{i}"] = _pad(r, ppr)
    engine._record_shape("install", tables.shape)
    with torch.inference_mode():
        engine._dispatch("install", functools.partial(_install_dispatch, engine),
                         inputs, tables.shape)
    engine._slot_pages[slot] = list(pages)
    engine._alloc_len[slot] = n_total * engine._page
    t = engine.now()
    st = SlotState(request=req, admitted_time=t, first_token_time=t,
                   tokens=list(h.tokens), total_len=L + len(h.tokens),
                   prefill_pos=L)
    engine.slots[slot] = st
    engine._live_rids.add(req.rid)
    engine._arrivals[id(req)] = t
    if engine.spec:
        engine._tlen[slot] = engine._dlen[slot] = L
    if h.occupancy is not None and engine.num_leaves and \
            h.occupancy.size == engine.num_leaves and h.occupancy.any():
        engine.occupancy[slot] = h.occupancy
        engine._measured[slot] = h.measured
    # replay the stop checks on the shipped tokens (an EOS or length finish
    # at prefill never ships from a ClusterWorker, but a custom caller might)
    for j, tok in enumerate(st.tokens):
        if req.eos_id is not None and tok == req.eos_id:
            st.done, st.finish_reason = True, "eos"
        elif j + 1 >= req.max_new_tokens:
            st.done, st.finish_reason = True, "length"
        if st.done:
            st.finish_time = t
            break
    return slot
