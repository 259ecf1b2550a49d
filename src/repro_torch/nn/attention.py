"""Attention (port of ``repro/nn/attention.py``): GQA with RoPE, plain
materialized-score attention (full-sequence self-attention for training
and eval), and the KV cache for decode, chunked prefill and speculative
verify.

Attention is plain PyTorch, as the JAX package computes it outside Pallas.
The blocked ``flash_attention`` the JAX package uses above 2048 tokens is
not ported yet, so prompts and training sequences longer than that raise.
The KV cache keeps the JAX fields (page pools, page table, lengths) in the
contiguous layout only: one ``max_len`` page per row and an identity
table.  Unlike the JAX package, cache writes update the pools in place
(the returned cache shares them), which saves a copy of every layer's
cache per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import utils
from repro_torch.nn import rope as rope_lib

Params = dict

NEG_INF = -1e30
#: longest prompt the materialized-score path serves (JAX switches to its
#: blocked flash attention above this)
FLASH_ABOVE = 2048


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    sliding_window: int = 0          # 0 = full
    param_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32


def init(gen: torch.Generator, cfg: AttnConfig) -> Params:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd, dev = cfg.param_dtype, gen.device
    std = 1.0 / math.sqrt(D)
    p: Params = {
        "wq": utils.truncated_init(gen, (D, H, hd), std, pd),
        "wk": utils.truncated_init(gen, (D, K, hd), std, pd),
        "wv": utils.truncated_init(gen, (D, K, hd), std, pd),
        "wo": utils.truncated_init(gen, (H, hd, D), 1.0 / math.sqrt(H * hd), pd),
    }
    if cfg.bias:
        p["bq"] = torch.zeros((H, hd), dtype=pd, device=dev)
        p["bk"] = torch.zeros((K, hd), dtype=pd, device=dev)
        p["bv"] = torch.zeros((K, hd), dtype=pd, device=dev)
        p["bo"] = torch.zeros((D,), dtype=pd, device=dev)
    return p


def qkv(params: Params, cfg: AttnConfig, x: torch.Tensor,
        positions: Optional[torch.Tensor]
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, K, hd), RoPE applied."""
    ad = cfg.accum_dtype
    q = utils.einsum_as("bsd,dhk->bshk", x, params["wq"], out_dtype=ad)
    k = utils.einsum_as("bsd,dhk->bshk", x, params["wk"], out_dtype=ad)
    v = utils.einsum_as("bsd,dhk->bshk", x, params["wv"], out_dtype=ad)
    if cfg.bias:
        q = q + params["bq"].to(ad)
        k = k + params["bk"].to(ad)
        v = v + params["bv"].to(ad)
    if cfg.use_rope and positions is not None:
        q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
        k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(params: Params, cfg: AttnConfig, o: torch.Tensor) -> torch.Tensor:
    y = utils.einsum_as("bshk,hkd->bsd", o, params["wo"], out_dtype=cfg.accum_dtype)
    if cfg.bias:
        y = y + params["bo"].to(cfg.accum_dtype)
    return y


def _expand_kv(kv: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K*G, hd): KV repeated per q-head."""
    return kv if groups == 1 else kv.repeat_interleave(groups, dim=2)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   bias_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Materialized-score attention.  q (B, S, H, hd); k, v (B, Sk, K, hd);
    ``bias_mask`` (S, Sk) bool, False = masked (a sliding-window band)."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    G = H // k.shape[2]
    kf = _expand_kv(k, G).float()
    vf = _expand_kv(v, G).float()
    s = torch.einsum("bqhd,bphd->bhqp", q.float(), kf) / math.sqrt(hd)
    if causal:
        mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device).tril(Sk - S)
        s = s.masked_fill(~mask, NEG_INF)
    if bias_mask is not None:
        s = s.masked_fill(~bias_mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqp,bphd->bqhd", p, vf).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """KV cache with the JAX package's fields: page pools ``k``/``v``
    (num_pages, page_size, K, hd), a per-row page ``table`` (B, ppr) int32
    and filled ``length`` (B,) int32.  Row b's position p lives at
    ``pool[table[b, p // page_size], p % page_size]``.  Only the contiguous
    layout is built here (one ``max_len`` page per row, identity table)."""
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    length: torch.Tensor


def init_cache(batch: int, max_len: int, cfg: AttnConfig, dtype=None, *,
               device="cpu") -> KVCache:
    dtype = dtype or cfg.param_dtype
    table = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
    shp = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shp, dtype=dtype, device=device),
                   torch.zeros(shp, dtype=dtype, device=device), table,
                   torch.zeros(batch, dtype=torch.int32, device=device))


def gather_cache_kv(cache: KVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row K/V views (B, ppr*page, K, hd) gathered through the table."""
    num_pages, page = cache.k.shape[:2]
    tbl = cache.table.long().clamp(max=num_pages - 1)
    B, ppr = tbl.shape
    shp = (B, ppr * page) + tuple(cache.k.shape[2:])
    return cache.k[tbl].reshape(shp), cache.v[tbl].reshape(shp)


def _slots(cache: KVCache, pos: torch.Tensor):
    """Pool coordinates of logical positions pos (B, C) and whether each
    lies inside its row's mapped pages."""
    page = cache.k.shape[1]
    ppr = cache.table.shape[1]
    inside = pos < ppr * page
    pg = (pos // page).clamp(max=ppr - 1)
    pid = torch.gather(cache.table.long(), 1, pg)
    off = torch.where(inside, pos % page, torch.full_like(pos, page - 1))
    return pid, off, inside


def prefill_into_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor
                       ) -> KVCache:
    """Write a full prefix (B, S, K, hd) at position 0 (in place)."""
    B, S = k.shape[:2]
    if S > cache.table.shape[1] * cache.k.shape[1]:
        raise ValueError(f"prefix of {S} tokens exceeds the cache's "
                         f"{cache.table.shape[1] * cache.k.shape[1]} positions")
    pos = torch.arange(S, device=k.device)[None, :].expand(B, S)
    pid, off, _ = _slots(cache, pos)
    cache.k[pid, off] = k.to(cache.k.dtype)
    cache.v[pid, off] = v.to(cache.v.dtype)
    return cache._replace(length=torch.full_like(cache.length, S))


def append_to_cache(cache: KVCache, k1: torch.Tensor, v1: torch.Tensor,
                    write_mask: Optional[torch.Tensor] = None) -> KVCache:
    """Append one token (B, 1, K, hd) at each row's length (in place).
    Rows where ``write_mask`` is False neither write nor advance; a write
    past a row's mapped pages is dropped.  Each row writes only its own
    page, so the drop is a write-back of the slot's old value and needs no
    host synchronization."""
    B = k1.shape[0]
    valid = (torch.ones(B, dtype=torch.bool, device=k1.device)
             if write_mask is None else write_mask.to(torch.bool))
    pid, off, inside = _slots(cache, cache.length.long()[:, None])
    pid, off = pid[:, 0], off[:, 0]
    ok = (valid & inside[:, 0])[:, None, None]
    for pool, new in ((cache.k, k1), (cache.v, v1)):
        pool[pid, off] = torch.where(ok, new[:, 0].to(pool.dtype), pool[pid, off])
    return cache._replace(length=cache.length + valid.to(cache.length.dtype))


def chunk_into_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> KVCache:
    """Write a chunk (B, C, K, hd) at each row's current length (in place):
    row b's first ``valid_len[b]`` positions are written, the rest and any
    position past the row's mapped pages dropped; ``length`` advances by
    ``valid_len``.  No host synchronization: a dropped position writes back
    its slot's old value, and a position past the row's pages wraps onto
    the row's own positions below its length, which no write of this chunk
    touches, so every index of the scatter is distinct (C must not exceed
    the row's capacity)."""
    B, C = k.shape[:2]
    cap = cache.table.shape[1] * cache.k.shape[1]
    if C > cap:
        raise ValueError(f"chunk of {C} positions exceeds the cache's {cap}")
    col = torch.arange(C, device=k.device)[None, :]
    pos = cache.length.long()[:, None] + col
    ok = ((col < valid_len.long()[:, None]) & (pos < cap))[..., None, None]
    pid, off, _ = _slots(cache, pos % cap)
    for pool, new in ((cache.k, k), (cache.v, v)):
        pool[pid, off] = torch.where(ok, new.to(pool.dtype), pool[pid, off])
    return cache._replace(length=cache.length + valid_len.to(cache.length.dtype))


def decode_attend(q1: torch.Tensor, cache: KVCache, *,
                  sliding_window: int = 0) -> torch.Tensor:
    """One-token attention against the cache: q1 (B, 1, H, hd) -> same
    shape; positions at or past each row's ``length`` are masked.  The GQA
    contraction stays on the K axis (no KV expansion)."""
    B, _, H, hd = q1.shape
    K = cache.k.shape[2]
    kc, vc = gather_cache_kv(cache)                    # (B, S, K, hd)
    S = kc.shape[1]
    qg = q1.reshape(B, K, H // K, hd).float()
    s = torch.einsum("bkgd,bpkd->bkgp", qg, kc.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q1.device)[None, :]
    length = cache.length.long()[:, None]
    valid = pos < length
    if sliding_window > 0:
        valid &= pos >= (length - sliding_window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgp,bpkd->bkgd", p, vc.float())
    return o.reshape(B, 1, H, hd).to(q1.dtype)


def chunk_attend(q: torch.Tensor, cache: KVCache, start: torch.Tensor, *,
                 sliding_window: int = 0) -> torch.Tensor:
    """Chunk attention against the cache with per-row positions: q
    (B, C, H, hd); row b's query i sits at ``start[b] + i`` and attends to
    cache positions ``<= start[b] + i`` (its history plus the chunk's own
    causal prefix, already written by ``chunk_into_cache``).  As in
    ``decode_attend``, the GQA contraction stays on the K axis."""
    B, C, H, hd = q.shape
    K = cache.k.shape[2]
    kc, vc = gather_cache_kv(cache)                    # (B, S, K, hd)
    S = kc.shape[1]
    qg = q.reshape(B, C, K, H // K, hd).float()
    s = torch.einsum("bckgd,bpkd->bkgcp", qg, kc.float()) / math.sqrt(hd)
    qpos = start.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    kpos = torch.arange(S, device=q.device)[None, None, :]
    valid = kpos <= qpos[:, :, None]                   # (B, C, S)
    if sliding_window > 0:
        valid &= kpos > qpos[:, :, None] - sliding_window
    s = s.masked_fill(~valid[:, None, None, :, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgcp,bpkd->bckgd", p, vc.float())
    return o.reshape(B, C, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# block-level entry points
# ---------------------------------------------------------------------------

def _check_len(S: int) -> None:
    if S > FLASH_ABOVE:
        raise NotImplementedError(
            f"sequences over {FLASH_ABOVE} tokens need the blocked flash "
            f"attention, which is not ported yet")


def forward(params: Params, cfg: AttnConfig, x: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over a full sequence without a cache (train and
    eval): x (B, S, D) -> (B, S, D), RoPE at positions 0..S-1 unless
    ``positions`` (B, S) are given, a sliding-window band when
    ``cfg.sliding_window`` is shorter than S."""
    B, S, _ = x.shape
    _check_len(S)
    if positions is None and cfg.use_rope:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = qkv(params, cfg, x, positions)
    band = None
    if cfg.sliding_window > 0 and S > cfg.sliding_window:
        i = torch.arange(S, device=x.device)
        band = (i[:, None] - i[None, :]) < cfg.sliding_window
    o = full_attention(q, k, v, causal=cfg.causal, bias_mask=band)
    return out_proj(params, cfg, o)


def forward_prefill(params: Params, cfg: AttnConfig, x: torch.Tensor,
                    cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    B, S, _ = x.shape
    _check_len(S)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = qkv(params, cfg, x, positions if cfg.use_rope else None)
    cache = prefill_into_cache(cache, k, v)
    o = full_attention(q, k, v, causal=cfg.causal)
    return out_proj(params, cfg, o), cache


def forward_decode(params: Params, cfg: AttnConfig, x1: torch.Tensor,
                   cache: KVCache, write_mask: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, KVCache]:
    """One decode step: x1 (B, 1, D); RoPE positions are the cache lengths."""
    positions = cache.length.long()[:, None] if cfg.use_rope else None
    q, k, v = qkv(params, cfg, x1, positions)
    cache = append_to_cache(cache, k, v, write_mask)
    o = decode_attend(q, cache, sliding_window=cfg.sliding_window)
    return out_proj(params, cfg, o), cache


def forward_chunk(params: Params, cfg: AttnConfig, x: torch.Tensor,
                  cache: KVCache, valid_len: torch.Tensor
                  ) -> tuple[torch.Tensor, KVCache]:
    """Chunked prefill and speculative verify: x (B, C, D) continues each
    row's sequence at its cache length.  Row b's first ``valid_len[b]``
    positions are written to the cache and attend causally to the row's
    history; pad positions and rows with ``valid_len == 0`` write nothing
    and give outputs the caller ignores.  RoPE positions are absolute,
    ``cache.length[b] + i``."""
    B, C, _ = x.shape
    start = cache.length.long()
    positions = start[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k, v = qkv(params, cfg, x, positions if cfg.use_rope else None)
    cache = chunk_into_cache(cache, k, v, valid_len)
    o = chunk_attend(q, cache, start, sliding_window=cfg.sliding_window)
    return out_proj(params, cfg, o), cache
