"""Attention (port of ``repro/nn/attention.py``): GQA with RoPE,
materialized-score attention up to ``FLASH_ABOVE`` tokens, the blocked
``flash_attention`` above it (training, eval and prefill), and the KV
cache for decode, chunked prefill and speculative verify; and
cross-attention (``cross_kv``, ``forward_cross``): decoder queries over an
encoder output's K/V, full and non-causal.

Attention is plain PyTorch, as the JAX package computes it outside Pallas;
``flash_attention`` follows the JAX package's online softmax over a static
list of (q-chunk, kv-chunk) pairs step by step.
The KV cache keeps the JAX fields (page pools, page table, lengths) in two
layouts: contiguous (one ``max_len`` page per row, an identity table) and
paged (``init_cache(page_size=...)``: a pool of fixed pages shared by all
rows through per-row tables, two rows may map one page).  Unlike the JAX
package, cache writes update the pools in place (the returned cache shares
them), which saves a copy of every layer's cache per step; the paged pools
end with one extra page that takes the writes JAX drops.
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
#: longest sequence the materialized-score path serves; longer ones take
#: the blocked ``flash_attention``, as in the JAX package
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
    chunk: int = 1024                # flash chunk size
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
# flash attention over static chunk pairs
# ---------------------------------------------------------------------------

def _chunk_pairs(n_q: int, n_k: int, causal: bool, window_chunks: int,
                 chunk: int, sliding_window: int) -> list[tuple[int, int, bool]]:
    """The static (qi, kj, needs_mask) schedule.  causal: only kj <= qi
    (equal-length q and k), the diagonal pair masked.  ``window_chunks`` w
    > 0: also qi - kj <= w (the band), and every pair whose largest
    distance reaches the window masked.  On a window of whole chunks that
    is the JAX package's pair at qi - kj == w alone; on any other window
    the nearer pairs the band cuts are masked too, which the JAX package
    leaves unmasked."""
    pairs = []
    for qi in range(n_q):
        for kj in range(n_k):
            if causal and kj > qi:
                continue
            if window_chunks > 0 and qi - kj > window_chunks:
                continue
            masked = ((causal and kj == qi) or window_chunks > 0
                      and (qi - kj + 1) * chunk - 1 >= sliding_window)
            pairs.append((qi, kj, masked))
    return pairs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk: int = 1024,
                    sliding_window: int = 0) -> torch.Tensor:
    """Online-softmax attention: q (B, S, H, hd); k, v (B, S, K, hd) with H
    = K * G -> (B, S, H, hd).  Visits only the statically scheduled chunk
    pairs, carrying float32 (m, l, acc) accumulators for each q-chunk; the
    JAX package's steps, with the accumulators laid out (B, H, chunk[, hd])
    so no step transposes.  Each pair rebinds its q-chunk's accumulators
    rather than writing them in place, so autograd can differentiate it."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = math.gcd(S, chunk) or S
    n = S // chunk
    scale = 1.0 / math.sqrt(hd)
    window_chunks = (max(1, utils.cdiv(sliding_window, chunk))
                     if sliding_window > 0 else 0)
    pairs = _chunk_pairs(n, n, causal, window_chunks, chunk, sliding_window)
    qf = q.float().transpose(1, 2)                       # (B, H, S, hd)
    kf = _expand_kv(k, G).float().transpose(1, 2)
    vf = _expand_kv(v, G).float().transpose(1, 2)
    m = [torch.full((B, H, chunk), NEG_INF, dtype=torch.float32, device=q.device)] * n
    l = [torch.zeros((B, H, chunk), dtype=torch.float32, device=q.device)] * n
    acc = [torch.zeros((B, H, chunk, hd), dtype=torch.float32, device=q.device)] * n
    col = torch.arange(chunk, device=q.device)
    for qi, kj, needs_mask in pairs:
        qs, ks = slice(qi * chunk, (qi + 1) * chunk), slice(kj * chunk, (kj + 1) * chunk)
        s = torch.einsum("bhqd,bhpd->bhqp", qf[:, :, qs], kf[:, :, ks]) * scale
        if needs_mask:
            dist = (qi - kj) * chunk + col[:, None] - col[None, :]   # qpos - kpos
            ok = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
            if causal:
                ok &= dist >= 0
            if sliding_window > 0:
                ok &= dist < sliding_window
            s = s.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m[qi], s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m[qi] - m_new)
        l[qi] = l[qi] * corr + p.sum(dim=-1)
        acc[qi] = acc[qi] * corr[..., None] + torch.einsum(
            "bhqp,bhpd->bhqd", p, vf[:, :, ks])
        m[qi] = m_new
    out = torch.cat(acc, dim=2) / torch.clamp(torch.cat(l, dim=2)[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """KV cache with the JAX package's fields: page pools ``k``/``v``, a
    per-row page ``table`` (B, ppr) int32 and filled ``length`` (B,) int32.
    Row b's position p lives at ``pool[table[b, p // page_size], p %
    page_size]``.

    Contiguous layout (``paged`` False): pools (B, max_len, K, hd), row b
    owns page b.  Paged layout (``paged`` True): pools (num_pages + 1,
    page_size, K, hd), shared by every row through its table.  Unmapped
    table entries hold the sentinel ``num_pages``, which names the extra
    last page: a sink that takes every write JAX drops (sentinel pages,
    padding, masked rows), so no write needs a host synchronization and
    none can land on a page another row holds.  Reads of the sink are
    masked by ``length``.  Two rows may map one page (a shared prompt
    prefix); the host allocator guarantees a shared page is never
    written."""
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    length: torch.Tensor
    paged: bool = False


def init_cache(batch: int, max_len: int, cfg: AttnConfig, dtype=None, *,
               page_size: int = 0, num_pages: int = 0,
               prealloc: bool = True, device="cpu") -> KVCache:
    """``page_size <= 0``: the contiguous layout (one ``max_len`` page per
    row).  ``page_size > 0``: a pool of ``num_pages`` pages (default
    ``batch * ceil(max_len / page_size)``) plus the sink.  ``prealloc``
    maps row b to pages ``[b*ppr, (b+1)*ppr)``, a ready-to-write table for
    standalone callers (``lm.generate``, tests); the serving engine passes
    ``prealloc=False`` (every entry the sentinel) and installs its tables
    at admission (``models.lm.cache_admit``)."""
    dtype = dtype or cfg.param_dtype
    kv_shape = (cfg.n_kv_heads, cfg.head_dim)
    zeros = lambda *lead: torch.zeros(lead + kv_shape, dtype=dtype, device=device)
    length = torch.zeros(batch, dtype=torch.int32, device=device)
    if page_size <= 0:
        if num_pages or not prealloc:
            raise ValueError("the contiguous layout (page_size 0) holds one "
                             "preallocated page per row")
        table = torch.arange(batch, dtype=torch.int32, device=device)[:, None]
        return KVCache(zeros(batch, max_len), zeros(batch, max_len), table,
                       length)
    ppr = utils.cdiv(max_len, page_size)                 # pages per row
    num_pages = num_pages or batch * ppr
    if prealloc:
        if num_pages < batch * ppr:
            raise ValueError(f"prealloc needs {batch * ppr} pages, "
                             f"pool has {num_pages}")
        table = torch.arange(batch * ppr, dtype=torch.int32,
                             device=device).reshape(batch, ppr)
    else:
        table = torch.full((batch, ppr), num_pages, dtype=torch.int32,
                           device=device)
    return KVCache(zeros(num_pages + 1, page_size),      # + the sink page
                   zeros(num_pages + 1, page_size), table, length, paged=True)


def gather_cache_kv(cache: KVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row K/V views (B, ppr*page, K, hd) gathered through the table;
    sentinel entries read the sink page (paged) or clamp to the last page
    (contiguous), masked by the caller's length check either way."""
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


def _paged_write(cache: KVCache, pos: torch.Tensor, ok: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor) -> None:
    """Scatter k, v (B, C, K, hd) to logical positions pos (B, C) of a
    paged cache where ``ok`` (B, C) holds and the position lies inside the
    row's table; every other write, and every write through a sentinel
    entry, lands in the sink page (in place, no host synchronization)."""
    page = cache.k.shape[1]
    ppr = cache.table.shape[1]
    sink = cache.k.shape[0] - 1
    pid = torch.gather(cache.table.long(), 1, (pos // page).clamp(max=ppr - 1))
    pid = torch.where(ok & (pos < ppr * page), pid, torch.full_like(pid, sink))
    off = pos % page
    for pool, new in ((cache.k, k), (cache.v, v)):
        pool[pid, off] = new.to(pool.dtype)


def prefill_into_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor
                       ) -> KVCache:
    """Write a full prefix (B, S, K, hd) at position 0 (in place)."""
    B, S = k.shape[:2]
    if S > cache.table.shape[1] * cache.k.shape[1]:
        raise ValueError(f"prefix of {S} tokens exceeds the cache's "
                         f"{cache.table.shape[1] * cache.k.shape[1]} positions")
    pos = torch.arange(S, device=k.device)[None, :].expand(B, S)
    if cache.paged:
        _paged_write(cache, pos, torch.ones_like(pos, dtype=torch.bool), k, v)
        return cache._replace(length=torch.full_like(cache.length, S))
    pid, off, _ = _slots(cache, pos)
    cache.k[pid, off] = k.to(cache.k.dtype)
    cache.v[pid, off] = v.to(cache.v.dtype)
    return cache._replace(length=torch.full_like(cache.length, S))


def append_to_cache(cache: KVCache, k1: torch.Tensor, v1: torch.Tensor,
                    write_mask: Optional[torch.Tensor] = None) -> KVCache:
    """Append one token (B, 1, K, hd) at each row's length (in place).
    Rows where ``write_mask`` is False neither write nor advance; a write
    past a row's mapped pages is dropped.  Each row of a contiguous cache
    writes only its own page, so the drop is a write-back of the slot's old
    value and needs no host synchronization; a paged cache drops it into
    its sink page."""
    B = k1.shape[0]
    valid = (torch.ones(B, dtype=torch.bool, device=k1.device)
             if write_mask is None else write_mask.to(torch.bool))
    if cache.paged:
        _paged_write(cache, cache.length.long()[:, None], valid[:, None], k1, v1)
        return cache._replace(length=cache.length + valid.to(cache.length.dtype))
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
    the row's capacity).  A paged cache drops them into its sink page."""
    B, C = k.shape[:2]
    cap = cache.table.shape[1] * cache.k.shape[1]
    if C > cap:
        raise ValueError(f"chunk of {C} positions exceeds the cache's {cap}")
    col = torch.arange(C, device=k.device)[None, :]
    pos = cache.length.long()[:, None] + col
    if cache.paged:
        _paged_write(cache, pos, col < valid_len.long()[:, None], k, v)
        return cache._replace(
            length=cache.length + valid_len.to(cache.length.dtype))
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

def _flash(cfg: AttnConfig, q, k, v) -> torch.Tensor:
    return flash_attention(q, k, v, causal=cfg.causal, chunk=cfg.chunk,
                           sliding_window=cfg.sliding_window)


def forward(params: Params, cfg: AttnConfig, x: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over a full sequence without a cache (train and
    eval): x (B, S, D) -> (B, S, D), RoPE at positions 0..S-1 unless
    ``positions`` (B, S) are given.  Above ``FLASH_ABOVE`` tokens the
    blocked ``flash_attention``; else materialized scores with a
    sliding-window band when ``cfg.sliding_window`` is shorter than S."""
    B, S, _ = x.shape
    if positions is None and cfg.use_rope:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = qkv(params, cfg, x, positions)
    if S > FLASH_ABOVE:
        return out_proj(params, cfg, _flash(cfg, q, k, v))
    band = None
    if cfg.sliding_window > 0 and S > cfg.sliding_window:
        i = torch.arange(S, device=x.device)
        band = (i[:, None] - i[None, :]) < cfg.sliding_window
    o = full_attention(q, k, v, causal=cfg.causal, bias_mask=band)
    return out_proj(params, cfg, o)


def forward_prefill(params: Params, cfg: AttnConfig, x: torch.Tensor,
                    cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Prefill from position 0: the cache takes the prefix's K/V.  Above
    ``FLASH_ABOVE`` tokens the blocked ``flash_attention`` (with the
    sliding window); at or below it causal materialized scores without a
    band, as in the JAX package."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = qkv(params, cfg, x, positions if cfg.use_rope else None)
    cache = prefill_into_cache(cache, k, v)
    if S > FLASH_ABOVE:
        o = _flash(cfg, q, k, v)
    else:
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


def forward_cross(params: Params, cfg: AttnConfig, x: torch.Tensor,
                  enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention: queries from x (B, S, D) over the encoder's K/V
    (B, S_enc, K, hd) from ``cross_kv``, full and non-causal, no RoPE."""
    ad = cfg.accum_dtype
    q = utils.einsum_as("bsd,dhk->bshk", x, params["wq"], out_dtype=ad)
    if cfg.bias:
        q = q + params["bq"].to(ad)
    o = full_attention(q, enc_k, enc_v, causal=False)
    return out_proj(params, cfg, o)


def cross_kv(params: Params, cfg: AttnConfig, enc_out: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, S_enc, D) -> the cross-attention K and V
    (B, S_enc, K, hd) in ``cfg.accum_dtype``, biases under ``cfg.bias``."""
    ad = cfg.accum_dtype
    k = utils.einsum_as("bsd,dhk->bshk", enc_out, params["wk"], out_dtype=ad)
    v = utils.einsum_as("bsd,dhk->bshk", enc_out, params["wv"], out_dtype=ad)
    if cfg.bias:
        k = k + params["bk"].to(ad)
        v = v + params["bv"].to(ad)
    return k, v
