"""The port's paged KV cache, prefix index and copy-on-write admission
against the JAX package's, on the CPU.

* Host tier: ``serving/paging.py``'s ``PagePool`` and ``PrefixIndex`` and
  the JAX package's run the same seeded admit / evict / publish / reclaim
  sequences (after ``tests/test_serving_paged.py``): every return value,
  refcount, ``pages_free`` and reclaim order must agree.
* Cache tier: numpy-drawn page pools, tables (shared pages and sentinel
  entries included) and lengths go through the port's and the JAX
  package's paged writes, attention reads and ``cache_admit`` with its
  copy-on-write: the pools equal JAX's exactly (float32), attention to
  the ``e2e`` tolerance.  A preallocated paged cache generates the
  contiguous cache's tokens.
* Engine tier: one 2-layer ``internlm2-20b`` FFF ``reduced`` model,
  float32, carries the same numpy-drawn weights into both packages
  (``weights.from_jax``).  The port's paged engine (page size 4) and the
  JAX paged engine (``reference`` backend) serve the same waves of
  shared-prefix, copy-on-write and mixed requests in monolithic, chunked
  and speculative mode, with prefix sharing on and off, and with a pool
  too small for two requests at once: the same tokens per request and the
  same ``prefill_tokens``, ``prefix_hit_tokens``, ``cow_copies``,
  ``pages_in_use`` and ``pages_free``.  The port's paged engine also
  equals its own contiguous engine and ``lm.generate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.serving import engine as jengine
from repro.serving import paging as jpaging
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import registry
from repro_torch.core import fff
from repro_torch.kernels.leaf_gemm import ops as g_ops
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.serving import paging
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import Request

torch.set_num_threads(2)

SLOTS, PROMPT, GEN, PAGE = 3, 16, 6, 4
MAX_LEN = PROMPT + GEN + 2              # 24: six pages of 4 a slot
MODES = {"monolithic": {}, "chunked": {"prefill_chunk": 8},
         "spec": {"spec_k": 2, "draft_config": "self:1"}}


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# host tier: PagePool and PrefixIndex against the JAX package's
# ---------------------------------------------------------------------------

def _twin_ops(ops, num_pages=16, page_size=4):
    """Apply one op sequence to the port's pool and index and to JAX's and
    compare every result; ops as in ``tests/test_serving_paged.py``:
    0 = admit (match a donor's prefix or fresh tokens, incref, alloc, roll
    back on refusal), 1 = evict, 2 = publish, 3 = reclaim."""
    twins = []
    for mod in (paging, jpaging):
        pool = mod.PagePool(num_pages, page_size)
        twins.append((pool, mod.PrefixIndex(pool)))
    slots, next_tok = {}, [0]

    def both(fn):
        got = [fn(pool, index) for pool, index in twins]
        assert got[0] == got[1], got
        return got[0]

    for kind, a, b in ops:
        kind, slot = kind % 4, b % 4
        if kind == 0 and slot not in slots:
            n = 1 + a % 4
            if slots and a % 2 == 0:
                tokens = list(sorted(slots.values())[0][0][:n * page_size])
            else:
                tokens = [next_tok[0] + i for i in range(n * page_size)]
                next_tok[0] += n * page_size
            shared = both(lambda p, ix: ix.match(tokens))[:max(n - 1, 0)]
            both(lambda p, ix: p.incref(shared))
            fresh = both(lambda p, ix: p.alloc(n - len(shared)))
            if fresh is None:
                assert both(lambda p, ix: p.decref(shared)) is not None
            else:
                slots[slot] = (tuple(tokens), list(shared) + fresh)
        elif kind == 1 and slot in slots:
            _, pages = slots.pop(slot)
            both(lambda p, ix: p.decref(pages))
        elif kind == 2 and slot in slots:
            tokens, pages = slots[slot]
            both(lambda p, ix: ix.insert(tokens, pages))
        elif kind == 3:
            both(lambda p, ix: ix.reclaim(a % num_pages))
        both(lambda p, ix: ([p.refcount(i) for i in range(num_pages)],
                            p.pages_free, p.pages_in_use, ix.n_entries))
    for _, pages in slots.values():
        both(lambda p, ix: p.decref(pages))
    assert both(lambda p, ix: (ix.reclaim(num_pages), p.pages_free))[1] \
        == num_pages


@pytest.mark.parametrize("seed", range(4))
def test_pool_and_index_match_jax_on_seeded_op_sequences(seed):
    r = rng(seed)
    for _ in range(50):
        _twin_ops(r.integers(0, 64, (int(r.integers(1, 40)), 3)).tolist())


def test_pool_and_index_edges_match_jax():
    for mod in (paging, jpaging):
        pool = mod.PagePool(4, 8)
        assert pool.alloc(5) is None and pool.pages_free == 4
        got = pool.alloc(4)
        assert got == [0, 1, 2, 3] and pool.alloc(1) is None
        assert pool.decref(got) == got and pool.pages_free == 4
        (p,) = pool.alloc(1)
        pool.decref([p])
        with pytest.raises(RuntimeError, match="double free"):
            pool.decref([p])
        with pytest.raises(RuntimeError, match="incref of free"):
            pool.incref([p])
        with pytest.raises(ValueError, match="positive"):
            mod.PagePool(0, 8)
        # LRU reclaim: the touched entry survives
        pool = mod.PagePool(8, 2)
        index = mod.PrefixIndex(pool)
        a, b = pool.alloc(1), pool.alloc(1)
        index.insert([1, 2], a)
        index.insert([3, 4], b)
        pool.decref(a + b)
        index.match([1, 2])
        assert index.reclaim(7) == 1
        assert index.match([1, 2]) == a and index.match([3, 4]) == []


# ---------------------------------------------------------------------------
# cache tier
# ---------------------------------------------------------------------------

def _attn_cfgs():
    kw = dict(d_model=16, n_heads=4, n_kv_heads=2, head_dim=4)
    return attention.AttnConfig(**kw), jattn.AttnConfig(**kw)


def _paged_pair(r, B=3, max_len=12, page=4, num_pages=7):
    """The same paged cache in both packages: numpy-drawn pools, a table
    with a page shared by rows 0 and 1, sentinel entries, and a row 2 whose
    stale entry maps the page row 1 writes next; lengths."""
    tcfg, jcfg = _attn_cfgs()
    pool_k = r.normal(size=(num_pages, page, 2, 4)).astype(np.float32)
    pool_v = r.normal(size=(num_pages, page, 2, 4)).astype(np.float32)
    table = np.array([[0, 1, 2], [0, 3, num_pages], [3, num_pages, num_pages]],
                     np.int32)
    length = np.array([5, 4, 2], np.int32)
    tc = attention.init_cache(B, max_len, tcfg, page_size=page,
                              num_pages=num_pages, prealloc=False)
    tc.k[:num_pages] = t(pool_k)
    tc.v[:num_pages] = t(pool_v)
    tc = tc._replace(table=t(table), length=t(length))
    jc = jattn.init_cache(B, max_len, jcfg, page_size=page,
                          num_pages=num_pages, prealloc=False)._replace(
        k=jnp.asarray(pool_k), v=jnp.asarray(pool_v), table=jnp.asarray(table),
        length=jnp.asarray(length))
    return tc, jc, num_pages


def _same_cache(tc, jc, num_pages):
    np.testing.assert_array_equal(tc.k[:num_pages].numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v[:num_pages].numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.table.numpy(), np.asarray(jc.table))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def close(got, want):
    rtol, atol = dtype_tol(jnp.float32, "e2e")
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def test_init_cache_layouts_match_jax():
    tcfg, jcfg = _attn_cfgs()
    for kw in (dict(page_size=4), dict(page_size=4, num_pages=20,
                                       prealloc=False)):
        tc = attention.init_cache(3, 10, tcfg, **kw)
        jc = jattn.init_cache(3, 10, jcfg, **kw)
        np.testing.assert_array_equal(tc.table.numpy(), np.asarray(jc.table))
        assert tc.paged and tuple(tc.k.shape) == (jc.k.shape[0] + 1,) + jc.k.shape[1:]
    contiguous = attention.init_cache(3, 10, tcfg)
    assert not contiguous.paged and tuple(contiguous.k.shape) == (3, 10, 2, 4)
    with pytest.raises(ValueError, match="prealloc needs"):
        attention.init_cache(3, 10, tcfg, page_size=4, num_pages=8)
    with pytest.raises(ValueError, match="contiguous"):
        attention.init_cache(3, 10, tcfg, prealloc=False)


def test_paged_writes_and_reads_match_jax():
    """Chunk and append writes through shared, private and sentinel table
    entries (row 1 runs past its mapped pages; padding and masked rows
    write nothing, not even onto the page row 2's stale entry shares with
    row 1), then decode and chunk attention over the gathered pages at
    lengths inside each row's mapped pages."""
    r = rng(1)
    tc, jc, P = _paged_pair(r)
    k = r.normal(size=(3, 4, 2, 4)).astype(np.float32)
    valid = np.array([3, 4, 0], np.int32)
    tc = attention.chunk_into_cache(tc, t(k), t(-k), t(valid))
    jc = jattn.chunk_into_cache(jc, jnp.asarray(k), jnp.asarray(-k),
                                jnp.asarray(valid))
    _same_cache(tc, jc, P)
    k1 = r.normal(size=(3, 1, 2, 4)).astype(np.float32)
    mask = np.array([True, True, False])       # row 1 at 8: past its pages
    tc = attention.append_to_cache(tc, t(k1), t(2 * k1), t(mask))
    jc = jattn.append_to_cache(jc, jnp.asarray(k1), jnp.asarray(2 * k1),
                               jnp.asarray(mask))
    _same_cache(tc, jc, P)
    length = np.array([9, 8, 2], np.int32)
    tc = tc._replace(length=t(length))
    jc = jc._replace(length=jnp.asarray(length))
    q1 = r.normal(size=(3, 1, 4, 4)).astype(np.float32)
    close(attention.decode_attend(t(q1), tc), jattn.decode_attend(jnp.asarray(q1), jc))
    q = r.normal(size=(3, 3, 4, 4)).astype(np.float32)
    start = np.array([2, 0, 1], np.int32)
    close(attention.chunk_attend(t(q), tc, t(start)),
          jattn.chunk_attend(jnp.asarray(q), jc, jnp.asarray(start)))


def test_prefill_into_a_paged_cache_matches_jax():
    tcfg, jcfg = _attn_cfgs()
    k = rng(2).normal(size=(2, 7, 2, 4)).astype(np.float32)
    tc = attention.prefill_into_cache(
        attention.init_cache(2, 8, tcfg, page_size=4), t(k), t(k + 1))
    jc = jattn.prefill_into_cache(jattn.init_cache(2, 8, jcfg, page_size=4),
                                  jnp.asarray(k), jnp.asarray(k + 1))
    _same_cache(tc, jc, 4)


# ---------------------------------------------------------------------------
# phantom rows in the kernel path's grouped dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "relu"])
def test_phantom_rows_never_take_a_valid_rows_capacity(act):
    """The grouped dispatch of a slab: a leaf's valid tokens take its slots
    first, and the tokens past capacity, valid and phantom, take one
    overflow pass, in which a row's result depends on no other row; so
    neither which valid tokens fit nor their outputs depend on the phantom
    rows (whose content differs between a paged and a contiguous cache):
    new phantom rows leave every valid output bit-identical, and every
    output stays the exact leaf output."""
    r = rng(12)
    cfg = fff.FFFConfig(dim_in=16, dim_out=16, depth=2, leaf_width=8,
                        activation=act, leaf_bias=False)
    tp = fff.init(torch.Generator().manual_seed(12), cfg)
    leaves = {k: v[0] for k, v in tp.items() if k.startswith("leaf_")}
    idx = t(np.where(r.random(40) < 0.6, 1, r.integers(0, 4, (40,))).astype(np.int32))
    valid = t(r.random(40) < 0.5)
    x = t(r.normal(size=(40, 16)).astype(np.float32))
    layout = g_ops.scatter_to_groups(x, idx, 4, 8, valid)
    alone = g_ops.scatter_to_groups(x[valid], idx[valid], 4, 8)
    np.testing.assert_array_equal(layout.slot[valid].numpy(), alone.slot.numpy())
    assert not bool(alone.kept.all())                # valid tokens overflow
    run = lambda xs, ids: g_ops.fff_leaf_mlp(xs, ids, leaves, activation=act,
                                             capacity_factor=0.5, block_c=4,
                                             valid=valid)
    y = run(x, idx)
    other_x = torch.where(valid[:, None], x, t(r.normal(size=(40, 16)).astype(np.float32)))
    other_idx = torch.where(valid, idx, t(np.full(40, 1, np.int32)))
    assert torch.equal(run(other_x, other_idx)[valid], y[valid])
    want = fff.leaf_apply_grouped(leaves, x, idx, act, torch.float32)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model: same weights in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jregistry.get_config("internlm2-20b").reduced(n_layers=2)
    tcfg = registry.get_config("internlm2-20b").reduced(n_layers=2)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = rng(7)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 4.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                          device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp)


def test_cache_admit_copy_on_write_matches_jax(model):
    """``cache_admit`` on numpy-drawn pools, tables and lengths: two rows
    admitted (one copies a page, one passes the sentinel), one untouched;
    every layer's pools, tables and lengths equal JAX's exactly."""
    r = rng(3)
    B, L, P = 3, 16, 10
    jc = jlm.init_caches(model["jcfg"], B, L, page_size=PAGE, num_pages=P,
                         prealloc=False)
    tc = lm.init_caches(model["tcfg"], B, L, page_size=PAGE, num_pages=P,
                        prealloc=False, device="cpu")
    (jkv,) = [c["kv"] for c in jc]                  # stacked (layers, ...)
    pools = r.normal(size=(2,) + tuple(jkv.k.shape)).astype(np.float32)
    table = r.integers(0, P + 1, (B, L // PAGE)).astype(np.int32)
    length = r.integers(0, L, (B,)).astype(np.int32)
    jc = [dict(kv=jkv._replace(k=jnp.asarray(pools[0]), v=jnp.asarray(pools[1]),
                               table=jnp.broadcast_to(table, jkv.table.shape),
                               length=jnp.broadcast_to(length, jkv.length.shape)))]
    for i, c in enumerate(tc):
        c["kv"].k[:P] = t(pools[0, i])
        c["kv"].v[:P] = t(pools[1, i])
    tc = [dict(c, kv=c["kv"]._replace(table=t(table), length=t(length)))
          for c in tc]
    admit = np.array([True, False, True])
    tables = r.integers(0, P, (B, L // PAGE)).astype(np.int32)
    lengths = np.array([7, 0, 3], np.int32)
    cow_src = np.array([5, P, P], np.int32)
    cow_dst = np.array([8, P, P], np.int32)
    args = (admit, tables, lengths, cow_src, cow_dst)
    jc = jlm.cache_admit(jc, *map(jnp.asarray, args))
    tc = lm.cache_admit(tc, *map(t, args))
    (jkv,) = [c["kv"] for c in jc]
    for i, c in enumerate(tc):
        kv = c["kv"]
        np.testing.assert_array_equal(kv.k[:P].numpy(), np.asarray(jkv.k[i]))
        np.testing.assert_array_equal(kv.v[:P].numpy(), np.asarray(jkv.v[i]))
        np.testing.assert_array_equal(kv.table.numpy(), np.asarray(jkv.table[i]))
        np.testing.assert_array_equal(kv.length.numpy(), np.asarray(jkv.length[i]))
    np.testing.assert_array_equal(tc[0]["kv"].k[8].numpy(), pools[0, 0, 5])
    with pytest.raises(ValueError, match="contiguous"):
        lm.cache_admit(lm.init_caches(model["tcfg"], B, L, device="cpu"),
                       *map(t, args))


def test_prealloc_paged_generate_matches_contiguous(model):
    prompt = t(rng(4).integers(0, 256, (2, 12)).astype(np.int32))
    want = lm.generate(model["tp"], model["tcfg"], prompt, 6, 32)
    got = lm.generate(model["tp"], model["tcfg"], prompt, 6, 32,
                      caches=lm.init_caches(model["tcfg"], 2, 32, page_size=8,
                                            device="cpu"))
    np.testing.assert_array_equal(want.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# engine tier
# ---------------------------------------------------------------------------

def _waves():
    """Three waves of (rid, prompt): a shared 8-token system prompt with
    suffixes of 1-8 tokens; the system prompt alone and a repeat of a
    12-token prompt (both covered by published pages: copy-on-write); and
    independent prompts."""
    r = rng(5)
    system = r.integers(0, 256, 8).astype(np.int32)
    shared = [np.concatenate([system, r.integers(0, 256, n).astype(np.int32)])
              for n in (4, 1, 8, 3, 6)]
    cow = [system.copy(), shared[0].copy(),
           np.concatenate([system, r.integers(0, 256, 2).astype(np.int32)])]
    mixed = [r.integers(0, 256, int(n)).astype(np.int32)
             for n in r.integers(3, PROMPT + 1, 4)]
    waves, rid = [], 0
    for wave in (shared, cow, mixed):
        waves.append([(rid + i, p) for i, p in enumerate(wave)])
        rid += len(wave)
    return waves


def _serve(eng, cls, waves, tenant="default"):
    """Each wave through one warm engine; per wave the tokens by rid and the
    paging counters."""
    out = []
    for wave in waves:
        res, m = eng.run([cls(rid=rid, prompt=p, max_new_tokens=GEN,
                              tenant=tenant) for rid, p in wave])
        out.append(({r.rid: np.asarray(r.tokens) for r in res},
                    (m.prefill_tokens, m.prefix_hit_tokens, m.cow_copies,
                     m.pages_in_use, m.pages_free)))
    return out


def _ecfg_kw(mode, **kw):
    return dict(num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT,
                page_size=PAGE, **MODES[mode], **kw)


def _port(model, **kw):
    return ContinuousBatchingEngine(model["tp"], model["tcfg"],
                                    EngineConfig(device="cpu", **kw))


def _jax(model, **kw):
    return jengine.ContinuousBatchingEngine(
        model["jp"], model["jcfg"],
        jengine.EngineConfig(fff_backend="reference", **kw))


def _generate(model, prompt):
    out = lm.generate(model["tp"], model["tcfg"], t(prompt)[None], GEN, MAX_LEN)
    return out[0, len(prompt):].numpy()


@pytest.mark.parametrize("sharing", [True, False], ids=["sharing", "no_sharing"])
@pytest.mark.parametrize("mode", list(MODES))
def test_paged_engine_matches_jax_engine(model, mode, sharing):
    waves = _waves()
    kw = _ecfg_kw(mode, prefix_sharing=sharing)
    got = _serve(_port(model, **kw), Request, waves)
    want = _serve(_jax(model, **kw), JRequest, waves)
    for (gt, gc), (wt, wc), wave in zip(got, want, waves):
        assert gc == wc, (gc, wc)
        assert sorted(gt) == [rid for rid, _ in wave]
        for rid, _ in wave:
            np.testing.assert_array_equal(gt[rid], wt[rid], err_msg=f"rid {rid}")
        # prefilled + shared = every prompt token admitted
        assert gc[0] + gc[1] == sum(len(p) for _, p in wave)
    hits = sum(c[1] for _, c in got)
    cows = sum(c[2] for _, c in got)
    assert (hits > 0 and cows == 2) if sharing else (hits == cows == 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_engine_equals_contiguous_engine_and_generate(model, mode):
    waves = _waves()
    paged = _serve(_port(model, **_ecfg_kw(mode)), Request, waves)
    kw = _ecfg_kw(mode)
    kw["page_size"] = 0
    contiguous = _serve(_port(model, **kw), Request, waves)
    for (pt, _), (ct, cc), wave in zip(paged, contiguous, waves):
        assert cc[1] == cc[2] == 0                  # nothing to share
        for rid, prompt in wave:
            np.testing.assert_array_equal(pt[rid], ct[rid], err_msg=f"rid {rid}")
            np.testing.assert_array_equal(pt[rid], _generate(model, prompt),
                                          err_msg=f"rid {rid}")


def test_pool_exhaustion_backpressure_matches_jax(model):
    """Eight pages of four tokens fund one 22-token request (six pages) at a
    time: the rest wait in the queue, the index gives up pages under
    pressure, and the tokens are still the JAX engine's and generate's."""
    r = rng(6)
    wave = [(i, r.integers(0, 256, PROMPT).astype(np.int32)) for i in range(4)]
    wave.append((4, wave[0][1].copy()))
    kw = _ecfg_kw("monolithic", num_pages=8)
    eng = _port(model, **kw)
    (got, gc), = _serve(eng, Request, [wave])
    (want, wc), = _serve(_jax(model, **kw), JRequest, [wave])
    assert gc == wc and gc[3] + gc[4] == 8
    for rid, prompt in wave:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"rid {rid}")
        np.testing.assert_array_equal(got[rid], _generate(model, prompt))
    assert all(s is None for s in eng.slots)


def test_paged_engine_validates(model):
    with pytest.raises(ValueError, match="page_size"):
        _port(model, **dict(_ecfg_kw("monolithic"), page_size=MAX_LEN + 1))
    with pytest.raises(ValueError, match="cannot cover"):
        _port(model, **_ecfg_kw("monolithic", num_pages=5))
