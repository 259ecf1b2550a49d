"""The serving dispatches that used to run op by op, at static shapes, on
the CPU: MoE sites on the grouped GEMMs, learned positions from a 0-dim
offset, and the cluster decode worker's padded ``install``.

* ``core/moe.forward_sparse`` against the JAX package's ``forward_sparse``
  (the ``kernel`` tolerance of ``tests/conftest.py``, float32) under
  balanced gates, every token on the same experts (the overflow pass
  runs), a slab within an expert's capacity and a single token; under
  balanced and one-expert routing it runs one op-and-shape sequence and no
  op that reads a value on the host (``test_torch_static_dispatch``'s
  recorder).
* ``nn/embeddings.learned_pos`` with a 0-dim tensor offset against JAX's
  scalar window (``lax.dynamic_slice_in_dim``), a window past the table
  included, with no host read.
* A reduced whisper loop, its decode step staged with the step's offset
  as an input, gives JAX's greedy tokens, inside the position table and
  past its end.
* A handoff installed through the padded ``install`` dispatch leaves the
  cache rows, tables and lengths JAX's ``install`` leaves.
* A reduced olmoe-native engine stages ``decode``, ``prefill_16`` and
  ``admit`` and gives the JAX engine's greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_close
from test_torch_static_dispatch import recorded
from repro.cluster import handoff as jhandoff
from repro.configs import registry as jregistry
from repro.core import moe as jmoe
from repro.data import tokens as jtokens
from repro.models import lm as jlm
from repro.nn import embeddings as jembeddings
from repro.serving import engine as jengine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.cluster import handoff
from repro_torch.configs import registry
from repro_torch.core import moe
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm
from repro_torch.nn import embeddings
from repro_torch.serving import graphs
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import Request

torch.set_num_threads(2)


def t(a):
    return weights.tensor(np.asarray(a, np.float32), device="cpu")


def drawn(jcfg, seed, scale=4.0):
    """numpy draws for a JAX model's parameter tree: scales 1, the rest
    N(0, 1/scale^2)."""
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / scale, s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------------------
# forward_sparse on the grouped GEMMs
# ---------------------------------------------------------------------------

D, H, O = 12, 10, 8
#: (experts, top k, tokens, every token on experts 0..k-1)
CASES = {"balanced": (16, 2, 64, False),
         "one expert": (8, 1, 40, False),
         "same experts": (16, 2, 64, True),
         "B <= C": (16, 2, 8, False),
         "B = 1": (4, 2, 1, False)}


def moe_case(name, bias=False, seed=0):
    E, k, B, tied = CASES[name]
    kw = dict(dim_in=D, dim_out=O, num_experts=E, expert_width=H, top_k=k,
              bias=bias)
    jcfg, tcfg = jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)
    shapes = jax.eval_shape(lambda: jmoe.init(jax.random.PRNGKey(0), jcfg))
    r = np.random.default_rng(seed)
    p = {n: (r.normal(size=s.shape) / 2.0).astype(np.float32)
         for n, s in shapes.items()}
    x = r.normal(size=(B, D)).astype(np.float32)
    if tied or name == "one expert":
        # zero gates tie every expert: each token takes experts 0..k-1
        p["gate_w"][:] = 0.0
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_sparse_matches_jax(name, bias):
    """Every pair is evaluated: the expert indices exactly and the outputs
    within the kernel tolerance, with the overflow pass where B > C."""
    jcfg, tcfg, p, x = moe_case(name, bias)
    E, k, B, _ = CASES[name]
    C = moe.capacity(B, tcfg)
    assert (moe.overflow_rows(B, tcfg) > 0) == (name in ("balanced", "one expert",
                                                         "same experts"))
    assert C <= -(-B // 8) * 8
    jy, jaux = jax.jit(lambda p, x: jmoe.forward_sparse(p, jcfg, x))(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    y, aux = moe.forward_sparse({n: t(v) for n, v in p.items()}, tcfg, t(x))
    np.testing.assert_array_equal(aux["expert_idx"].numpy(), np.asarray(jaux["expert_idx"]))
    if name in ("one expert", "same experts"):
        assert int((aux["expert_idx"][:, 0] == 0).sum()) == B > C
    assert_close(y.numpy(), np.asarray(jy))


def test_forward_sparse_one_sequence_no_host_read():
    """Balanced and every-token-on-the-same-experts routing run the same
    ops at the same shapes, the overflow pass's (E, 64, D) buffers
    included, and none reads a value on the host."""
    runs = []
    for name in ("balanced", "same experts"):
        _, tcfg, p, x = moe_case(name)
        (y, aux), rec = recorded(lambda: moe.forward_sparse(
            {n: t(v) for n, v in p.items()}, tcfg, t(x)))
        runs.append(rec)
    assert runs[0].host_reads == [] and runs[1].host_reads == []
    assert runs[0].ops == runs[1].ops
    rows = moe.overflow_rows(64, tcfg)
    assert rows == 64 and any((16, rows, D) in s for _, s in runs[0].ops)


# ---------------------------------------------------------------------------
# learned positions from a device offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 5, 56, 58, 200, -3])
def test_learned_pos_tensor_offset_matches_jax(offset):
    """A 0-dim tensor offset takes JAX's clamped scalar window (58 and 200
    run past the 64-row table, -3 before it) and reads nothing on the
    host; it equals the int offset's window."""
    r = np.random.default_rng(1)
    table = r.normal(size=(64, 16)).astype(np.float32)
    x = r.normal(size=(3, 8, 16)).astype(np.float32)
    want = jax.jit(lambda p, x, o: jembeddings.learned_pos(p, x, o))(
        {"pos": jnp.asarray(table)}, jnp.asarray(x), jnp.int32(offset))
    off = torch.tensor(offset, dtype=torch.int32)
    got, rec = recorded(lambda: embeddings.learned_pos({"pos": t(table)}, t(x), off))
    assert rec.host_reads == []
    assert_close(got.numpy(), np.asarray(want))
    assert torch.equal(got, embeddings.learned_pos({"pos": t(table)}, t(x), offset))


@pytest.mark.parametrize("plen", [8, 60], ids=["inside", "past the table"])
def test_whisper_loop_staged_matches_jax(plen):
    """The reduced whisper loop (learned decoder positions, a 64-row table,
    drawn large enough that each step's row moves its token) stages its
    decode step once, the step's position a staged input, and gives JAX's
    greedy tokens and the op-by-op loop's, inside the table and with its
    last steps past the table's end."""
    jcfg = jregistry.get_config("whisper-small").reduced(n_layers=2)
    tcfg = registry.get_config("whisper-small").reduced(n_layers=2)
    jp = drawn(jcfg, 3, scale=8.0)
    jp["pos"]["pos"] = jp["pos"]["pos"] * 16.0
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    n, gen = 2, 6
    src = jtokens.MarkovTokenSource(jcfg.vocab_size, seed=0)
    batch = {"tokens": jnp.asarray(src.sample(n, plen, seed=1)[:, :plen]),
             "enc_embeds": jnp.asarray(np.random.default_rng(0).normal(
                 0, 1, (n, jcfg.encoder.seq_len, jcfg.d_model)), jnp.float32)}
    logits, caches = jax.jit(lambda p, b, c: jlm.prefill(p, jcfg, b, c))(
        jp, batch, jlm.init_caches(jcfg, n, plen + gen + 1))
    step = jax.jit(lambda p, x, c, i: jlm.decode_step(p, jcfg, x, c, i))
    want = [jnp.argmax(logits, -1)]
    for i in range(gen):
        logits, caches = step(jp, want[-1][:, None].astype(jnp.int32), caches,
                              jnp.int32(plen + i))
        want.append(jnp.argmax(logits, -1))
    kw = dict(batch=n, prompt_len=plen, gen=gen, device="cpu", params=tp)
    res = serve_mod.serve(tcfg, **kw)
    with graphs.disabled():
        eager = serve_mod.serve(tcfg, **kw)
    assert res.graphs == {"decode": 1} and eager.graphs == {}
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(want, axis=1))
    assert torch.equal(res.tokens, eager.tokens)


# ---------------------------------------------------------------------------
# the cluster decode worker's install
# ---------------------------------------------------------------------------

PAGE, SLOTS, MAX_LEN, PROMPT = 4, 2, 24, 16


def test_padded_install_matches_jax():
    """One synthetic handoff (prompt 7 tokens: 2 pages shipped, 4 funded)
    into slot 0 of each package's paged engine, then a second into slot 1:
    the port's pools (its sink page aside), tables and lengths equal
    JAX's, and its ``install`` is one staged dispatch."""
    jcfg = jregistry.get_config("internlm2-20b").reduced(n_layers=2)
    tcfg = registry.get_config("internlm2-20b").reduced(n_layers=2)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    jp = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    jeng = jengine.ContinuousBatchingEngine(jp, jcfg, jengine.EngineConfig(
        num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT, page_size=PAGE,
        fff_backend="reference"))
    eng = ContinuousBatchingEngine(lm.init(tcfg, seed=0, device="cpu"), tcfg,
                                   EngineConfig(num_slots=SLOTS, max_len=MAX_LEN,
                                                max_prompt_len=PROMPT,
                                                page_size=PAGE, device="cpu"))
    P, L = len(tcfg.period), tcfg.n_layers
    kv = eng.caches[0]["kv"]
    r = np.random.default_rng(2)
    # a non-speculative JAX engine installs through jax.jit(lm.cache_install),
    # whose compile cache every such engine in the process shares; JAX's
    # own cluster tests count its entries, so this test's are dropped
    try:
        for rid, plen in enumerate((7, 12)):
            n_pages = -(-plen // PAGE)
            shape = (n_pages,) + tuple(kv.k.shape[1:])
            k = [r.normal(size=shape).astype(np.float32) for _ in range(L)]
            v = [r.normal(size=shape).astype(np.float32) for _ in range(L)]
            prompt = list(range(plen))
            h = handoff.KVHandoff(
                request=Request(rid=rid, prompt=prompt, max_new_tokens=6), tokens=[3],
                prompt_len=plen, page_size=PAGE, n_pages=n_pages,
                k_rows=[torch.from_numpy(a) for a in k], v_rows=[torch.from_numpy(a) for a in v])
            stack = lambda rows: [np.stack(rows[p::P]) for p in range(P)]
            jh = jhandoff.KVHandoff(
                request=JRequest(rid=rid, prompt=prompt, max_new_tokens=6), tokens=[3],
                prompt_len=plen, page_size=PAGE, n_pages=n_pages, k_rows=stack(k),
                v_rows=stack(v))
            assert handoff.install(eng, h) == jhandoff.install(jeng, jh) == rid
    finally:
        jax.clear_caches()
    assert eng._graphs.counts() == {"install": 1}
    assert eng.compiled_shapes() == {"install": 1}
    n = jeng._num_pages
    for i, c in enumerate(eng.caches):
        jkv = jeng.caches[i % P]["kv"]
        for name in ("k", "v", "table", "length"):
            got = getattr(c["kv"], name)
            got = got[:n] if name in ("k", "v") else got
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jkv, name)[i // P]))


# ---------------------------------------------------------------------------
# a MoE model's engine
# ---------------------------------------------------------------------------

def test_olmoe_engine_stages_its_dispatches_and_matches_jax():
    """The reduced olmoe-native engine (4 experts, top 2, at every layer)
    stages decode, its 16-token bucket and admission, and each request's
    greedy tokens equal the JAX engine's."""
    jcfg = jregistry.get_config("olmoe-1b-7b", "native").reduced(n_layers=1)
    tcfg = registry.get_config("olmoe-1b-7b", ffn="native").reduced(n_layers=1)
    jp = drawn(jcfg, 7)
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    r = np.random.default_rng(8)
    prompts = [r.integers(0, tcfg.vocab_size, int(n)).astype(np.int32)
               for n in r.integers(4, PROMPT + 1, 4)]
    kw = dict(num_slots=3, max_len=PROMPT + 6, max_prompt_len=PROMPT)
    jeng = jengine.ContinuousBatchingEngine(jp, jcfg, jengine.EngineConfig(
        fff_backend="reference", **kw))
    want, _ = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=5)
                        for i, p in enumerate(prompts)])
    eng = ContinuousBatchingEngine(tp, tcfg, EngineConfig(device="cpu", **kw))
    got, _ = eng.run([Request(rid=i, prompt=p, max_new_tokens=5)
                      for i, p in enumerate(prompts)])
    assert eng._graphs.counts() == {"decode": 1, "prefill_16": 1, "admit": 1}
    assert [r.tokens.tolist() for r in got] == [np.asarray(r.tokens).tolist()
                                                for r in want]
