"""The port's per-shape dispatch graphs (``serving/graphs.py``) on the CPU.

There is no capture here: the staged path (static input buffers, one
upload, cache leaves settled into the engine's canonical tensors) runs
the dispatch on every call, which is the code the card captures.  It must
leave the engine's caches and tokens bit-identical to ``graphs.disabled()``
(op by op) in every mode, admission with a copy-on-write page included;
``compiled_shapes()`` must count what the JAX engine counts for ``decode``,
``admit``, each ``prefill_<b>``, ``prefill_chunk`` and ``spec_round``; a
replay must credit the launch counters once (a stand-in recorder plays the
graph); and the capture rule must keep host-syncing dispatches eager.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import registry
from repro_torch.core import api
from repro_torch.distributed import act as dist_act
from repro_torch.kernels import common
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm
from repro_torch.serving import graphs
from repro_torch.serving.engine import (ContinuousBatchingEngine, EngineConfig,
                                       VirtualClock)
from repro_torch.serving.request import Request

torch.set_num_threads(2)

SLOTS, PROMPT, GEN, N_REQ, PAGE = 3, 16, 4, 4, 4
MAX_LEN = PROMPT + GEN + 1
SPEC = {"spec_k": 2, "draft_config": "self:1"}


@pytest.fixture(scope="module")
def model():
    jcfg = jregistry.get_config("internlm2-20b").reduced(n_layers=2)
    tcfg = registry.get_config("internlm2-20b").reduced(n_layers=2)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = np.random.default_rng(5)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 4.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                          device="cpu")
    # a shared 8-token system prompt, so paged runs map shared pages
    system = r.integers(0, jcfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([system, r.integers(
        0, jcfg.vocab_size, int(r.integers(1, PROMPT - 7))).astype(np.int32)])
        for _ in range(N_REQ)]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, prompts=prompts)


def requests(model, cls=Request, **kw):
    return [cls(rid=i, prompt=p, max_new_tokens=GEN, **kw)
            for i, p in enumerate(model["prompts"])]


def engine(model, **kw):
    return ContinuousBatchingEngine(model["tp"], model["tcfg"], EngineConfig(
        num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT, device="cpu",
        **kw))


@pytest.fixture
def one_thread():
    """Bit-identical runs on one thread: on two, the CPU's reductions do
    not sum in a fixed order, and two op-by-op runs already differ in the
    last bit of a cached K."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cache_leaves(eng):
    """Every cache tensor of both trees; a paged pool without its sink page,
    which takes every dropped write in no fixed order."""
    trees = [eng.caches] + ([eng.draft_caches] if eng.spec else [])
    pages = eng._num_pages if eng.ecfg.page_size else None
    return [t for tree in trees for c in tree
            for t in (c["kv"].k[:pages], c["kv"].v[:pages], c["kv"].table,
                      c["kv"].length)]


# ---------------------------------------------------------------------------
# staged against disabled()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("chunk", [0, 8], ids=["monolithic", "chunked"])
def test_staged_dispatches_equal_disabled(model, spec, paged, chunk, one_thread):
    """The engine's pools, tables, lengths and tokens after every step of a
    run are bit-identical staged and op by op; the staged run's decode or
    spec round, admission and each prefill slab's shape went through one
    entry each, the disabled run's through none."""
    kw = dict(prefill_chunk=chunk, **(SPEC if spec else {}),
              **(dict(page_size=PAGE) if paged else {}))
    runs = []
    for off in (False, True):
        eng = engine(model, **kw)
        for r in requests(model):
            eng.submit(r)
        steps = []
        with graphs.disabled() if off else contextlib.nullcontext():
            while eng.has_work():
                eng.step()
                steps.append([t.clone() for t in cache_leaves(eng)])
        runs.append((eng, steps))
    (staged, s_steps), (eager, e_steps) = runs
    assert len(s_steps) == len(e_steps)
    for i, (a, b) in enumerate(zip(s_steps, e_steps)):
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"step {i}"
    tok = lambda e: {r.rid: r.tokens.tolist() for r in e.results}
    assert tok(staged) == tok(eager) and len(staged.results) == N_REQ
    name = "spec_round" if spec else "decode"
    slabs = {"prefill_chunk" if k == "chunk" else k
             for k in eager.dispatch_shapes() if k == "chunk" or k.startswith("prefill_")}
    assert slabs and staged._graphs.counts() == dict.fromkeys({name, "admit"} | slabs, 1)
    assert eager._graphs.counts() == {}
    assert staged.dispatch_shapes() == eager.dispatch_shapes()
    assert staged.compiled_shapes()[name] == 1
    if paged:
        assert staged.n_prefix_hit_tokens > 0


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("chunk", [0, 8], ids=["monolithic", "chunked"])
def test_staged_admit_with_copy_on_write_equals_disabled(model, spec, chunk,
                                                         one_thread):
    """A prompt covered entirely by a finished prompt's shared pages (it
    arrives, on a virtual clock, once the first has finished) is admitted
    with a copy-on-write page through the staged ``admit`` dispatch: every
    request's tokens and the pools equal the op-by-op run's."""
    a = model["prompts"][0][:3 * PAGE]
    reqs = lambda: [Request(rid=0, prompt=a, max_new_tokens=GEN),
                    Request(rid=1, prompt=a.copy(), max_new_tokens=GEN,
                            arrival_time=0.5)]
    kw = dict(page_size=PAGE, prefill_chunk=chunk, **(SPEC if spec else {}))
    runs = []
    for off in (False, True):
        eng = ContinuousBatchingEngine(model["tp"], model["tcfg"], EngineConfig(
            num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT,
            device="cpu", **kw), clock=VirtualClock())
        with graphs.disabled() if off else contextlib.nullcontext():
            res, _ = eng.run(reqs())
        runs.append((eng, [r.tokens.tolist() for r in res]))
    (staged, s_tok), (eager, e_tok) = runs
    assert s_tok == e_tok and len(s_tok) == 2
    assert staged.n_cow_copies == eager.n_cow_copies == 1
    for x, y in zip(cache_leaves(staged), cache_leaves(eager)):
        assert torch.equal(x, y)
    assert staged._graphs.counts()["admit"] == 1


def test_entries_made_in_inference_mode_stage_outside_it(model):
    """A graph entry made inside ``torch.inference_mode`` stages its inputs
    outside it later: its buffers are normal tensors."""
    eng = engine(model)
    for r in requests(model):
        eng.submit(r)
    with torch.inference_mode():
        eng.step()
    while eng.has_work():
        eng.step()
    assert len(eng.results) == N_REQ and eng._graphs.counts() == {
        "decode": 1, "admit": 1, "prefill_16": 1}


def test_serve_loop_staged_equals_disabled(model, one_thread):
    """The fixed-batch loop's decode step goes through one staged entry and
    gives the op-by-op loop's tokens."""
    kw = dict(batch=2, prompt_len=8, gen=4, device="cpu", params=model["tp"])
    staged = serve_mod.serve(model["tcfg"], **kw)
    with graphs.disabled():
        eager = serve_mod.serve(model["tcfg"], **kw)
    assert torch.equal(staged.tokens, eager.tokens)
    assert (staged.graphs, eager.graphs) == ({"decode": 1}, {})


# ---------------------------------------------------------------------------
# compiled_shapes() against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("chunk", [0, 8], ids=["monolithic", "chunked"])
def test_compiled_shapes_match_jax(model, spec, chunk):
    """For the same requests, the port's captured (here: staged) graphs per
    dispatch equal the JAX engine's compiled traces for every dispatch JAX
    counts: ``decode``, ``admit``, each bucket's ``prefill_<b>`` (0 for a
    bucket never used), ``prefill_chunk`` and the spec round."""
    kw = dict(prefill_chunk=chunk, **(SPEC if spec else {}))
    jeng = jengine.ContinuousBatchingEngine(
        model["jp"], model["jcfg"], jengine.EngineConfig(
            num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT,
            fff_backend="reference", **kw))
    jeng.run(requests(model, JRequest))
    eng = engine(model, **kw)
    eng.run(requests(model))
    want, got = jeng.compiled_shapes(), eng.compiled_shapes()
    assert {"decode", "admit", "prefill_16"} <= set(want)
    for name in want:
        assert got.get(name, 0) == want[name], (name, got, want)
    assert want["spec_round" if spec else "decode"] == want["admit"] == 1
    assert want.get("prefill_chunk", 0) == (1 if chunk else 0)
    assert set(got) <= set(want), (got, want)


def test_sampling_keys_its_own_graph(model, one_thread):
    """Sampled and greedy rounds are two keys (the sampled round draws on
    the device); a run that does both counts two spec-round graphs, and the
    staged run's sampled tokens equal the op-by-op run's.  The last request
    samples, and joins once the greedy ones have run rounds alone."""
    reqs = lambda: [dataclasses.replace(
        r, temperature=0.8 if r.rid == N_REQ - 1 else 0.0)
        for r in requests(model)]
    eng = engine(model, **SPEC, seed=3)
    got, _ = eng.run(reqs())
    with graphs.disabled():
        want, _ = engine(model, **SPEC, seed=3).run(reqs())
    assert eng.compiled_shapes()["spec_round"] == 2
    assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]


# ---------------------------------------------------------------------------
# launch counts across replays
# ---------------------------------------------------------------------------

class ReplayingRecorder:
    """Stands in for a CUDA graph: capture runs the function once, as a real
    capture enqueues it (the wrappers count as they enqueue), and a replay
    re-invokes it into the captured outputs with its Python counting undone,
    since a real replay runs no Python."""

    def __init__(self, generators):
        self.generators = generators
        self.replays = 0

    def capture(self, run, stream):
        self.run, self.out = run, run()
        return self.out

    def replay(self):
        state = common.count_state()
        new = self.run()
        common.credit(common.counts_since(state), -1)
        for k, v in new.items():
            self.out[k].copy_(v)
        self.replays += 1


def test_every_replay_credits_the_launch_counters_once(monkeypatch):
    kern = common.Kernel("fake_kernel", "none.cu", "fake", [], "none")
    kern._fn = lambda *a: 0
    monkeypatch.setitem(common.KERNELS, kern.name, kern)
    common.reset_launch_counts()

    def dispatch(inp):
        kern.launch()
        kern.paths["tma"] = kern.paths.get("tma", 0) + 1
        return {"y": inp["x"] * 2, "none": None}

    recorders = []
    cache = graphs.DispatchCache(
        "cpu", recorder=lambda gens: recorders.append(ReplayingRecorder(gens))
        or recorders[-1])
    for i in range(5):
        x = np.full((3,), i, np.float32)
        out = cache.run("decode", ((3,), False, ()), dispatch, {"x": x})
        assert set(out) == {"y"}
        np.testing.assert_array_equal(out["y"].numpy(), 2 * x)
        # the first call ran once and captured (taken back); each later call
        # is a replay, credited once
        assert common.launch_counts()["fake_kernel"] == i + 1
        assert common.path_counts()["fake_kernel"] == {"tma": i + 1}
    assert recorders[0].replays == 4 and cache.counts() == {"decode": 1}
    with graphs.disabled():
        cache.run("decode", ((3,), False, ()), dispatch, {"x": x})
    assert common.launch_counts()["fake_kernel"] == 6
    common.reset_launch_counts()


def test_staging_refuses_inputs_off_the_key():
    cache = graphs.DispatchCache("cpu")
    fn = lambda inp: {"y": inp["x"] + 1}
    cache.run("d", ("k",), fn, {"x": np.zeros((2,), np.int32)})
    for bad in ({"x": np.zeros((3,), np.int32)}, {"x": np.zeros((2,), np.int64)},
                {"x": None}, {"z": np.zeros((2,), np.int32)}):
        with pytest.raises(ValueError):
            cache.run("d", ("k",), fn, bad)


def test_settle_copies_into_the_canonical_tree():
    kv = lambda n: lm.init_caches(registry.get_config("internlm2-20b").reduced(
        n_layers=n), 2, 8, device="cpu")
    canon, new = kv(2), kv(2)
    ids = [id(c["kv"].length) for c in canon]
    new[1]["kv"] = new[1]["kv"]._replace(length=torch.tensor([3, 5], dtype=torch.int32))
    assert graphs.settle(canon, new) is canon
    assert [id(c["kv"].length) for c in canon] == ids
    assert canon[1]["kv"].length.tolist() == [3, 5]
    new[0]["kv"] = new[0]["kv"]._replace(length=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        graphs.settle(canon, new)
    with pytest.raises(ValueError):
        graphs.settle(canon, kv(1))


# ---------------------------------------------------------------------------
# the capture rule
# ---------------------------------------------------------------------------

def test_capture_rule(model):
    p, cfg = model["tp"], model["tcfg"]
    assert graphs.eager_reason(p, cfg, 8, 1) is None            # fused decode
    assert graphs.eager_reason(p, cfg, 8, 4) is None            # 32-token verify
    assert graphs.eager_reason(p, cfg, 11, 3) is None           # grouped GEMMs
    assert graphs.eager_reason(p, cfg, 8, 128) is None          # a prefill bucket
    with api.overrides(backend="grouped", mode="infer"):
        assert graphs.eager_reason(p, cfg, 8, 1) is None
    with api.overrides(backend="reference", mode="infer"):
        assert "'reference'" in graphs.eager_reason(p, cfg, 8, 16)
    with dist_act.groups_installed((object(), None)):
        assert "process group" in graphs.eager_reason(p, cfg, 8, 1)
    # learned positions take the step's offset as a staged input, and a
    # MoE site runs the grouped GEMMs at shapes the token count fixes
    learned = dataclasses.replace(cfg, pos_emb="learned")
    assert graphs.eager_reason(p, learned, 8, 1) is None
    moe = registry.get_config("olmoe-1b-7b", ffn="native").reduced(n_layers=1)
    mp = lm.init(moe, seed=0, device="cpu")
    assert graphs.eager_reason(mp, moe, 2, 1) is None
    assert graphs.eager_reason(mp, moe, 2, 16) is None
    with dist_act.groups_installed((object(), None)):
        assert "process group" in graphs.eager_reason(mp, moe, 2, 1)


@pytest.fixture(scope="module")
def moe_model():
    cfg = registry.get_config("olmoe-1b-7b", ffn="native").reduced(n_layers=1)
    r = np.random.default_rng(9)
    prompts = [r.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in r.integers(4, PROMPT + 1, N_REQ)]
    return dict(tp=lm.init(cfg, seed=0, device="cpu"), tcfg=cfg, prompts=prompts)


@pytest.mark.parametrize("kw, eager", [
    (dict(num_slots=11, **SPEC), None),                       # 33-token verify
    (dict(fff_backend="grouped", **SPEC), None),
    (dict(fff_backend="grouped"), None),
    (dict(), "moe"),                                          # a MoE site
])
def test_engine_keeps_syncing_dispatches_eager(model, moe_model, kw, eager):
    """The grouped paths are captured at every slab now, and so is a MoE
    model's decode step, prefill bucket and admission: its sites run the
    grouped GEMMs at shapes the slab fixes."""
    m = moe_model if eager == "moe" else model
    eng = ContinuousBatchingEngine(m["tp"], m["tcfg"], EngineConfig(
        **{**dict(num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT,
                  device="cpu"), **kw}))
    res, _ = eng.run(requests(m))
    assert len(res) == N_REQ
    counts, shapes = eng._graphs.counts(), eng.compiled_shapes()
    step = "spec_round" if "spec_k" in kw else "decode"
    assert counts == {step: 1, "admit": 1, "prefill_16": 1}
    if eager == "moe":
        assert shapes == {"decode": 1, "admit": 1, "prefill_16": 1}
