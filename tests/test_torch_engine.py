"""The port's continuous-batching engine against the JAX package's, on the
CPU.

One tiny config (the 2-layer ``internlm2-20b`` FFF ``reduced`` model,
float32) carries the same numpy-drawn weights into both packages
(``repro_torch.weights.from_jax``).  The JAX engine runs on its
``reference`` backend (its ``grouped`` default drops tokens over capacity);
the port's greedy tokens must equal it request for request in monolithic,
chunked and speculative modes, and equal the port's own ``lm.generate``
under auto resolution and with the resolver driven down its CUDA branches
(whose wrappers run the plain versions here).  Both engines also run on
their ``grouped`` backend (the default "drop" at cf 2.0, and "exact_dense"
at cf 0.5): the same tokens, overflow means and repair counts.  Also: the
chunk slabs' logits and rollback, rejection sampling, the schedulers, EOS,
the fixed-shape contract, the metrics and the CLI.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro.serving import spec as jspec
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import registry
from repro_torch.core import api
from repro_torch.kernels.fused_fff import ops as f_ops
from repro_torch.kernels.leaf_gemm import ops as g_ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm
from repro_torch.serving import scheduler as sched
from repro_torch.serving import spec
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import Request

torch.set_num_threads(2)

SLOTS, PROMPT, GEN, N_REQ = 3, 24, 6, 5
MAX_LEN = PROMPT + GEN + 1
MODES = {"monolithic": {}, "chunked": {"prefill_chunk": 8},
         "spec": {"spec_k": 2, "draft_config": "self:1"}}


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, kind="e2e"):
    rtol, atol = dtype_tol(jnp.float32, kind)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


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
    prompts = [r.integers(0, jcfg.vocab_size, int(r.integers(5, PROMPT + 1))
                          ).astype(np.int32) for _ in range(N_REQ)]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, prompts=prompts,
                jax_tokens={})


def requests(model, cls=Request, **kw):
    return [cls(rid=i, prompt=p, max_new_tokens=GEN, **kw)
            for i, p in enumerate(model["prompts"])]


def jax_tokens(model, mode):
    """The JAX engine's greedy tokens per rid (computed once per mode)."""
    if mode not in model["jax_tokens"]:
        eng = jengine.ContinuousBatchingEngine(
            model["jp"], model["jcfg"], jengine.EngineConfig(
                num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT,
                fff_backend="reference", **MODES[mode]))
        res, _ = eng.run(requests(model, JRequest))
        model["jax_tokens"][mode] = {r.rid: np.asarray(r.tokens) for r in res}
    return model["jax_tokens"][mode]


def engine(model, mode="monolithic", **kw):
    ecfg = EngineConfig(num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT,
                        device="cpu", **{**MODES[mode], **kw})
    return ContinuousBatchingEngine(model["tp"], model["tcfg"], ecfg)


def generate(model, prompt, steps=GEN):
    with torch.inference_mode():
        out = lm.generate(model["tp"], model["tcfg"],
                          torch.from_numpy(prompt)[None], steps, MAX_LEN)
    return out[0, len(prompt):].numpy()


@pytest.fixture(params=["auto", "kernels"])
def resolution(request, monkeypatch):
    """auto: CPU tensors resolve to the reference backend.  kernels: the
    resolver takes its CUDA branches, and every backend call is recorded."""
    ran = []
    for key, fn in list(api._REGISTRY.items()):
        monkeypatch.setitem(api._REGISTRY, key,
                            lambda *a, _fn=fn, _n=key[1]: (ran.append(_n), _fn(*a))[1])
    if request.param == "kernels":
        monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    return request.param, ran


# ---------------------------------------------------------------------------
# end to end: the JAX engine, lm.generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(model, mode):
    res, m = engine(model, mode).run(requests(model))
    want = jax_tokens(model, mode)
    assert [r.rid for r in res] == list(range(N_REQ))
    for r in res:
        np.testing.assert_array_equal(r.tokens, want[r.rid], err_msg=f"rid {r.rid}")
        assert r.finish_reason == "length"
    assert m.n_requests == N_REQ and m.n_tokens == N_REQ * GEN


@pytest.mark.parametrize("mode", list(MODES) + ["leaf_aware"])
def test_engine_matches_generate(model, mode, resolution):
    kw = {"scheduler": "leaf_aware", "spec_k": 3} if mode == "leaf_aware" else {}
    eng = engine(model, "monolithic" if mode == "leaf_aware" else mode, **kw)
    res, _ = eng.run(requests(model))
    for r in res:
        np.testing.assert_array_equal(r.tokens, generate(model, r.prompt),
                                      err_msg=f"rid {r.rid}")
    name, ran = resolution
    want = ({"cuda", "cuda_decode"} if name == "kernels" else {"reference"})
    assert set(ran) == want


def test_spec_round_takes_the_gathered_branch(model, monkeypatch):
    """With the resolver on its CUDA branches: draft steps run the fused
    decode backend, each verify slab (3 slots x 3 tokens) the gathered
    branch once per layer, and admission slabs (3 x 16 or 3 x 24 tokens)
    the grouped branch."""
    monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    calls = {"gathered": [], "grouped": [], "fused": []}
    for mod, name, tag in ((f_ops, "fff_decode", "gathered"),
                           (g_ops, "fff_infer", "grouped")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda x, *a, _fn=fn, _t=tag, **kw:
                            (calls[_t].append(x.shape[0]), _fn(x, *a, **kw))[1])
    fd = api.get_backend("infer", "cuda_decode")
    monkeypatch.setitem(api._REGISTRY, ("infer", "cuda_decode"),
                        lambda p, c, x, s: (calls["fused"].append(x.shape), fd(p, c, x, s))[1])
    eng = engine(model, "spec")
    res, m = eng.run(requests(model))
    layers, k = model["tcfg"].n_layers, 2
    rounds = m.n_steps
    assert calls["gathered"] == [SLOTS * (k + 1)] * (layers * rounds)
    # each admission runs the target's 2 layers and the 1-layer draft
    assert len(calls["grouped"]) == 3 * N_REQ
    assert set(calls["grouped"]) <= {SLOTS * 16, SLOTS * 24}
    assert calls["fused"] == [(SLOTS, 1, model["tcfg"].d_model)] * (rounds * (k + 1))


# ---------------------------------------------------------------------------
# the chunk slabs against JAX
# ---------------------------------------------------------------------------

def test_prefill_and_verify_chunks_match_jax(model):
    """A chunk slab at per-row offsets, a verify slab, a rollback and a
    second verify: logits at every valid position and the cache lengths
    match the JAX package's."""
    jcfg, tcfg, jp, tp = model["jcfg"], model["tcfg"], model["jp"], model["tp"]
    r = rng(9)
    chunk = r.integers(0, jcfg.vocab_size, (SLOTS, 8)).astype(np.int32)
    v1 = np.array([8, 5, 0], np.int32)
    verify = r.integers(0, jcfg.vocab_size, (SLOTS, 3)).astype(np.int32)
    v2 = np.array([3, 2, 0], np.int32)
    back = np.array([9, 5, 0], np.int32)
    again = r.integers(0, jcfg.vocab_size, (SLOTS, 3)).astype(np.int32)

    jchunk = jax.jit(lambda p, t, v, c: jlm.prefill_chunk(p, jcfg, t, v, c, c[0]["kv"].length[0]))
    jverify = jax.jit(lambda p, t, v, c: jlm.verify_chunk(p, jcfg, t, v, c, c[0]["kv"].length[0]))
    jc = jlm.init_caches(jcfg, SLOTS, MAX_LEN)
    jl1, jc, _ = jchunk(jp, chunk, v1, jc)
    jl2, jc, _ = jverify(jp, verify, v2, jc)
    jc = jlm.set_cache_lengths(jc, jnp.asarray(back))
    jl3, jc, _ = jverify(jp, again, v2, jc)

    tc = lm.init_caches(tcfg, SLOTS, MAX_LEN, device="cpu")
    t = torch.from_numpy
    with torch.inference_mode():
        tl1, tc, _ = lm.prefill_chunk(tp, tcfg, t(chunk), t(v1), tc)
        tl2, tc, _ = lm.verify_chunk(tp, tcfg, t(verify), t(v2), tc)
        tc = lm.set_cache_lengths(tc, t(back))
        tl3, tc, _ = lm.verify_chunk(tp, tcfg, t(again), t(v2), tc)
    close(tl1[:2], np.asarray(jl1)[:2])
    assert tl2.shape == (SLOTS, 3, jcfg.vocab_size)
    close(tl2[0], np.asarray(jl2)[0])
    close(tl2[1, :2], np.asarray(jl2)[1, :2])
    close(tl3[0], np.asarray(jl3)[0])
    close(tl3[1, :2], np.asarray(jl3)[1, :2])
    for c, jcc in zip(tc, [jax.tree_util.tree_map(lambda a: a[i], jc[0])
                           for i in range(tcfg.n_layers)]):
        np.testing.assert_array_equal(c["kv"].length.numpy(),
                                      np.asarray(jcc["kv"].length))
        np.testing.assert_array_equal(c["kv"].length.numpy(), back + v2)


def test_cache_admit_restarts_rows(model):
    tc = lm.init_caches(model["tcfg"], SLOTS, MAX_LEN, device="cpu")
    tc = lm.set_cache_lengths(tc, torch.tensor([4, 7, 9]))
    tc = lm.cache_admit(tc, torch.tensor([False, True, False]))
    for c in tc:
        assert c["kv"].length.tolist() == [4, 0, 9]
        assert c["kv"].length.dtype == torch.int32


# ---------------------------------------------------------------------------
# rejection sampling
# ---------------------------------------------------------------------------

def test_rejection_sample_greedy_chain():
    r = rng(10)
    p = r.normal(size=(4, 11))
    chain = p.argmax(-1)
    for n_ok in range(4):
        drafts = chain[:3].copy()
        if n_ok < 3:
            drafts[n_ok] = (chain[n_ok] + 1) % 11
        got = spec.rejection_sample(p, r.normal(size=(3, 11)), drafts, 0.0)
        assert got == jspec.rejection_sample(p, None, drafts, 0.0)
        assert got == (list(chain[:n_ok + 1]), n_ok)


def test_rejection_sample_preserves_the_target_distribution():
    """The first emitted token is distributed as softmax(p / T), whatever
    the draft proposed; the port and JAX consume one rng stream alike."""
    r = rng(11)
    p, q = r.normal(size=(2, 5)), r.normal(size=(1, 5))
    T, n = 0.7, 20000
    qd = np.exp(q[0] / T) / np.exp(q[0] / T).sum()
    draws = np.random.default_rng(12).choice(5, size=n, p=qd)
    a, b = np.random.default_rng(13), np.random.default_rng(13)
    firsts = []
    for d in draws:
        got = spec.rejection_sample(p, q, d[None], T, a)
        assert got == jspec.rejection_sample(p, q, d[None], T, b)
        firsts.append(got[0][0])
    want = np.exp(p[0] / T) / np.exp(p[0] / T).sum()
    freq = np.bincount(firsts, minlength=5) / n
    np.testing.assert_allclose(freq, want, atol=0.015)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

def _views(occ, active, E=4):
    kw = dict(occupancy=occ, active=active, num_leaves=E, capacity_factor=None,
              num_slots=len(active))
    return sched.SchedulerView(**kw), jsched.SchedulerView(**kw)


def test_fcfs_admits_in_arrival_order():
    reqs = [Request(rid=i, prompt=[1, 2]) for i in range(5)]
    view, _ = _views(np.zeros((4, 4)), np.zeros(4, bool))
    assert [r.rid for r in sched.make_scheduler("fcfs").select(reqs, 3, view)] \
        == [0, 1, 2]


def test_leaf_aware_matches_jax_and_is_deterministic():
    r = rng(14)
    hints = [r.random(4) for _ in range(9)]
    occ = np.zeros((4, 4))
    occ[0], occ[1] = [1, 0, 0, 0], [0.7, 0.3, 0, 0]
    view, jview = _views(occ, np.array([True, True, False, False]))
    picks = []
    for _ in range(2):
        s = sched.make_scheduler("leaf_aware", window=6)
        reqs = [Request(rid=i, prompt=[1], leaf_hint=h) for i, h in enumerate(hints)]
        picks.append([q.rid for q in s.select(reqs, 2, view)])
    j = jsched.make_scheduler("leaf_aware", window=6)
    jreqs = [JRequest(rid=i, prompt=[1], leaf_hint=h) for i, h in enumerate(hints)]
    assert picks[0] == picks[1] == [q.rid for q in j.select(jreqs, 2, jview)]
    assert picks[0] != [0, 1]                   # it did reorder


def test_leaf_aware_max_hold_bounds_starvation():
    """The head's footprint piles onto the loaded leaf, so every other
    candidate wins, until its hold count reaches max_hold."""
    occ = np.zeros((2, 4))
    occ[0] = [1, 0, 0, 0]
    view, _ = _views(occ, np.array([True, False]))
    s = sched.make_scheduler("leaf_aware", max_hold=3)
    head = Request(rid=0, prompt=[1], leaf_hint=[1, 0, 0, 0])
    queue = [head] + [Request(rid=i, prompt=[1], leaf_hint=[0, 1, 1, 1])
                      for i in range(1, 10)]
    rounds = 0
    while head in queue:
        pick = s.select(queue, 1, view)[0]
        queue.remove(pick)
        rounds += 1
    assert rounds == 4                          # 3 bypasses, then forced


# ---------------------------------------------------------------------------
# EOS, shapes, metrics, validation, sampling, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["monolithic", "spec"])
def test_eos_stops_a_request(model, mode):
    prompt = model["prompts"][1]
    chain = generate(model, prompt)
    eos = int(chain[2])
    cut = list(chain).index(eos) + 1
    res, _ = engine(model, mode).run(
        [Request(rid=0, prompt=prompt, max_new_tokens=GEN, eos_id=eos),
         Request(rid=1, prompt=model["prompts"][0], max_new_tokens=GEN)])
    assert res[0].finish_reason == "eos"
    np.testing.assert_array_equal(res[0].tokens, chain[:cut])
    np.testing.assert_array_equal(res[1].tokens,
                                  generate(model, model["prompts"][0]))


@pytest.mark.parametrize("mode", list(MODES))
def test_dispatch_shapes_hold_the_fixed_shape_contract(model, mode):
    eng = engine(model, mode)
    eng.run(requests(model))
    shapes = eng.dispatch_shapes()
    buckets = {f"prefill_{b}" for b in (16, 24)}
    if mode == "chunked":
        assert shapes.pop("chunk") == {(SLOTS, 8)}
    else:
        for b in buckets & set(shapes):
            assert shapes.pop(b) == {(SLOTS, int(b.split("_")[1]))}
    if mode == "spec":
        assert shapes.pop("draft") == {(SLOTS, 1)}
        assert shapes.pop("verify") == {(SLOTS, 3)}
    else:
        assert shapes.pop("decode") == {(SLOTS, 1)}
    assert not shapes


def test_metrics_fields(model):
    eng = engine(model, "spec", prefill_chunk=8)
    for r in requests(model):
        eng.submit(r)
    live = eng.poll_metrics()
    assert live.queue_depth == N_REQ and live.active_slots == 0
    eng.step()
    live = eng.poll_metrics()
    assert live.queue_depth == N_REQ - 2 and live.active_slots == 2
    assert live.prefilling_slots == 2 - sum(
        s is not None and not s.prefilling for s in eng.slots)
    while eng.has_work():
        eng.step()
    m = eng.poll_metrics()
    assert m.n_requests == N_REQ and m.n_tokens == N_REQ * GEN
    assert m.queue_depth == m.active_slots == 0
    assert m.n_chunks > 0 and m.prefill_tokens == sum(map(len, model["prompts"]))
    assert 0 < m.accepted_tokens <= m.draft_tokens == sum(
        r.n_drafted for r in eng.results)
    assert m.ttft.n == m.e2e.n == N_REQ and m.decode_step.n == m.n_steps
    assert m.overflow_fraction_mean == 0.0          # every backend is exact
    assert m.wasted_tokens == m.draft_tokens - m.accepted_tokens
    assert m.throughput_tok_s > 0
    assert "speculative:" in m.report() and "prefill chunks" in m.report()


@pytest.mark.parametrize("mode", list(MODES))
def test_one_host_copy_per_dispatch(model, mode, monkeypatch):
    """The serving layer copies logits, drafts and routing telemetry off the
    device once per dispatch and reads no other tensor on the host (the
    model's own backends are not its concern here).  The telemetry reduced
    on the device equals the per-site sum."""
    from repro_torch.serving import engine as engine_mod
    copies, reads, quiet = [], [], [False]

    def serving_read(name):
        f = sys._getframe(2)
        while f is not None and "repro_torch" not in f.f_code.co_filename:
            f = f.f_back
        if not quiet[0] and f is not None and "serving" in f.f_code.co_filename:
            reads.append(f"{name} at {f.f_code.co_name}")

    for name in ("cpu", "item", "tolist", "__float__", "__int__", "__bool__"):
        fn = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda t, *a, _fn=fn, _n=name, **k: (
            serving_read(_n), _fn(t, *a, **k))[1])
    to_host = engine_mod._to_host

    def counted(parts):
        copies.append(len(parts))
        quiet[0] = True
        try:
            return to_host(parts)
        finally:
            quiet[0] = False

    monkeypatch.setattr(engine_mod, "_to_host", counted)
    eng = engine(model, mode)
    reduce_stats, folded = eng._reduce_stats, []

    def checked(stats):
        v = reduce_stats(stats)
        if v is not None:
            quiet[0] = True
            E = eng.num_leaves
            sites = [s for s in stats if s is not None]
            want = sum(s.leaf_counts for s in sites if s.leaf_counts.shape[-1] == E)
            np.testing.assert_array_equal(v[:-2].reshape(-1, E), want)
            assert float(v[-1]) == sum(float(s.slots) for s in sites) > 0
            quiet[0] = False
            folded.append(True)
        return v

    eng._reduce_stats = checked
    eng.run(requests(model))
    assert len(copies) == eng.n_steps + eng.n_chunks + (
        0 if mode == "chunked" else eng.n_prefills)
    # logits + target telemetry; spec adds the draft's (slabs), then drafts (rounds)
    assert sorted(set(copies)) == ([3, 4] if mode == "spec" else [2]), copies
    assert folded and eng._overflow["decode"][1] > 0    # slots were folded in
    assert not reads, f"host reads outside the dispatch copy: {sorted(set(reads))}"


def test_sampled_spec_is_deterministic(model):
    reqs = lambda: [dataclasses.replace(r, temperature=0.8) for r in requests(model)]
    a, _ = engine(model, "spec", seed=3).run(reqs())
    b, _ = engine(model, "spec", seed=3).run(reqs())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
        assert len(x.tokens) == GEN
        assert ((x.tokens >= 0) & (x.tokens < model["tcfg"].vocab_size)).all()


def test_engine_validates(model):
    with pytest.raises(ValueError, match="power of two"):
        engine(model, prefill_chunk=6)
    with pytest.raises(ValueError, match="spec_k == 0"):
        engine(model, draft_config="self")
    with pytest.raises(ValueError, match="self / self:N"):
        engine(model, spec_k=2, draft_config="llama")
    eng = engine(model)
    with pytest.raises(ValueError, match="max_len"):
        eng.validate(Request(rid=0, prompt=[1] * PROMPT, max_new_tokens=GEN + 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousBatchingEngine(model["tp"], model["tcfg"], EngineConfig(
                num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT))


def test_serve_cli_engine_on_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--engine", "continuous", "--spec-k",
                    "2", "--batch", "2", "--prompt-len", "16", "--gen", "4",
                    "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "speculative (k=2, draft=self)" in out and "chunked prefill" in out
    assert "served 4 requests, 16 tokens" in out
    assert "dispatch shapes: chunk=[(2, 8)] draft=[(2, 1)] verify=[(2, 3)]" in out
    assert "kernel launches:" in out


# ---------------------------------------------------------------------------
# capacity-bounded dispatch: the grouped backend and its overflow policies
# ---------------------------------------------------------------------------

GROUPED = {"drop": {},
           "exact_dense-cf0.5": {"overflow_policy": "exact_dense",
                                 "capacity_factor": 0.5}}


@pytest.mark.parametrize("mode", ["monolithic", "spec"])
@pytest.mark.parametrize("policy", list(GROUPED))
def test_grouped_engine_matches_jax_engine(model, mode, policy):
    """Both engines on their ``grouped`` backend (default policy "drop" at
    cf 2.0, and "exact_dense" at cf 0.5): the same greedy tokens, the same
    overflow means and repair counts."""
    kw = dict(fff_backend="grouped", **GROUPED[policy])
    jeng = jengine.ContinuousBatchingEngine(
        model["jp"], model["jcfg"], jengine.EngineConfig(
            num_slots=SLOTS, max_len=MAX_LEN, max_prompt_len=PROMPT,
            **MODES[mode], **kw))
    jres, jm = jeng.run(requests(model, JRequest))
    res, m = engine(model, mode, **kw).run(requests(model))
    want = {r.rid: np.asarray(r.tokens) for r in jres}
    for r in res:
        np.testing.assert_array_equal(r.tokens, want[r.rid], err_msg=f"rid {r.rid}")
    assert m.overflow_fraction_mean == pytest.approx(jm.overflow_fraction_mean, abs=1e-6)
    assert m.overflow_decode_mean == pytest.approx(jm.overflow_decode_mean, abs=1e-6)
    assert m.overflow_repairs == jm.overflow_repairs
    assert m.master_leaf_fraction == jm.master_leaf_fraction == 0.0
    if policy == "drop":
        assert m.overflow_repairs == 0
    else:                                   # cf 0.5 overflows, and is repaired
        assert m.overflow_fraction_mean > 0 and m.overflow_repairs > 0


def test_engine_capacity_knobs_steer_the_dispatch(model, monkeypatch):
    """The engine's capacity factor and policy reach every FFF call, the
    speculative round's capacity scaled by k + 1; the scheduler sees the
    bound."""
    seen = []
    fn = api.get_backend("infer", "grouped")
    monkeypatch.setitem(api._REGISTRY, ("infer", "grouped"), lambda p, c, x, s: (
        seen.append((x.shape[1], s.capacity_factor, s.overflow_policy)), fn(p, c, x, s))[1])
    eng = engine(model, "spec", fff_backend="grouped", capacity_factor=0.5,
                 overflow_policy="exact_dense")
    eng.run(requests(model))
    assert {(cf, pol) for t, cf, pol in seen if t in (1, 3)} == {(1.5, "exact_dense")}
    assert {(cf, pol) for t, cf, pol in seen if t > 3} == {(0.5, "exact_dense")}
    assert eng._dispatch_topology() == (1, 0.5)
    assert eng._overflow_policy() == "exact_dense"
    assert engine(model)._dispatch_topology() == (1, None)     # reference: exact


def test_engine_overflow_policy_validation(model):
    with pytest.raises(ValueError, match="overflow_policy"):
        engine(model, overflow_policy="dense")
    with pytest.raises(ValueError, match="master_leaf"):
        engine(model, fff_backend="grouped", overflow_policy="master_leaf")


@pytest.mark.parametrize("engine_flag", ["continuous", "off"])
def test_serve_cli_grouped_on_cpu(capsys, engine_flag):
    serve_mod.main(["--device", "cpu", "--engine", engine_flag, "--batch", "2",
                    "--prompt-len", "16", "--gen", "4", "--fff-backend",
                    "grouped", "--capacity-factor", "0.5",
                    "--overflow-policy", "exact_dense"])
    out = capsys.readouterr().out
    assert "fff backend=grouped requested" in out
    if engine_flag == "continuous":
        assert "capacity factor 0.5, overflow policy exact_dense" in out
        assert "served 4 requests, 16 tokens" in out
    else:
        assert "decode: 4 steps" in out
