"""The port's multi-tenant serving layer against the JAX package's, on the
CPU.

* Schedulers: ``weighted_leaf_aware``, ``leaf_aware`` with learned
  profiles and every scheduler's ``admission_cap`` against the JAX
  package's on the same seeded ``SchedulerView``s and queues: the same
  selection order over a whole drain, with two and three tenants and
  extreme weights.
* ``RoutingProfileStore`` against JAX's on the same occupancy streams
  (1e-12), with its LRU cap and ``min_updates`` gate.
* ``parse_tenant_weights`` and ``Request`` validation against JAX's on the
  same bad inputs; ``build_requests(shared_prefix=, tenants=)`` against the
  JAX driver's prompts and tenants for the same seed.
* A tenant engine run under ``VirtualClock`` (weighted admission, chunked
  prefill under ``max_prefilling``, staggered arrivals) against the JAX
  engine's on the same 2-layer model (``reference`` backend): the same
  tokens, per-tenant metrics, learned profiles and queue depths at every
  step.
* The command line with paging, a shared prefix and tenant weights, and
  ``--cuda-decode``'s steer.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro.serving import profiles as jprofiles
from repro.serving import request as jrequest
from repro.serving import scheduler as jsched
from repro_torch import weights
from repro_torch.configs import registry
from repro_torch.core import api
from repro_torch.launch import serve as serve_mod
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import profiles
from repro_torch.serving import request
from repro_torch.serving import scheduler as sched

torch.set_num_threads(2)


def rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

def _twin_requests(r, n, tenants, E):
    """The same n requests in both packages: tenants drawn from
    ``tenants``, hints usable, missing, zero-mass or of the wrong width."""
    out = ([], [])
    for i in range(n):
        kind = int(r.integers(0, 4))
        hint = (r.dirichlet(np.ones(E)) if kind == 0 else None if kind == 1
                else np.zeros(E) if kind == 2 else np.ones(E + 1))
        tenant = tenants[int(r.integers(0, len(tenants)))]
        for reqs, mod in zip(out, (request, jrequest)):
            reqs.append(mod.Request(rid=i, prompt=np.ones(4, np.int32),
                                    leaf_hint=hint, tenant=tenant))
    return out


def _twin_stores(r, tenants, E):
    stores = (profiles.RoutingProfileStore(E), jprofiles.RoutingProfileStore(E))
    for t in tenants[:-1]:                    # the last tenant stays unknown
        for _ in range(int(r.integers(1, 4))):
            row = r.dirichlet(np.ones(E) * 0.3)
            for s in stores:
                s.update(t, row)
    return stores


def _views(r, E, S, stores, cf):
    occ = r.dirichlet(np.ones(E), S)
    active = r.random(S) < 0.5
    occ[~active] = 0.0
    prefilling = active & (r.random(S) < 0.5)
    return tuple(mod.SchedulerView(
        occupancy=occ, active=active, num_leaves=E, capacity_factor=cf,
        num_slots=S, prefilling=prefilling, profiles=store,
        tokens_per_slot=int(r.integers(1, 4)))
        for mod, store in zip((sched, jsched), stores))


SCHED_CASES = {
    "weighted-2": ("weighted_leaf_aware", {"weights": {"a": 3.0, "b": 1.0}}, "ab"),
    "weighted-3": ("weighted_leaf_aware", {"weights": {"a": 4.0, "b": 2.0,
                                                       "c": 1.0}}, "abc"),
    "weighted-extreme": ("weighted_leaf_aware",
                         {"weights": {"a": 1000.0, "b": 0.001},
                          "max_prefilling": 2}, "abc"),
    "weighted-window": ("weighted_leaf_aware",
                        {"weights": {"b": 2.0}, "window": 2, "max_hold": 2},
                        "abc"),
    "leaf_aware-profiles": ("leaf_aware", {"max_prefilling": 1}, "abc"),
    "fcfs": ("fcfs", {"max_prefilling": 3}, "ab"),
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
@pytest.mark.parametrize("seed", range(2))
def test_schedulers_match_jax_over_a_drain(case, seed):
    name, kw, tenants = SCHED_CASES[case]
    r = rng(seed)
    for E, cf in ((4, 0.5), (8, None), (0, 2.0)):
        ours, theirs = (sched.make_scheduler(name, **kw),
                        jsched.make_scheduler(name, **kw))
        stores = _twin_stores(r, tenants, max(E, 1))
        waiting = _twin_requests(r, 40, tenants, max(E, 1))
        while waiting[0]:
            views = _views(r, E, 8, stores, cf)
            assert ours.admission_cap(views[0]) == theirs.admission_cap(views[1])
            n = int(r.integers(1, 4))
            got = ours.select(list(waiting[0]), n, views[0])
            want = theirs.select(list(waiting[1]), n, views[1])
            assert [q.rid for q in got] == [q.rid for q in want], (case, E)
            assert got, "a scheduler with a free slot must admit"
            for q in got:
                waiting[0].remove(q)
            for q in want:
                waiting[1].remove(q)


def test_weighted_scheduler_validation_matches_jax():
    for kw in ({"weights": {"a": 0.0}}, {"default_weight": -1.0},
               {"weights": {"a": float("inf")}},
               {"default_weight": float("nan")}):
        msgs = []
        for mod in (sched, jsched):
            with pytest.raises(ValueError) as err:
                mod.make_scheduler("weighted_leaf_aware", **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# routing profiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_profile_store_matches_jax_on_occupancy_streams(seed):
    r = rng(seed)
    E = 8
    kw = dict(ewma=float(r.uniform(0.05, 1.0)),
              min_updates=int(r.integers(1, 3)), max_tenants=3)
    ours, theirs = (profiles.RoutingProfileStore(E, **kw),
                    jprofiles.RoutingProfileStore(E, **kw))
    names = [f"t{i}" for i in range(5)]
    with pytest.warns(RuntimeWarning, match="evicted tenant"):
        for _ in range(200):
            t = names[int(r.integers(0, len(names)))]
            op = int(r.integers(0, 5))
            if op == 0:
                a, b = ours.lookup(t), theirs.lookup(t)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
                    a[:] = -1.0                  # a copy: the store is unchanged
                continue
            row = (np.zeros(E) if op == 1 else np.ones(E + 2) if op == 2
                   else r.dirichlet(np.ones(E)) * r.uniform(0.1, 10.0))
            ours.update(t, row)
            theirs.update(t, row)
            assert ours.tenants() == theirs.tenants()
            assert ours.n_updates(t) == theirs.n_updates(t)
    assert ours.n_evicted == theirs.n_evicted > 0
    assert ours.as_dict() == theirs.as_dict()


def test_profile_store_validation_matches_jax():
    for args in ((0,), (4, 0.0), (4, 1.5), (4, 0.3, 0), (4, 0.3, 1, -1)):
        msgs = []
        for mod in (profiles, jprofiles):
            with pytest.raises(ValueError) as err:
                mod.RoutingProfileStore(*args)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# requests and the driver's workload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(tenant=""), dict(tenant=3),
                                 dict(leaf_hint=np.array([np.nan, 1.0])),
                                 dict(leaf_hint=np.array([-1.0, 1.0])),
                                 dict(max_new_tokens=0), dict(prompt=[])],
                         ids=["empty-tenant", "int-tenant", "nan-hint",
                              "negative-hint", "no-tokens", "empty-prompt"])
def test_request_validation_matches_jax(bad):
    kw = {"rid": 0, "prompt": np.ones(4, np.int32), **bad}
    msgs = []
    for mod in (request, jrequest):
        with pytest.raises(ValueError) as err:
            mod.Request(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("spec", ["gold", "gold=abc", "gold=0", "gold=inf",
                                  "gold=-2", "=3", "gold=3,free=1,gold=1"])
def test_parse_tenant_weights_matches_jax(spec):
    msgs = []
    for fn in (serve_mod.parse_tenant_weights, jserve.parse_tenant_weights):
        with pytest.raises(ValueError) as err:
            fn(spec)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    good = "gold=3, free=1,,vip=0.5"
    assert (serve_mod.parse_tenant_weights(good)
            == jserve.parse_tenant_weights(good)
            == {"gold": 3.0, "free": 1.0, "vip": 0.5})
    assert serve_mod.parse_tenant_weights("") == {}


@pytest.mark.parametrize("argv", [
    ["--shared-prefix", "8", "--tenant-weights", "a=3,b=1"],
    ["--shared-prefix", "20", "--prompt-len", "48", "--requests", "7",
     "--tenant-weights", "x=1,y=2,z=3", "--seed", "3", "--eos-id", "5"],
    ["--requests", "5", "--seed", "1"]])
def test_build_requests_match_the_jax_driver(argv):
    args = jserve.parse_args(argv)
    want = jserve.build_requests(args, jregistry.get_config(args.arch))
    got = serve_mod.build_requests(
        jregistry.get_config(args.arch).vocab_size,
        args.requests or 2 * args.batch, args.prompt_len, args.gen,
        eos_id=args.eos_id, seed=args.seed, shared_prefix=args.shared_prefix,
        tenants=sorted(jserve.parse_tenant_weights(args.tenant_weights))
        or None)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert (g.rid, g.tenant, g.max_new_tokens, g.eos_id) == \
            (w.rid, w.tenant, w.max_new_tokens, w.eos_id)
    with pytest.raises(ValueError, match="shared-prefix"):
        serve_mod.build_requests(256, 2, 8, 4, shared_prefix=8)


# ---------------------------------------------------------------------------
# one tenant engine run under a VirtualClock, against the JAX engine
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


def test_tenant_engine_matches_jax_under_a_virtual_clock(model):
    """Weighted admission over three tenants (one labelled "c" but never
    weighted), chunked prefill under max_prefilling 1, a shared prefix and
    staggered arrivals (the clock jumps ahead while idle): tokens,
    per-tenant metrics and learned profiles equal the JAX engine's, and so
    do the per-tenant queue depths after every step of a second wave."""
    r = rng(8)
    system = r.integers(0, 256, 8).astype(np.int32)
    prompts = [np.concatenate([system, r.integers(0, 256, int(n))
                               .astype(np.int32)]) for n in r.integers(1, 9, 9)]
    kw = dict(num_slots=3, max_len=24, max_prompt_len=16, page_size=4,
              prefill_chunk=8, scheduler="weighted_leaf_aware",
              scheduler_kw={"weights": {"a": 3.0, "b": 1.0},
                            "max_prefilling": 1})

    def wave(mod, first):
        return [mod.Request(rid=first + i, prompt=p, max_new_tokens=5,
                            tenant="abc"[i % 3], arrival_time=0.25 * (i // 4))
                for i, p in enumerate(prompts)]

    engines = (engine_mod.ContinuousBatchingEngine(
                   model["tp"], model["tcfg"],
                   engine_mod.EngineConfig(device="cpu", **kw),
                   clock=engine_mod.VirtualClock()),
               jengine.ContinuousBatchingEngine(
                   model["jp"], model["jcfg"],
                   jengine.EngineConfig(fff_backend="reference", **kw),
                   clock=jengine.VirtualClock()))
    (res, m), (jres, jm) = (e.run(wave(mod, 0)) for e, mod in
                            zip(engines, (request, jrequest)))
    assert [q.rid for q in res] == [q.rid for q in jres]
    for q, jq in zip(res, jres):
        np.testing.assert_array_equal(q.tokens, jq.tokens, err_msg=f"rid {q.rid}")
        assert (q.tenant, q.ttft, q.finish_time) == (jq.tenant, jq.ttft,
                                                    jq.finish_time)
    assert m.tenants == jm.tenants and set(m.tenants) == {"a", "b", "c"}
    assert m.as_dict() == {k: v for k, v in jm.as_dict().items()}
    assert m.prefix_hit_tokens > 0
    for t in "abc":
        np.testing.assert_allclose(engines[0].profiles.lookup(t),
                                   engines[1].profiles.lookup(t),
                                   rtol=0, atol=1e-12)
    # a second wave, submitted at once and stepped by hand
    for e, mod in zip(engines, (request, jrequest)):
        for q in wave(mod, 100):
            e.submit(q)
    while engines[1].has_work():
        polls = [e.poll_metrics() for e in engines]
        assert polls[0].tenants == polls[1].tenants
        assert polls[0].queue_depth == polls[1].queue_depth
        for e in engines:
            e.step()
    assert not engines[0].has_work()
    assert engines[0].poll_metrics().as_dict() == engines[1].poll_metrics().as_dict()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_serve_cli_paged_tenants_on_cpu(capsys, tmp_path):
    path = tmp_path / "metrics.json"
    serve_mod.main(["--device", "cpu", "--page-size", "4", "--shared-prefix",
                    "8", "--tenant-weights", "a=3,b=1", "--scheduler",
                    "weighted_leaf_aware", "--requests", "8", "--metrics-json",
                    str(path)])
    out = capsys.readouterr().out
    assert "paged kv (page=4, prefix sharing on)" in out
    assert "tenant a: 4 requests" in out and "tenant b: 4 requests" in out
    got = json.loads(path.read_text())
    assert got["prefix_hit_tokens"] > 0 and got["n_requests"] == 8
    assert got["prefill_tokens"] + got["prefix_hit_tokens"] == 77 + 56
    assert set(got["tenants"]) == {"a", "b"}
    assert set(got["routing_profiles"]) == {"a", "b"}
    assert got["dispatch_shapes"]["decode"] == [[4, 1]]
    serve_mod.main(["--device", "cpu", "--tenant-weights", "a=3,b=1",
                    "--requests", "2", "--gen", "2"])
    assert "WARNING: --tenant-weights given but --scheduler is 'fcfs'" in \
        capsys.readouterr().out


@pytest.mark.parametrize("spec_k", [0, 2])
def test_cuda_decode_steers_decode_and_draft_steps(model, monkeypatch, spec_k):
    """``cuda_decode``: every one-token decode or draft dispatch runs the
    cuda_decode backend (its plain version on CPU tensors), the slabs keep
    the reference, and the tokens are unchanged."""
    ran = []
    for key, fn in list(api._REGISTRY.items()):
        monkeypatch.setitem(api._REGISTRY, key,
                            lambda *a, _fn=fn, _n=key[1]: (
                                ran.append((_n, a[2].shape[-2])), _fn(*a))[1])
    prompts = [rng(9).integers(0, 256, n).astype(np.int32) for n in (5, 9, 14)]
    toks = []
    for steer in (False, True):
        ran.clear()
        eng = engine_mod.ContinuousBatchingEngine(
            model["tp"], model["tcfg"], engine_mod.EngineConfig(
                num_slots=2, max_len=24, max_prompt_len=16, spec_k=spec_k,
                cuda_decode=steer, device="cpu"))
        res, _ = eng.run([request.Request(rid=i, prompt=p, max_new_tokens=4)
                          for i, p in enumerate(prompts)])
        toks.append([q.tokens for q in res])
    assert {n for n, rows in ran if rows == 1} == {"cuda_decode"}
    assert {n for n, rows in ran if rows > 1} == {"reference"}
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)
