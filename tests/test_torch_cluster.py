"""The port's disaggregated prefill/decode cluster (``repro_torch.cluster``)
against the JAX package's (``repro.cluster``), on the CPU.

Tiers, as in ``tests/test_serving_cluster.py``:

* host: the ``VirtualClock``, placement scores, ``GlobalPrefixMap`` and the
  ``ClusterMonitor``'s timeout, backoff, budget, watermark and straggler
  decisions, each fed the same synthetic views in both packages;
* handoff: a JAX ``KVHandoff``, converted to the port's per-layer layout,
  installs into a port engine and decodes JAX's greedy tokens, and a port
  handoff installs into a JAX engine and does the same; the installed
  pages equal the extracted ones bit for bit, and a pickled handoff keeps
  its bfloat16 bits;
* cluster, on a ``LocalBus`` with a ``VirtualClock``: the port's fleet
  gives the JAX fleet's tokens with the per-role dispatch contract, and
  JAX's tokens across a decode-worker kill and replay; drain, elastic
  scale up and down, and prefix affinity;
* one ``ProcBus`` fleet of spawned CPU processes, 1 prefill + 1 decode,
  with a SIGKILL.

One model, internlm2-20b ``reduced()`` in float32, carries the same
numpy-drawn weights into both packages (``weights.from_jax``); the JAX
engines run on their ``reference`` backend, as the port's do on the CPU.
"""
import dataclasses
import json
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import ClusterWorker as JClusterWorker
from repro.cluster import LocalBus as JLocalBus
from repro.cluster import Router as JRouter
from repro.cluster import control as jcontrol
from repro.cluster import handoff as jhandoff
from repro.cluster import placement as jplacement
from repro.cluster import router as jrouter
from repro.configs import registry as jregistry
from repro.distributed import straggler as jstraggler
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.cluster import (ClusterConfig, ClusterWorker, LocalBus,
                                 ProcBus, Router, WorkerSpec)
from repro_torch.cluster import control, handoff, placement
from repro_torch.cluster import router as trouter
from repro_torch.configs import registry
from repro_torch.distributed import straggler
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import Request

torch.set_num_threads(2)

PAGE = 8
#: (placement, control, router, VirtualClock, StragglerConfig) per package
PKGS = {"jax": (jplacement, jcontrol, jrouter, jengine.VirtualClock,
                jstraggler.StragglerConfig),
        "port": (placement, control, trouter, tengine.VirtualClock,
                 straggler.StragglerConfig)}


def acts(actions):
    """Monitor actions as comparable (class name, fields) pairs."""
    return [(type(a).__name__, dataclasses.asdict(a)) for a in actions]


# ---------------------------------------------------------------------------
# host tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", list(PKGS))
def test_virtual_clock(pkg):
    vc = PKGS[pkg][3](start=2.0)
    assert vc() == 2.0
    assert vc.advance(0.5) == 2.5
    assert vc() == 2.5
    with pytest.raises(ValueError):
        vc.advance(-0.1)


def test_engine_accepts_injected_clock():
    """now() runs entirely on the injected clock: no wall time."""
    cfg = registry.get_config("internlm2-20b").reduced()
    params = lm.init(cfg, device="cpu")
    vc = tengine.VirtualClock(start=100.0)
    eng = ContinuousBatchingEngine(params, cfg, EngineConfig(
        num_slots=2, max_len=32, max_prompt_len=16, device="cpu"), clock=vc)
    assert eng.now() == 0.0
    vc.advance(3.0)
    assert eng.now() == 3.0


def _decode_views(pl, occ0, occ1, **kw):
    base = dict(pages_total=64, queue_depth=0, active_slots=0, num_slots=4)
    base.update(kw)
    return {"d0": pl.WorkerView(wid="d0", role="decode", pages_free=64,
                                occupancy=occ0, **base),
            "d1": pl.WorkerView(wid="d1", role="decode", pages_free=64,
                                occupancy=occ1, **base)}


def test_overlap_and_decode_scoring():
    """JAX's placement cases, then random views: both packages score and
    choose alike."""
    for pl in (jplacement, placement):
        assert pl.overlap(None, np.ones(4)) == 0.0
        assert pl.overlap(np.ones(4), np.zeros(4)) == 0.0
        assert pl.overlap(np.array([1.0, 0]), np.array([1.0, 0])) == \
            pytest.approx(1.0)
        views = _decode_views(pl, np.array([1.0, 0.0]), np.array([0.0, 1.0]))
        assert pl.choose_decode(views, np.array([1.0, 0.0])) == "d1"
        assert pl.choose_decode(views, np.array([0.0, 1.0])) == "d0"
        views["d0"].pages_free = 4
        assert pl.choose_decode(views, None) == "d1"
        views["d1"].draining = views["d0"].draining = True
        assert pl.choose_decode(views, None) is None
    r = np.random.default_rng(0)
    for _ in range(50):
        occ = [r.random(8) for _ in range(2)]
        kw = dict(queue_depth=int(r.integers(0, 5)),
                  active_slots=int(r.integers(0, 5)))
        fp = r.random(8) if r.random() < 0.8 else None
        got = _decode_views(placement, *occ, **kw)
        want = _decode_views(jplacement, *occ, **kw)
        for w in ("d0", "d1"):
            got[w].pages_free = want[w].pages_free = int(r.integers(0, 65))
            assert placement.score_decode(got[w], fp) == \
                jplacement.score_decode(want[w], fp)
        assert placement.choose_decode(got, fp) == jplacement.choose_decode(want, fp)


def test_choose_prefill_affinity_and_fallback():
    for pl in (jplacement, placement):
        mk = lambda wid, q: pl.WorkerView(wid=wid, role="prefill",
                                          num_slots=2, queue_depth=q)
        views = {"p0": mk("p0", 4), "p1": mk("p1", 0)}
        assert pl.choose_prefill(views, None) == "p1"       # least loaded
        assert pl.choose_prefill(views, "p0") == "p0"       # affinity wins
        views["p0"].draining = True
        assert pl.choose_prefill(views, "p0") == "p1"       # unless draining


def test_global_prefix_map():
    """JAX's cases, then random inserts, drops and lookups in both maps."""
    for rt in (jrouter, trouter):
        m = rt.GlobalPrefixMap(page_size=4)
        sys_prefix = list(range(100, 108))
        m.insert(sys_prefix, "p0")
        assert m.lookup(sys_prefix + [1, 2, 3, 4]) == "p0"
        assert m.lookup([9, 9, 9, 9]) is None
        assert m.lookup([1, 2]) is None
        m.insert([9, 9, 9, 9], "p1")
        assert m.lookup([9, 9, 9, 9, 5]) == "p1"
        m.drop_worker("p0")
        assert m.lookup(sys_prefix) is None
        assert m.lookup([9, 9, 9, 9]) == "p1"
    r = np.random.default_rng(1)
    got, want = trouter.GlobalPrefixMap(4), jrouter.GlobalPrefixMap(4)
    for _ in range(200):
        p = r.integers(0, 3, int(r.integers(1, 14)))
        op = r.random()
        if op < 0.4:
            wid = f"p{r.integers(0, 3)}"
            got.insert(p, wid), want.insert(p, wid)
        elif op < 0.45:
            wid = f"p{r.integers(0, 3)}"
            got.drop_worker(wid), want.drop_worker(wid)
        assert got.lookup(p) == want.lookup(p) and len(got) == len(want)


def _mk_views(pl, **extra):
    views = {
        "p0": pl.WorkerView(wid="p0", role="prefill", num_slots=2),
        "d0": pl.WorkerView(wid="d0", role="decode", num_slots=4,
                            pages_free=64, pages_total=64),
        "d1": pl.WorkerView(wid="d1", role="decode", num_slots=4,
                            pages_free=64, pages_total=64),
    }
    for wid, kw in extra.items():
        for k, v in kw.items():
            setattr(views[wid], k, v)
    return views


def _both(script):
    """Run ``script(placement, control, VirtualClock, StragglerConfig)`` in
    both packages; their action logs must agree.  Returns the port's."""
    logs = {}
    for pkg, (pl, ctl, _, vcls, scfg) in PKGS.items():
        logs[pkg] = [acts(a) for a in script(pl, ctl, vcls, scfg)]
    assert logs["port"] == logs["jax"]
    return logs["port"]


def test_monitor_heartbeat_timeout_and_backoff_respawn():
    def script(pl, ctl, vcls, _):
        vc = vcls()
        mon = ctl.ClusterMonitor(ctl.ControlConfig(
            heartbeat_timeout=1.0, max_restarts=2, backoff_base=0.5,
            scale_up_watermark=1e9, scale_down_watermark=-1.0), vc)
        views = _mk_views(pl)
        for wid in views:
            mon.observe_heartbeat(wid, vc())
        out = [mon.tick(views, 0)]
        vc.advance(0.5)
        for wid in ("p0", "d1"):
            mon.observe_heartbeat(wid, vc())
        vc.advance(0.7)                                 # d0 now stale (1.2 s)
        out += [mon.tick(views, 0), mon.tick(views, 0)]
        for wid in ("p0", "d1"):
            mon.observe_heartbeat(wid, vc())
        vc.advance(0.5)                                 # the backoff elapses
        return out + [mon.tick(views, 0)]

    log = _both(script)
    assert log == [[], [("MarkDead", {"wid": "d0"})], [],
                   [("Respawn", {"role": "decode"})]]


def test_monitor_restart_budget_stops_respawns():
    def script(pl, ctl, vcls, _):
        vc = vcls()
        mon = ctl.ClusterMonitor(ctl.ControlConfig(
            heartbeat_timeout=0.1, max_restarts=1, backoff_base=0.0,
            scale_up_watermark=1e9, scale_down_watermark=-1.0), vc)
        vc.advance(1.0)
        return [mon.tick(_mk_views(pl), 0)]            # all 3 time out

    (log,) = _both(script)
    assert sum(n == "MarkDead" for n, _ in log) == 3
    assert sum(n == "Respawn" for n, _ in log) == 2    # one per role


def test_monitor_elastic_watermarks():
    def script(pl, ctl, vcls, _):
        vc = vcls()
        mon = ctl.ClusterMonitor(ctl.ControlConfig(
            heartbeat_timeout=1e9, scale_up_watermark=3.0,
            scale_down_watermark=0.5, watermark_ewma=1.0, scale_cooldown=1.0,
            min_decode=1, max_decode=4), vc)
        views = _mk_views(pl)
        out = [mon.tick(views, 10), mon.tick(views, 10)]   # heavy; cooldown
        vc.advance(1.5)
        out.append(mon.tick(views, 10))
        vc.advance(1.5)
        out.append(mon.tick(views, 0))                  # idle fleet drains
        assert len(mon.scale_events) == 3
        return out

    log = _both(script)
    assert log == [[("SpawnDecode", {})], [], [("SpawnDecode", {})],
                   [("DrainWorker", {"wid": "d1", "reason": "scale_down"})]]


def test_monitor_straggler_drains_slow_decode_worker():
    def script(pl, ctl, vcls, scfg):
        vc = vcls()
        mon = ctl.ClusterMonitor(ctl.ControlConfig(
            heartbeat_timeout=1e9, scale_up_watermark=1e9,
            scale_down_watermark=-1.0,
            straggler=scfg(window=16, slow_factor=1.5, eject_after=3,
                           min_history=4)), vc)
        views = _mk_views(pl)
        t = {"p0": 0.0, "d0": 0.0, "d1": 0.0}
        out = []
        for _ in range(10):
            for wid, dt in (("p0", 0.1), ("d0", 0.1), ("d1", 0.5)):
                t[wid] += dt                            # d1 beats 5x slower
                mon.observe_heartbeat(wid, t[wid])
            out.append(mon.tick(views, 0))
            if out[-1]:
                break
        return out

    log = _both(script)
    assert log[-1] == [("DrainWorker", {"wid": "d1", "reason": "straggler"})]


# ---------------------------------------------------------------------------
# handoff and cluster tiers (one module-scoped model)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jregistry.get_config("internlm2-20b").reduced()
    tcfg = registry.get_config("internlm2-20b").reduced()
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = np.random.default_rng(5)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 4.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                          device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, ref={})


def _ecfg(pkg, role, **kw):
    d = dict(num_slots=2 if role == "prefill" else 4, max_len=48,
             max_prompt_len=16, page_size=PAGE, seed=0)
    d.update(kw)
    if pkg == "jax":
        return jengine.EngineConfig(fff_backend="reference", **d)
    return EngineConfig(device="cpu", **d)


def _requests(n, seed=7, max_new=6, lo=4, hi=17, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, 256, int(rng.integers(lo, hi))),
                max_new_tokens=max_new) for i in range(n)]


def _engine(model, pkg, role="decode", **kw):
    if pkg == "jax":
        return jengine.ContinuousBatchingEngine(model["jp"], model["jcfg"],
                                                _ecfg("jax", role, **kw))
    return ContinuousBatchingEngine(model["tp"], model["tcfg"],
                                    _ecfg("port", role, **kw))


def jax_reference(model, key, reqs, **kw):
    """One JAX engine's tokens per rid for these requests (cached by key)."""
    if key not in model["ref"]:
        res, _ = _engine(model, "jax", **kw).run(
            [JRequest(rid=r.rid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens) for r in reqs])
        model["ref"][key] = {r.rid: (list(np.asarray(r.tokens)), r.finish_reason)
                             for r in res}
    return model["ref"][key]


def _to_port(h, cfg):
    """A JAX ``KVHandoff`` in the port's layout: layer i is period
    position ``i % P``, repetition ``i // P``."""
    P = len(cfg.period)
    rows = lambda rs: [torch.from_numpy(np.array(rs[i % P][i // P]))
                       for i in range(cfg.n_layers)]
    req = Request(rid=h.request.rid, prompt=h.request.prompt,
                  max_new_tokens=h.request.max_new_tokens)
    return handoff.KVHandoff(
        request=req, tokens=list(h.tokens), prompt_len=h.prompt_len,
        page_size=h.page_size, n_pages=h.n_pages, k_rows=rows(h.k_rows),
        v_rows=rows(h.v_rows), occupancy=h.occupancy, measured=h.measured)


def _to_jax(h, cfg):
    P = len(cfg.period)
    rows = lambda rs: [np.stack([rs[i].numpy() for i in range(p, cfg.n_layers, P)])
                       for p in range(P)]
    req = JRequest(rid=h.request.rid, prompt=h.request.prompt,
                   max_new_tokens=h.request.max_new_tokens)
    return jhandoff.KVHandoff(
        request=req, tokens=list(h.tokens), prompt_len=h.prompt_len,
        page_size=h.page_size, n_pages=h.n_pages, k_rows=rows(h.k_rows),
        v_rows=rows(h.v_rows), occupancy=h.occupancy, measured=h.measured)


def _extract_all(pkg, src):
    lib = jhandoff if pkg == "jax" else handoff
    src._evict_finished()
    src._admit()
    out = []
    for i, st in enumerate(src.slots):
        if st is not None and st.tokens and not st.done:
            h = lib.extract(src, i)
            assert h.n_pages == -(-len(st.request.prompt) // PAGE)
            assert h.nbytes > 0
            out.append(h)
            src.release_slot(i, record_result=False)
    assert len(out) == 2 and all(s is None for s in src.slots)
    # only the prefix index still holds pages (published prefixes)
    src.prefix.reclaim(src.pool.num_pages)
    assert src.pool.pages_free == src.pool.num_pages
    return out


def _decode_all(pkg, dst, handoffs):
    lib = jhandoff if pkg == "jax" else handoff
    for h in handoffs:
        assert lib.install(dst, h) is not None
    while dst.has_work():
        dst.step()
    return {r.rid: (list(np.asarray(r.tokens)), r.finish_reason)
            for r in dst.results}


@pytest.mark.parametrize("src_pkg", ["jax", "port"])
def test_handoff_roundtrip_matches_local_decode(model, src_pkg):
    """extract on one package's engine, install on the other's (and on the
    port's): the receiver finishes each request with the tokens one JAX
    engine gives it end to end.  On the port's receiver the installed pages
    hold the shipped rows bit for bit."""
    reqs = _requests(2, seed=3)
    want = jax_reference(model, "roundtrip", reqs)
    cls = JRequest if src_pkg == "jax" else Request
    src = _engine(model, src_pkg, "prefill")
    for r in _requests(2, seed=3, cls=cls):
        src.submit(r)
    hs = _extract_all(src_pkg, src)
    port_hs = [_to_port(h, model["jcfg"]) for h in hs] if src_pkg == "jax" else hs
    dst = _engine(model, "port")
    assert _decode_all("port", dst, port_hs) == want
    assert dst.compiled_shapes()["install"] == 1
    assert "prefill_16" not in dst.dispatch_shapes()
    # the installed pages, read back through a fresh install, are the rows
    probe = _engine(model, "port")
    slot = handoff.install(probe, port_hs[0])
    pages = probe._slot_pages[slot][:port_hs[0].n_pages]
    for layer, c in enumerate(probe.caches):
        assert torch.equal(c["kv"].k[pages], port_hs[0].k_rows[layer])
        assert torch.equal(c["kv"].v[pages], port_hs[0].v_rows[layer])
    if src_pkg == "port":
        jdst = _engine(model, "jax")
        assert _decode_all("jax", jdst, [_to_jax(h, model["tcfg"]) for h in hs]) == want


def test_handoff_pickles_its_bytes():
    """A pickled handoff carries bfloat16 rows bit for bit; a tensor off the
    CPU is refused."""
    import pickle
    r = torch.Generator().manual_seed(0)
    rows = [torch.randn(2, 4, 2, 8, generator=r).to(torch.bfloat16) for _ in range(2)]
    h = handoff.KVHandoff(request=Request(rid=0, prompt=[1, 2, 3]), tokens=[4],
                          prompt_len=3, page_size=4, n_pages=2, k_rows=rows,
                          v_rows=[t + 1 for t in rows])
    back = pickle.loads(pickle.dumps(h))
    assert back.nbytes == h.nbytes == 4 * 2 * 4 * 2 * 8 * 2
    for a, b in zip(h.k_rows + h.v_rows, back.k_rows + back.v_rows):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    h.k_rows = [t.to("meta") for t in rows]
    with pytest.raises(ValueError, match="CPU tensors"):
        pickle.dumps(h)


def test_weights_checksum_sees_values_and_layout():
    """Equal trees fingerprint equally; one changed bit, a permutation or a
    transposition of a tensor's values, and a swap of two tensors do not."""
    from repro_torch.cluster.worker import weights_checksum
    r = torch.Generator().manual_seed(0)
    w = torch.randn(64, 96, generator=r).to(torch.bfloat16)
    tree = {"a": w, "b": [torch.randn(7, generator=r), torch.arange(5)]}
    base = weights_checksum(tree)
    assert weights_checksum({"b": list(tree["b"]), "a": w.clone()}) == base
    bit = w.clone()
    bit.view(torch.int16)[3, 5] ^= 1
    for a in (bit, w.flatten()[torch.randperm(w.numel(), generator=r)].view(64, 96),
              w.t().contiguous().view(64, 96)):
        assert weights_checksum(dict(tree, a=a)) != base
    assert weights_checksum(dict(tree, b=tree["b"][::-1])) != base


def _cluster(model, pkg, *, n_prefill=1, n_decode=2, control=None,
             failure_hooks=None, engine_kw=None):
    ctl = PKGS[pkg][1]
    vc = PKGS[pkg][3]()
    engines = {}
    worker_cls = JClusterWorker if pkg == "jax" else ClusterWorker

    def factory(wid, role):
        ecfg = _ecfg(pkg, role, **(engine_kw or {}))
        eng = (jengine.ContinuousBatchingEngine(model["jp"], model["jcfg"], ecfg,
                                                clock=vc) if pkg == "jax" else
               ContinuousBatchingEngine(model["tp"], model["tcfg"], ecfg, clock=vc))
        engines[wid] = eng
        return worker_cls(wid, role, eng,
                          failure_hook=(failure_hooks or {}).get(wid))

    bus = (JLocalBus if pkg == "jax" else LocalBus)(factory, clock=vc)
    ccls, rcls = ((JClusterConfig, JRouter) if pkg == "jax"
                  else (ClusterConfig, Router))
    router = rcls(bus, ccls(n_prefill=n_prefill, n_decode=n_decode,
                            page_size=PAGE, control=control or ctl.ControlConfig(
                                heartbeat_timeout=0.05, max_restarts=3,
                                scale_up_watermark=1e9,
                                scale_down_watermark=-1.0)), clock=vc)
    router.start()
    return router, engines


def _tokens(res):
    return {r.rid: (list(np.asarray(r.tokens)), r.finish_reason) for r in res}


def test_cluster_parity_and_compile_contract(model):
    """The port's LocalBus fleet gives the JAX fleet's tokens, request for
    request; each port worker's dispatch shapes hold its role's alone."""
    reqs = _requests(8, seed=11)
    router, engines = _cluster(model, "port")
    res = router.run(reqs, max_ticks=4000)
    jr, _ = _cluster(model, "jax")
    want = jr.run(_requests(8, seed=11, cls=JRequest), max_ticks=4000)
    assert _tokens(res) == _tokens(want)
    assert [r.rid for r in res] == list(range(8))
    cm = router.cluster_metrics()
    assert cm["worker_restarts"] == cm["replayed_requests"] == 0
    assert cm["handoff_bytes"] == jr.cluster_metrics()["handoff_bytes"] > 0
    for wid, eng in engines.items():
        shapes = eng.compiled_shapes()
        if wid.startswith("p"):
            assert set(shapes) == {"prefill_16", "admit"}
        else:
            assert shapes == {"decode": 1, "install": 1}
    m = router.metrics()
    assert m.n_requests == 8 and m.ttft.mean_ms > 0


def test_cluster_kill_decode_worker_exact_replay(model):
    """A decode worker dropped mid-stream: every request still completes,
    none twice, with a JAX engine's tokens; one respawn under a fresh wid."""
    reqs = _requests(8, seed=7, max_new=8)
    kw = dict(prefill_chunk=8, prefill_budget=2)
    router, engines = _cluster(model, "port",
                               failure_hooks={"d0": lambda n: n == 6},
                               engine_kw=kw)
    res = router.run(reqs, max_ticks=6000)
    cm = router.cluster_metrics()
    assert [r.rid for r in res] == list(range(8))       # zero lost
    assert cm["worker_restarts"] == 1
    assert cm["replayed_requests"] >= 1
    assert cm["duplicate_results"] == 0                 # zero duplicated
    assert _tokens(res) == jax_reference(model, "kill", reqs, **kw)
    assert "d0" not in router.views and "d2" in router.views
    assert engines["p0"].compiled_shapes() == {"prefill_chunk": 1, "admit": 1}


def test_cluster_drain_blocks_new_admissions(model):
    """Drain: in-flight work completes, queued work is never admitted, and
    the drained workers leave after their goodbye."""
    reqs = _requests(6, seed=5)
    router, _ = _cluster(model, "port")
    for r in reqs[:2]:
        router.submit(r)
    for _ in range(3):
        router.step()
    assert sum(s.phase != "queued" for s in router.states.values()) == 2
    router.drain_all()
    for r in reqs[2:]:
        router.submit(r)
    for _ in range(200):
        router.step()
        if all(router.states[r.rid].phase == "done" for r in reqs[:2]):
            break
    assert all(router.states[r.rid].phase == "done" for r in reqs[:2])
    assert all(router.states[r.rid].phase == "queued" for r in reqs[2:])
    for _ in range(20):
        router.step()
    assert not router.views and len(router.byes) == 3


def test_cluster_elastic_scale_up_then_down(model):
    """Queue pressure spawns a decode worker; the idle fleet drains it."""
    ctrl = control.ControlConfig(heartbeat_timeout=1e9, scale_up_watermark=3.0,
                                 scale_down_watermark=0.5, watermark_ewma=1.0,
                                 scale_cooldown=0.02, min_decode=1, max_decode=2)
    router, engines = _cluster(model, "port", n_decode=1, control=ctrl)
    res = router.run(_requests(10, seed=9), max_ticks=6000)
    assert len(res) == 10
    events = lambda: [e["action"] for e in router.cluster_metrics()["scale_events"]]
    assert "scale_up" in events()
    assert len([w for w in engines if w.startswith("d")]) == 2
    for _ in range(400):
        router.step()
        if "scale_down" in events():
            break
    assert "scale_down" in events()


def test_cluster_prefix_affinity_routes_to_publisher(model):
    """Prompts sharing a system prefix land on the prefill worker that
    published it, whose admission maps the shared pages."""
    rng = np.random.default_rng(13)
    system = rng.integers(1, 256, PAGE)                 # one full page
    reqs = [Request(rid=i, prompt=np.concatenate([system, rng.integers(1, 256, 4)]),
                    max_new_tokens=4) for i in range(6)]
    router, engines = _cluster(model, "port", n_prefill=2)
    res = router.run(reqs, max_ticks=4000)
    assert len(res) == 6 and len(router.prefix_map) > 0
    assert sum(e.n_prefix_hit_tokens for w, e in engines.items()
               if w.startswith("p")) > 0


def test_procbus_kill_on_cpu(monkeypatch):
    """Spawned worker processes (1 prefill + 1 decode, weights rebuilt from
    the seed in each): a SIGKILLed decode worker's requests are replayed,
    every rid finishes once with one engine's tokens, the children's
    weights checksums equal this process's, and no child outlives the
    fleet."""
    from repro_torch.cluster import worker as worker_lib
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = registry.get_config("internlm2-20b").reduced()
    reqs = _requests(6, seed=2)
    bus = ProcBus(lambda wid, role: WorkerSpec(
        wid=wid, role=role, cfg=cfg, ecfg=_ecfg("port", role), device="cpu"))
    router = Router(bus, ClusterConfig(
        n_prefill=1, n_decode=1, page_size=PAGE, control=control.ControlConfig(
            scale_up_watermark=1e9, scale_down_watermark=-1.0)),
        clock=tengine.VirtualClock())
    killed = []

    def on_tick(r):
        if not killed and len(r.results) >= 2:
            killed.append("d0")
            r.kill_worker("d0")

    try:
        router.start()
        res = router.run(reqs, max_ticks=200_000, on_tick=on_tick)
    finally:
        router.shutdown()
    assert not multiprocessing.active_children()
    params = lm.init(cfg, seed=0, device="cpu")
    want, _ = ContinuousBatchingEngine(params, cfg, _ecfg("port", "decode")).run(
        _requests(6, seed=2))
    assert [r.rid for r in res] == list(range(6))      # every rid once
    assert _tokens(res) == _tokens(want)
    cm = router.cluster_metrics()
    # the victim's pipe is dropped unread at the kill: nothing of it arrives
    assert cm["worker_restarts"] == 1 and cm["duplicate_results"] == 0
    # d0 heartbeat before its kill; p0 and the respawned d1 also say goodbye
    assert set(router.checksums) == set(bus.ready_s) == {"p0", "d0", "d1"}
    assert set(router.checksums.values()) == {worker_lib.weights_checksum(params)}


def test_procbus_worker_that_cannot_start_fails_the_run(monkeypatch):
    """A child whose engine cannot be built (here the engine refuses the
    model) reports its traceback: the router raises at once instead of
    waiting out a heartbeat timeout, and shutdown leaves no child."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = registry.get_config("xlstm-1.3b").reduced()
    bus = ProcBus(lambda wid, role: WorkerSpec(
        wid=wid, role=role, cfg=cfg, ecfg=_ecfg("port", role), device="cpu"))
    router = Router(bus, ClusterConfig(n_prefill=1, n_decode=1, page_size=PAGE),
                    clock=tengine.VirtualClock())
    try:
        router.start()
        with pytest.raises(RuntimeError, match=r"cluster worker [pd]0 failed:"
                                               r"(.|\n)*requires attention mixers"):
            router.run(_requests(2), max_ticks=100_000)
    finally:
        router.shutdown()
    assert not multiprocessing.active_children()


def test_serve_cli_cluster_on_cpu(capsys, tmp_path):
    """``--cluster`` on a LocalBus with a kill, the parity check and a drain:
    the report, the metrics JSON's cluster block and ``parity_ok``."""
    path = tmp_path / "m.json"
    serve_mod.main(["--device", "cpu", "--cluster", "1", "2", "--cluster-bus",
                    "local", "--cluster-kill", "2", "--cluster-verify", "--drain",
                    "--batch", "2", "--requests", "8", "--prompt-len", "16",
                    "--gen", "4", "--metrics-json", str(path)])
    out = capsys.readouterr().out
    assert "cluster: 1 prefill + 2 decode workers (local bus, cpu)" in out
    assert "FAULT INJECTION: killing decode worker d0 after" in out
    assert "parity vs single engine: EXACT" in out and "drained: clean" in out
    payload = json.loads(path.read_text())
    assert payload["parity_ok"] is True and payload["n_requests"] == 8
    assert payload["cluster"]["worker_restarts"] == 1
    assert payload["topology"] == {"n_prefill": 1, "n_decode": 2, "bus": "local",
                                   "device": "cpu", "slots_per_worker": 2}
