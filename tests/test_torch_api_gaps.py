"""The public names the port's modules gained to match the JAX package's,
each held against its JAX counterpart on the CPU (float32, the ``e2e``
tolerance of ``tests/conftest.py`` where numbers are compared):

* ``FFFConfig.{training,inference}_{width,size}``, ``fff.for_ffn`` and
  ``FFConfig.{training,inference}_width``;
* ``ModelConfig.n_periods``, ``ShapeSpec``, ``SHAPES``,
  ``shape_applicable`` and the ``configs`` package's re-exports;
* ``EngineConfig.{prefill_buckets,telemetry,occupancy_ewma}`` and
  ``TenantQueues.depth``;
* ``lm.prefill_padded``;
* ``ExecutionSpec.rng`` and ``FFFOutput.as_dict``;
* ``utils``' tree, power-of-two, config and size-formatting helpers.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from conftest import dtype_tol
from repro import utils as jutils
from repro.configs import registry as jregistry
from repro.core import api as japi
from repro.core import ff as jff
from repro.core import fff as jfff
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro.serving.request import Request as JRequest
import repro_torch.configs as configs
from repro_torch import utils, weights
from repro_torch.configs import registry
from repro_torch.core import api, ff, fff
from repro_torch.models import lm
from repro_torch.serving import engine
from repro_torch.serving.request import Request

torch.set_num_threads(2)


def close(got, want):
    rtol, atol = dtype_tol(jnp.float32, "e2e")
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def plain_fields(cfg) -> dict:
    """A config's fields, dtypes by name (the packages' dtypes differ)."""
    return {f.name: (jnp.dtype(v).name if f.name.endswith("_dtype") and not
                     isinstance(v, torch.dtype) else
                     str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


# ---------------------------------------------------------------------------
# core configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(depth=0, leaf_width=16), dict(depth=4, leaf_width=8),
    dict(depth=3, leaf_width=32, trees=4, node_width=2),
    dict(depth=7, leaf_width=1, master_leaf=True)], ids=str)
def test_fff_config_widths_and_sizes_match_jax(kw):
    tc = fff.FFFConfig(dim_in=64, dim_out=32, **kw)
    jc = jfff.FFFConfig(dim_in=64, dim_out=32, **kw)
    for name in ("training_width", "inference_width", "training_size",
                 "inference_size", "num_leaves", "num_nodes", "master_hidden"):
        assert getattr(tc, name) == getattr(jc, name), name


@pytest.mark.parametrize("args", [
    (512, 2048, 128, {}), (768, 3072, 64, dict(trees=2)),
    (128, 100, 8, dict(activation="gelu", hardening_scale=3.0)),
    (64, 7, 16, dict(trees=3, master_leaf=True))], ids=str)
def test_for_ffn_matches_jax(args):
    dim, d_ff, leaf, kw = args
    assert plain_fields(fff.for_ffn(dim, d_ff, leaf, **kw)) == \
        plain_fields(jfff.for_ffn(dim, d_ff, leaf, **kw))


def test_ff_config_widths_match_jax():
    for width in (1, 128, 3072):
        tc = ff.FFConfig(dim_in=16, dim_out=8, width=width)
        jc = jff.FFConfig(dim_in=16, dim_out=8, width=width)
        assert (tc.training_width, tc.inference_width) == \
            (jc.training_width, jc.inference_width) == (width, width)


# ---------------------------------------------------------------------------
# model configs and shapes
# ---------------------------------------------------------------------------

def test_n_periods_shapes_and_applicability_match_jax():
    assert [dataclasses.asdict(s) for s in configs.SHAPES.values()] == \
        [dataclasses.asdict(s) for s in jconfigs.SHAPES.values()]
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for arch in registry.ARCH_IDS:
        for ffn in ("fff", "native"):
            tc, jc = registry.get_config(arch, ffn), jregistry.get_config(arch, ffn)
            assert tc.n_periods == jc.n_periods, arch
            for name, shape in configs.SHAPES.items():
                assert configs.shape_applicable(tc, shape) == \
                    jconfigs.shape_applicable(jc, jconfigs.SHAPES[name]), (arch, name)


def test_configs_package_reexports_jax_names():
    """Every public name ``repro.configs`` re-exports, the port's package
    has too (the registry's ``get_config`` and ``ARCH_IDS`` included)."""
    names = {n for n in dir(jconfigs) if not n.startswith("_")} - {
        "base", "registry"}
    missing = {n for n in names if not hasattr(configs, n)}
    assert not missing, missing
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.get_config is registry.get_config


# ---------------------------------------------------------------------------
# the engine's knobs
# ---------------------------------------------------------------------------

def test_engine_config_knobs_match_jax():
    """Defaults, and ``buckets()`` with and without ``prefill_buckets``."""
    t, j = engine.EngineConfig(), jengine.EngineConfig()
    for name in ("prefill_buckets", "telemetry", "occupancy_ewma"):
        assert getattr(t, name) == getattr(j, name), name
    for kw in ({}, dict(max_prompt_len=100), dict(prefill_buckets=(32, 8, 64, 8)),
               dict(max_prompt_len=8)):
        assert engine.EngineConfig(**kw).buckets() == jengine.EngineConfig(**kw).buckets()


@pytest.fixture(scope="module")
def tiny():
    cfg = registry.get_config("internlm2-20b").reduced(n_layers=1)
    return cfg, lm.init(cfg, seed=0, device="cpu")


def test_prefill_buckets_must_top_out_at_max_prompt_len(tiny):
    """The port refuses buckets that disagree with ``max_prompt_len`` with
    the JAX engine's message (which raises before it reads the params)."""
    cfg, params = tiny
    kw = dict(num_slots=2, max_len=48, max_prompt_len=16, prefill_buckets=(8, 32))
    jcfg = jregistry.get_config("internlm2-20b").reduced(n_layers=1)
    with pytest.raises(ValueError) as want:
        jengine.ContinuousBatchingEngine(None, jcfg, jengine.EngineConfig(**kw))
    with pytest.raises(ValueError) as got:
        engine.ContinuousBatchingEngine(params, cfg,
                                        engine.EngineConfig(device="cpu", **kw))
    assert str(got.value) == str(want.value)


def test_buckets_and_telemetry_off_serve_the_same_tokens(tiny):
    """Custom buckets dispatch only their slab widths, and an engine without
    telemetry serves the same greedy tokens while its occupancy rows hold
    only the seeded priors, so the profile store is never fed (JAX's
    ``test_profiles_not_fed_by_seeded_priors``)."""
    cfg, params = tiny
    r = np.random.default_rng(0)
    prompts = [r.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (3, 9, 16, 5)]

    def run(**kw):
        eng = engine.ContinuousBatchingEngine(params, cfg, engine.EngineConfig(
            num_slots=2, max_len=24, max_prompt_len=16, device="cpu", **kw))
        res, _ = eng.run([Request(rid=i, prompt=p, max_new_tokens=4, tenant="t0")
                          for i, p in enumerate(prompts)])
        return eng, {x.rid: x.tokens.tolist() for x in res}

    _, base = run()
    eng, toks = run(prefill_buckets=(8, 16))
    assert toks == base
    assert {k for k in eng.compiled_shapes() if k.startswith("prefill_")} == {
        "prefill_8", "prefill_16"}
    eng, toks = run(telemetry=False)
    assert toks == base
    assert eng.profiles is not None and eng.profiles.n_updates("t0") == 0


def test_occupancy_ewma_folds_as_jax():
    """``_update_occupancy`` under ``occupancy_ewma`` 0.8: the port's and
    JAX's methods fold the same count stream into the same rows."""
    E, S = 6, 3
    r = np.random.default_rng(3)
    stream = [r.integers(0, 5, (S, E)).astype(np.float64) for _ in range(5)]
    stream[2][1] = 0                     # a row with no tokens keeps its value
    states = []
    for mod in (engine, jengine):
        st = types.SimpleNamespace(ecfg=mod.EngineConfig(occupancy_ewma=0.8),
                                   occupancy=np.zeros((S, E)),
                                   _measured=np.zeros(S, bool))
        for i, counts in enumerate(stream):
            mod.ContinuousBatchingEngine._update_occupancy(
                st, [0, 1, 2], counts, measured=i % 2 == 0)
        states.append(st)
    np.testing.assert_allclose(states[0].occupancy, states[1].occupancy, rtol=1e-12)
    np.testing.assert_array_equal(states[0]._measured, states[1]._measured)


def test_tenant_queue_depth_matches_jax():
    tq, jq = engine.TenantQueues(), jengine.TenantQueues()
    reqs = [(Request(rid=i, prompt=[1], tenant=t), JRequest(rid=i, prompt=[1], tenant=t))
            for i, t in enumerate("aabacb")]
    for a, b in reqs:
        tq.append(a)
        jq.append(b)
    for i in (0, 3, 4):
        tq.remove(reqs[i][0])
        jq.remove(reqs[i][1])
        for t in "abcz":
            assert tq.depth(t) == jq.depth(t), (i, t)


# ---------------------------------------------------------------------------
# lm.prefill_padded
# ---------------------------------------------------------------------------

def test_prefill_padded_matches_jax():
    """Right-padded prompts of lengths 5, 12 and 8 in a 12-token slab: the
    logits at each row's last real token and the cache lengths."""
    jcfg = jregistry.get_config("internlm2-20b").reduced(n_layers=2)
    tcfg = registry.get_config("internlm2-20b").reduced(n_layers=2)
    r = np.random.default_rng(5)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, s: (jnp.ones(s.shape, s.dtype) if path[-1].key == "scale"
                         else jnp.asarray(r.normal(size=s.shape) / 4.0, s.dtype)), shapes)
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    tokens = r.integers(0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    true_len = np.array([5, 12, 8], np.int32)

    @jax.jit
    def jrun(p, toks, n):
        caches = jlm.init_caches(jcfg, 3, 16)
        logits, caches, _ = jlm.prefill_padded(p, jcfg, {"tokens": toks}, caches, n)
        return logits, [c["kv"].length for c in caches]

    want, jlens = jrun(jp, tokens, true_len)
    with torch.inference_mode():
        caches = lm.init_caches(tcfg, 3, 16, device="cpu")
        got, caches, stats = lm.prefill_padded(tp, tcfg, {"tokens": tokens}, caches,
                                               torch.from_numpy(true_len))
    assert stats is None
    close(got.numpy(), want)
    for c in caches:
        np.testing.assert_array_equal(c["kv"].length.numpy(), true_len)
    np.testing.assert_array_equal(np.asarray(jlens[0])[0], true_len)


# ---------------------------------------------------------------------------
# core/api: ExecutionSpec.rng, FFFOutput.as_dict
# ---------------------------------------------------------------------------

def test_execution_spec_rng_drives_training():
    """``rng`` (JAX's field name) is the one training generator: child
    transposition draws from it, the same seed gives the same output and
    another seed another; there is no second generator field."""
    names = {f.name for f in dataclasses.fields(api.ExecutionSpec)}
    assert "rng" in {f.name for f in dataclasses.fields(japi.ExecutionSpec)} & names
    assert "gen" not in names
    cfg = fff.FFFConfig(dim_in=16, dim_out=8, depth=3, leaf_width=4,
                        transposition_prob=0.5)
    params = fff.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(32, 16, generator=torch.Generator().manual_seed(1))
    g = lambda s: torch.Generator().manual_seed(s)
    run = lambda **kw: api.apply(params, cfg, x, api.ExecutionSpec(mode="train", **kw))[0]
    torch.testing.assert_close(run(rng=g(3)), run(rng=g(3)), rtol=0, atol=0)
    assert not torch.equal(run(rng=g(3)), run(rng=g(4)))


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_fff_output_as_dict_matches_jax(mode):
    """The same fields, holding the same values, for the reference
    backend's output in each mode."""
    jcfg = jfff.FFFConfig(dim_in=16, dim_out=8, depth=3, leaf_width=4)
    tcfg = fff.FFFConfig(dim_in=16, dim_out=8, depth=3, leaf_width=4)
    jp = jfff.init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(2).normal(size=(12, 16)).astype(np.float32)
    _, jout = jax.jit(lambda p, x: japi.apply(p, jcfg, x, japi.ExecutionSpec(
        mode=mode, backend="reference")))(jp, x)
    _, tout = api.apply(weights.tree(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
                        tcfg, torch.from_numpy(x),
                        api.ExecutionSpec(mode=mode, backend="reference"))
    want, got = jout.as_dict(), tout.as_dict()
    assert set(got) == set(want)
    for k in want:
        close(got[k].detach().numpy(), want[k])


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_utils_helpers_match_jax():
    r = np.random.default_rng(0)
    tree_np = {"a": r.normal(size=(3, 4)).astype(np.float32),
               "b": [r.normal(size=(5,)).astype(np.float32),
                     np.arange(6, dtype=np.int32).reshape(2, 3)]}
    jt = jax.tree_util.tree_map(jnp.asarray, tree_np)
    tt = weights.tree(tree_np, "cpu")
    assert utils.tree_size(tt) == jutils.tree_size(jt) == 23
    assert utils.tree_bytes(tt) == jutils.tree_bytes(jt)
    cast = utils.tree_cast(tt, torch.bfloat16)
    assert {t.dtype for t in utils.tree_leaves(cast)} == {torch.bfloat16}
    assert utils.tree_bytes(cast) == jutils.tree_bytes(jutils.tree_cast(jt, jnp.bfloat16))
    zeros = utils.tree_zeros_like(tt)
    assert all(not t.any() and t.dtype == s.dtype for t, s in
               zip(utils.tree_leaves(zeros), utils.tree_leaves(tt)))
    assert bool(utils.tree_finite(tt)) == bool(jutils.tree_finite(jt)) is True
    tree_np["a"][1, 2] = np.inf
    assert bool(utils.tree_finite(weights.tree(tree_np, "cpu"))) == bool(
        jutils.tree_finite(jax.tree_util.tree_map(jnp.asarray, tree_np))) is False
    for n in range(0, 70):
        assert utils.next_pow2(n) == jutils.next_pow2(n), n
        assert utils.is_pow2(n) == jutils.is_pow2(n), n
    for n in (0, 1, 1023, 1024, 5e6, 3.2e9, 7.7e12, 2.5e15, -4096):
        assert utils.human_bytes(n) == jutils.human_bytes(n), n
        assert utils.human_flops(n) == jutils.human_flops(n), n
    cfg = fff.FFFConfig(dim_in=4, dim_out=4, depth=2, leaf_width=2)
    assert utils.replace(cfg, depth=5).depth == 5
    assert utils.asdict_shallow(cfg).keys() == jutils.asdict_shallow(
        jfff.FFFConfig(dim_in=4, dim_out=4, depth=2, leaf_width=2)).keys()
    assert utils.asdict_shallow(cfg)["leaf_width"] == 2
