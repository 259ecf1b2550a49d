"""The port's capacity-bounded dispatch against the JAX package's, on the CPU.

The same numpy-drawn parameters and tokens go through both packages: the
dispatch-plan math (slots, capacity plans, the expert-parallel plan and
its capacity law) must match exactly; ``grouped_leaf_apply`` with one and
two data shards, and the ``grouped`` and one-process ``grouped_ep``
backends under all three overflow policies, must give the same ``kept``
masks, leaf indices and overflow fractions and the same outputs within the
``kernel`` tolerance of ``tests/conftest.py`` (float32 1e-4, bf16 5e-2).
Also: the spec and override validation and nesting, the exchange's byte
model, ``auto`` on a wide CPU site (both packages resolve it to
``grouped``), and the CUDA glue of the leaf MLP, driven here through the
kernels' plain versions.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.core import api as japi
from repro.core import fff as jfff
from repro.core import routing as jrouting
from repro.distributed import act as jact
from repro.distributed import dispatch as jdispatch
from repro_torch import weights
from repro_torch.core import api, fff, routing
from repro_torch.distributed import act as tact
from repro_torch.distributed import dispatch

torch.set_num_threads(2)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
POLICIES = ("exact_dense", "master_leaf", "drop")


def rng(seed):
    return np.random.default_rng(seed)


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def close(got, want, dtype="float32", kind="kernel"):
    rtol, atol = dtype_tol(JDT[dtype], kind)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def fff_pair(seed, *, depth=3, act="gelu", trees=2, dim=16, dim_out=12,
             leaf=8, master=True, bias=False, dtype="float32", skew=0.0):
    """One FFF layer drawn with numpy under the JAX package's keys and
    shapes, in both packages; ``skew`` shifts the root's bias so most
    tokens go right and the right half's leaves overflow."""
    kw = dict(dim_in=dim, dim_out=dim_out, depth=depth, leaf_width=leaf,
              activation=act, trees=trees, leaf_bias=bias, master_leaf=master)
    shapes = {k: tuple(v.shape) for k, v in
              fff.init(torch.Generator().manual_seed(0), fff.FFFConfig(**kw)).items()}
    r = rng(seed)
    params = {}
    for k, shp in shapes.items():
        fan_in = shp[-2] if len(shp) >= 2 and not k.startswith(("node_b", "leaf_b")) else 1
        params[k] = r.normal(size=shp) / np.sqrt(fan_in)
        if k.startswith(("node_b", "leaf_b")):
            params[k] *= 0.1
    params["node_b2"][:, 0] += skew
    jp = {k: jnp.asarray(v, JDT[dtype]) for k, v in params.items()}
    tp = weights.tree({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    pd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jp, jfff.FFFConfig(**kw, param_dtype=JDT[dtype]), tp, \
        fff.FFFConfig(**kw, param_dtype=pd)


def tokens(seed, B, dim=16, dtype="float32"):
    a = rng(seed).normal(size=(B, dim))
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])


def leaf_idx(seed, B, E, skewed=True):
    """Routed leaf ids with half the tokens on leaf 1, so capacity bites."""
    idx = rng(seed).integers(0, E, B)
    if skewed:
        idx[::2] = 1
    return jnp.asarray(idx, jnp.int32), torch.from_numpy(idx.astype(np.int32))


def japply(jp, jcfg, jx, valid=None, **spec):
    return jax.jit(lambda p, x, v: japi.apply(
        p, jcfg, x, japi.ExecutionSpec(mode="infer", valid=v, **spec)))(jp, jx, valid)


# ---------------------------------------------------------------------------
# the dispatch-plan math, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 37, 61])
def test_group_slots_match_jax(B):
    ji, ti = leaf_idx(B, B, 8)
    same(routing.group_slots(ti, 8), jrouting.group_slots(ji, 8))
    # the sentinel id E slots as a ninth group
    ti[::3] = 8
    same(routing.group_slots(ti, 9), jrouting.group_slots(jnp.asarray(ti.numpy()), 9))


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
def test_capacity_dispatch_matches_jax(cf):
    ji, ti = leaf_idx(3, 61, 8)
    t = routing.make_capacity_dispatch(ti, 8, capacity_factor=cf)
    j = jrouting.make_capacity_dispatch(ji, 8, capacity_factor=cf)
    assert t.capacity == j.capacity and t.num_leaves == j.num_leaves
    same(t.flat_idx, j.flat_idx)
    same(t.kept, j.kept)
    jx, tx = tokens(4, 61)
    buf = routing.capacity_gather(tx, t)
    same(buf, jrouting.capacity_gather(jx, j))
    y = torch.from_numpy(rng(5).normal(size=(8, t.capacity, 6)).astype(np.float32))
    same(routing.capacity_scatter(y, t),
         jrouting.capacity_scatter(jnp.asarray(y.numpy()), j))


@pytest.mark.parametrize("M", [1, 2, 4])
def test_ep_plan_matches_jax(M):
    """make_ep_plan (with a validity mask), its scatter into the (M, E/M, C,
    D) send buffer and its gather back, and ep_capacity's law."""
    E, B, D = 8, 37, 5
    ji, ti = leaf_idx(6, B, E)
    valid = rng(7).random(B) > 0.2
    C = dispatch.ep_capacity(B, E, 0.5)
    assert C == jdispatch.ep_capacity(B, E, 0.5) == 8
    t = dispatch.make_ep_plan(ti, routing.group_slots(ti, E), torch.from_numpy(valid),
                              E, M, C)
    j = jdispatch.make_ep_plan(ji, jrouting.group_slots(ji, E), jnp.asarray(valid),
                               E, M, C)
    same(t.flat_idx, j.flat_idx)
    same(t.kept, j.kept)
    assert t.groups_local == j.groups_local == E // M
    jx, tx = tokens(8, B, dim=D)
    send = dispatch.ep_scatter(tx, t)
    same(send, jdispatch.ep_scatter(jx, j))
    same(dispatch.ep_gather(send.reshape(E * C, D), t),
         jdispatch.ep_gather(jnp.asarray(send.numpy()).reshape(E * C, D), j))
    for tps in (1, 7, 64, 509):
        for cf in (0.25, 1.25, 3.0):
            assert dispatch.ep_capacity(tps, E, cf) == jdispatch.ep_capacity(tps, E, cf)


def test_ep_plan_rejects_indivisible_groups():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="divide"):
        dispatch.make_ep_plan(z, z, torch.ones(4, dtype=torch.bool), 6, 4, 2)


def test_sorted_dispatch_matches_jax():
    ji, ti = leaf_idx(9, 37, 8)
    t, j = routing.make_sorted_dispatch(ti, 8), jrouting.make_sorted_dispatch(ji, 8)
    for a, b in zip(t, j):
        same(a, b)
    jx, tx = tokens(10, 37)
    xs = routing.apply_sorted(tx, t)
    same(xs, jrouting.apply_sorted(jx, j))
    same(routing.unapply_sorted(xs, t), tx)
    w = rng(11).normal(size=(8, 16, 4)).astype(np.float32)
    close(routing.grouped_leaf_matmul_ref(xs, t.leaf_ids_sorted, torch.from_numpy(w)),
          jrouting.grouped_leaf_matmul_ref(jnp.asarray(xs.numpy()), j.leaf_ids_sorted,
                                           jnp.asarray(w)))
    same(routing.leaf_histogram(ti, 8), jrouting.leaf_histogram(ji, 8))
    assert float(routing.routing_skew(ti, 8)) == pytest.approx(
        float(jrouting.routing_skew(ji, 8)), rel=1e-6)


def test_ep_bytes_moved_matches_jax():
    for args in ((32, 4, 128, 128, 8), (16, 2, 6144, 6144, 136, 2), (8, 1, 16, 12, 8)):
        for policy in POLICIES:
            for tps in (0, 256):
                kw = dict(overflow_policy=policy, tokens_per_shard=tps)
                assert dispatch.ep_bytes_moved(*args, **kw) == \
                    jdispatch.ep_bytes_moved(*args, **kw)
    base = dispatch.ep_bytes_moved(32, 4, 128, 128, 8)
    assert dispatch.ep_bytes_moved(32, 4, 128, 128, 8, overflow_policy="exact_dense",
                                   tokens_per_shard=256) > base > 0


# ---------------------------------------------------------------------------
# grouped leaf execution and the capacity-bounded backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("B", [37, 61])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_grouped_leaf_apply_matches_jax(monkeypatch, G, B, act):
    """Output and kept mask with the token axis blocked by G data shards
    (B % G != 0 pads with capacity-neutral tokens)."""
    jp, _, tp, _ = fff_pair(20, act=act, trees=1, master=False, bias=act == "gelu")
    jl = {k: v[0] for k, v in jp.items() if k.startswith("leaf_")}
    tl = {k: v[0] for k, v in tp.items() if k.startswith("leaf_")}
    ji, ti = leaf_idx(21, B, 8)
    jx, tx = tokens(22, B)
    monkeypatch.setattr(jact, "data_shard_count", lambda: G)
    monkeypatch.setattr(tact, "data_shard_count", lambda: G)
    jy, jk = jrouting.grouped_leaf_apply(jx, ji, jl, act, capacity_factor=1.0,
                                         return_kept=True)
    y, k = routing.grouped_leaf_apply(tx, ti, tl, act, capacity_factor=1.0,
                                      return_kept=True)
    same(k, jk)
    assert not bool(k.all()) and bool(k.any())        # the bound bit
    close(y, jy)


@pytest.mark.parametrize("cf", [0.5, 2.0])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("backend", ["grouped", "grouped_ep"])
def test_capacity_backends_match_jax(backend, policy, cf):
    """Two trees with a master leaf, B = 61 as (61, 1) rows of which a
    quarter are invalid (phantom rows: sentinel leaf, no capacity, no
    overflow): y, leaf_idx and overflow_fraction against JAX."""
    jp, jcfg, tp, tcfg = fff_pair(30, skew=1.5)
    jx, tx = tokens(31, 61)
    valid = rng(32).random((61, 1)) > 0.25
    jy, jout = japply(jp, jcfg, jx[:, None], jnp.asarray(valid), backend=backend,
                      capacity_factor=cf, overflow_policy=policy)
    y, out = api.apply(tp, tcfg, tx[:, None], api.ExecutionSpec(
        backend=backend, capacity_factor=cf, overflow_policy=policy,
        valid=torch.from_numpy(valid)))
    same(out.leaf_idx, jout.leaf_idx)
    assert (out.leaf_idx[~torch.from_numpy(valid)] == tcfg.num_leaves).all()
    assert float(out.overflow_fraction) == pytest.approx(
        float(jout.overflow_fraction), abs=1e-6)
    if cf == 0.5:
        assert float(out.overflow_fraction) > 0
    close(y, jy)


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("backend", ["grouped", "grouped_ep"])
def test_capacity_backends_defaults_match_jax(backend, B):
    """The backends' own capacity factors and policies, no validity mask,
    odd token counts; grouped_ep's default policy is exact."""
    jp, jcfg, tp, tcfg = fff_pair(33, act="swiglu", trees=1, master=False, skew=1.5)
    jx, tx = tokens(34, B)
    jy, jout = japply(jp, jcfg, jx, backend=backend)
    y, out = api.apply(tp, tcfg, tx, api.ExecutionSpec(backend=backend))
    same(out.leaf_idx, jout.leaf_idx)
    assert float(out.overflow_fraction) == pytest.approx(
        float(jout.overflow_fraction), abs=1e-6)
    close(y, jy)
    if backend == "grouped_ep":
        ref, _ = api.apply(tp, tcfg, tx, api.ExecutionSpec(backend="reference"))
        close(y, ref.numpy())


@pytest.mark.parametrize("backend", ["grouped", "grouped_ep"])
def test_capacity_backends_bf16_match_jax(backend):
    jp, jcfg, tp, tcfg = fff_pair(35, act="swiglu", dtype="bfloat16", skew=1.5)
    jx, tx = tokens(36, 61, dtype="bfloat16")
    jy, jout = japply(jp, jcfg, jx, backend=backend, capacity_factor=0.5)
    y, out = api.apply(tp, tcfg, tx, api.ExecutionSpec(backend=backend,
                                                       capacity_factor=0.5))
    same(out.leaf_idx, jout.leaf_idx)
    close(y, jy, dtype="bfloat16")


def test_auto_resolves_wide_cpu_sites_to_grouped():
    """A site of num_leaves * leaf_width >= AUTO_GROUPED_MIN_WIDTH resolves
    to grouped on the CPU in both packages, and the two auto outputs agree
    where leaves overflow (drop zeroes the same tokens); narrow sites stay on
    the reference."""
    assert api.AUTO_GROUPED_MIN_WIDTH == japi.AUTO_GROUPED_MIN_WIDTH
    jp, jcfg, tp, tcfg = fff_pair(37, act="swiglu", trees=1, master=False,
                                  leaf=512, skew=1.5)
    cpu = torch.device("cpu")
    assert api.resolve_backend(tp, tcfg, "infer", (4, 9, 16), cpu) == "grouped"
    assert japi.resolve_backend(jp, jcfg, "infer", (4, 9, 16)) == "grouped"
    narrow = fff_pair(38)[3]
    assert api.resolve_backend({}, narrow, "infer", (4, 9, 16), cpu) == "reference"
    jx, tx = tokens(39, 64)
    jy, jout = japply(jp, jcfg, jx.reshape(4, 16, 16))
    y, out = api.apply(tp, tcfg, tx.reshape(4, 16, 16))
    assert float(out.overflow_fraction) > 0
    assert float(out.overflow_fraction) == pytest.approx(
        float(jout.overflow_fraction), abs=1e-6)
    same(out.leaf_idx, jout.leaf_idx)
    close(y, jy)


@pytest.mark.parametrize("act,bias", [("swiglu", False), ("gelu", False),
                                      ("gelu", True), ("tanh", True)])
def test_leaf_mlp_kernel_glue_matches_jax(monkeypatch, act, bias):
    """The card's branch of the leaf MLP (the grouped kernels, activations
    and biases applied between launches), driven with CPU tensors, whose
    kernel wrappers run the plain versions: one launch per projection, and
    the grouped backend's output against JAX."""
    launches = []
    for name in ("grouped_matmul", "grouped_matmul_dual"):
        fn = getattr(routing.gemm_kernel, name)
        monkeypatch.setattr(routing.gemm_kernel, name, lambda *a, _fn=fn, _n=name, **kw: (
            launches.append((_n, a[-1].dtype)), _fn(*a, **kw))[1])
    monkeypatch.setattr(routing, "_leaf_mlp_on_buffers", lambda xb, p, a, ad, gs=None:
                        routing._leaf_mlp_kernels(xb, p, a, gs).to(ad))
    jp, jcfg, tp, tcfg = fff_pair(40, act=act, trees=1, master=False, bias=bias, skew=1.5)
    jx, tx = tokens(41, 61)
    jy, _ = japply(jp, jcfg, jx, backend="grouped", capacity_factor=0.5)
    y, _ = api.apply(tp, tcfg, tx, api.ExecutionSpec(backend="grouped",
                                                     capacity_factor=0.5))
    close(y, jy)
    want = ["grouped_matmul_dual", "grouped_matmul"] if act == "swiglu" else \
        ["grouped_matmul", "grouped_matmul"]
    assert launches == [(n, torch.int32) for n in want]


def test_leaf_mlp_kernel_failure_raises(monkeypatch):
    """The card's branch never falls back to the einsums: a kernel that does
    not build raises out of the grouped backend."""
    def no_nvcc(*a, **kw):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(routing.gemm_kernel, "grouped_matmul_dual", no_nvcc)
    _, _, tp, _ = fff_pair(42, act="swiglu", trees=1, master=False)
    tl = {k: v[0] for k, v in tp.items() if k.startswith("leaf_")}
    with pytest.raises(RuntimeError, match="nvcc"):
        routing._leaf_mlp_kernels(torch.zeros(8, 8, 16), tl, "swiglu", None)


# ---------------------------------------------------------------------------
# ExecutionSpec and overrides
# ---------------------------------------------------------------------------

def test_defaults_match_jax():
    assert api.OVERFLOW_POLICIES == japi.OVERFLOW_POLICIES
    for b in ("grouped", "grouped_ep"):
        assert api.default_overflow_policy(b) == japi.default_overflow_policy(b)
        for mode in ("infer", "train"):
            assert api.default_capacity_factor(b, mode) == \
                japi.default_capacity_factor(b, mode)
    assert api.default_overflow_policy("grouped_ep") == "exact_dense"
    assert api.default_overflow_policy("grouped") == "drop"
    assert {"grouped", "grouped_ep"} <= set(api.list_backends("infer"))


def test_spec_rejects_unknown_policy():
    with pytest.raises(ValueError, match="overflow_policy"):
        api.ExecutionSpec(overflow_policy="densely").validate()


def test_master_leaf_policy_requires_master_leaf_config():
    _, _, tp, tcfg = fff_pair(43, master=False)
    with pytest.raises(ValueError, match="master_leaf"):
        api.apply(tp, tcfg, torch.zeros(16, 16), api.ExecutionSpec(
            backend="grouped", overflow_policy="master_leaf"))


def test_master_leaf_equals_drop_numerics_on_grouped():
    _, _, tp, tcfg = fff_pair(44, skew=1.5)
    _, tx = tokens(45, 61)
    ys = [api.apply(tp, tcfg, tx, api.ExecutionSpec(
        backend="grouped", capacity_factor=0.5, overflow_policy=p))[0]
        for p in ("master_leaf", "drop")]
    assert torch.equal(*ys)


def test_overrides_sets_any_subset_at_once():
    st = api._thread_state
    with api.overrides(backend="grouped", mode="infer", capacity_factor=4.0,
                       overflow_policy="drop"):
        assert st.override == ("grouped", "infer")
        assert st.capacity_override == 4.0
        assert st.overflow_override == "drop"
    for a in ("override", "capacity_override", "overflow_override"):
        assert getattr(st, a, None) is None


def test_overrides_nesting_inner_wins_per_field():
    st = api._thread_state
    with api.overrides(capacity_factor=2.0):
        with api.overrides(backend="reference"):
            assert st.capacity_override == 2.0
            assert st.override == ("reference", None)
        with api.overrides(capacity_factor=0.5):
            assert st.capacity_override == 0.5
        assert st.capacity_override == 2.0
        assert getattr(st, "override", None) is None
    assert getattr(st, "capacity_override", None) is None


def test_overrides_fill_unset_spec_fields_only(monkeypatch):
    seen = {}
    orig = fff._forward_hard_grouped

    def spy(*a, **kw):
        seen.update(cf=kw["capacity_factor"], policy=kw["overflow_policy"])
        return orig(*a, **kw)

    monkeypatch.setattr(fff, "_forward_hard_grouped", spy)
    _, _, tp, tcfg = fff_pair(46)
    x = torch.zeros(32, 16)
    with api.overrides(capacity_factor=4.0, overflow_policy="master_leaf"):
        api.apply(tp, tcfg, x, api.ExecutionSpec(backend="grouped"))
        assert seen == {"cf": 4.0, "policy": "master_leaf"}
        api.apply(tp, tcfg, x, api.ExecutionSpec(
            backend="grouped", capacity_factor=1.0, overflow_policy="drop"))
        assert seen == {"cf": 1.0, "policy": "drop"}
    with api.overrides(backend="grouped", mode="infer"):
        assert api.resolve_backend(tp, tcfg, "infer", (4, 16), torch.device("cpu")) \
            == "grouped"


def test_overrides_validation_is_eager():
    with pytest.raises(KeyError, match="any mode"):
        api.overrides(backend="palas")
    with pytest.raises(ValueError, match="mode"):
        api.overrides(backend="grouped", mode="decode")
    with pytest.raises(ValueError, match="backend"):
        api.overrides(mode="infer")
    with pytest.raises(ValueError, match="positive"):
        api.overrides(capacity_factor=0.0)
    with pytest.raises(ValueError, match="overflow_policy"):
        api.overrides(overflow_policy="dense")


def test_deprecated_aliases_warn_and_still_work():
    st = api._thread_state
    for alias, args, attr, want in [
            (api.use_backend, ("reference",), "override", ("reference", None)),
            (api.use_capacity_factor, (3.0,), "capacity_override", 3.0),
            (api.use_overflow_policy, ("drop",), "overflow_override", "drop")]:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cm = alias(*args)
        assert any(issubclass(x.category, DeprecationWarning)
                   and "overrides(" in str(x.message) for x in w), alias.__name__
        with cm:
            assert getattr(st, attr) == want
        assert getattr(st, attr, None) is None
