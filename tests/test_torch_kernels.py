"""The port's kernel modules against the JAX package, on the CPU.

Each CUDA kernel of ``repro_torch`` has a plain PyTorch version, which is
what its wrapper runs for CPU tensors.  Here those plain versions, the
kernel-path plumbing around them (padding, slotting, overflow repair,
node collapse) and the FFF layer through ``api.apply`` get the same numpy
inputs as the JAX package: the Pallas kernels in interpret mode where they
run under this jax (tree_router, grouped_matmul(_dual)), the oracles
otherwise (``fused_decode/ref.py``, whose Pallas megakernel no longer
traces under jax 0.9.0).  Tolerances come from ``conftest.dtype_tol``;
leaf indices must match exactly.  The kernels themselves run on the card,
in ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.core import api as japi
from repro.core import fff as jfff
from repro.core import routing as jrouting
from repro.kernels import common as jcommon
from repro.kernels.fused_decode import ops as jfd_ops
from repro.kernels.leaf_gemm import kernel as jgk
from repro.kernels.leaf_gemm import ops as jg_ops
from repro.kernels.leaf_gemm import ref as jgr
from repro.kernels.tree_router import ops as jrouter
from repro.kernels.tree_router import ref as jrouter_ref
from repro_torch import utils, weights
from repro_torch.core import api, fff, routing
from repro_torch.kernels import common
from repro_torch.kernels.fused_decode import kernel as fdk
from repro_torch.kernels.fused_decode import ops as fd_ops
from repro_torch.kernels.leaf_gemm import kernel as gk
from repro_torch.kernels.leaf_gemm import ops as g_ops
from repro_torch.kernels.tree_router import ops as router

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16"]
DEPTHS = [1, 2, 4]
LEAF_WIDTHS = [4, 8]
ODD_BATCHES = [1, 7, 37]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def rng(seed):
    return np.random.default_rng(seed)


def both(a, dtype="float32"):
    """One numpy array as (jax array, CPU tensor) of ``dtype``."""
    ja = jnp.asarray(a, JDT[dtype])
    return ja, weights.tensor(np.asarray(ja), device="cpu")


def close(got, want, dtype="float32", kind="kernel"):
    rtol, atol = dtype_tol(JDT[dtype], kind)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=rtol, atol=atol)


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def fff_pair(seed, *, depth=3, act="gelu", trees=1, dim=16, leaf=8,
             master=False, dtype="float32"):
    """One FFF layer's parameters, drawn with numpy under the JAX package's
    keys and shapes, in both packages: (jax params, jax cfg, tensors, cfg)."""
    kw = dict(dim_in=dim, dim_out=dim, depth=depth, leaf_width=leaf,
              activation=act, trees=trees, leaf_bias=False, master_leaf=master)
    tcfg = fff.FFFConfig(**kw)
    shapes = {k: tuple(v.shape) for k, v in
              fff.init(torch.Generator().manual_seed(0), tcfg).items()}
    r = rng(seed)
    params = {}
    for k, shp in shapes.items():
        fan_in = shp[-2] if len(shp) >= 2 and not k.startswith("node_b") else 1
        params[k] = r.normal(size=shp) / np.sqrt(fan_in)
        if k.startswith("node_b"):
            params[k] *= 0.1
    jp = {k: jnp.asarray(v, JDT[dtype]) for k, v in params.items()}
    tp = weights.tree({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return jp, jfff.FFFConfig(**kw), tp, tcfg


# ---------------------------------------------------------------------------
# utils / common
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["relu", "gelu", "silu", "tanh", "identity"])
def test_activations_match_jax(name):
    from repro import utils as jutils
    jx, tx = both(rng(0).normal(0, 3, (64,)))
    close(utils.get_activation(name)(tx), jutils.get_activation(name)(jx))


def test_shape_helpers():
    x = torch.zeros(2, 3, 5)
    xf, lead = utils.flatten_leading(x)
    assert xf.shape == (6, 5) and lead == (2, 3)
    assert utils.unflatten_leading(xf, lead).shape == (2, 3, 5)
    assert utils.cdiv(7, 2) == 4 and utils.round_up(7, 4) == 8


def test_pick_tile_matches_jax():
    for n in (1, 7, 8, 20, 37, 96, 100, 128, 1000):
        for preferred in (1, 8, 12, 64, 128):
            assert common.pick_tile(n, preferred) == jcommon.pick_tile(n, preferred)
    with pytest.raises(ValueError):
        common.pick_tile(0, 8)


def test_group_slots_matches_jax():
    idx = rng(1).integers(0, 5, (41,)).astype(np.int32)
    same(routing.group_slots(torch.from_numpy(idx), 5),
         jrouting.group_slots(jnp.asarray(idx), 5))


# ---------------------------------------------------------------------------
# tree_router
# ---------------------------------------------------------------------------

def _router_inputs(seed, B, depth, dim=32, dtype="float32"):
    r = rng(seed)
    N = 2 ** depth - 1
    return (both(r.normal(size=(B, dim)), dtype),
            both(r.normal(size=(N, dim)) / np.sqrt(dim), dtype),
            both(r.normal(size=(N,)) * 0.1, dtype))


@pytest.mark.parametrize("B", ODD_BATCHES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_router_matches_jax(depth, B):
    (jx, tx), (jw, tw), (jb, tb) = _router_inputs(depth * 100 + B, B, depth)
    got = router.route(tx, tw, tb, depth=depth)
    same(got, jrouter.route(jx, jw, jb, depth=depth, interpret=True))
    same(got, jrouter_ref.tree_router_ref(jx, jw, jb, depth=depth))


@pytest.mark.parametrize("dtype", DTYPES)
def test_router_dtypes(dtype):
    (jx, tx), (jw, tw), (jb, tb) = _router_inputs(3, 64, 4, dtype=dtype)
    same(router.route(tx, tw, tb, depth=4),
         jrouter_ref.tree_router_ref(jx, jw, jb, depth=4))


def test_router_dense_levels_split():
    """Levels past ``dense_levels`` descend by per-token gathers."""
    (jx, tx), (jw, tw), (jb, tb) = _router_inputs(5, 37, 4)
    same(router.route(tx, tw, tb, depth=4, dense_levels=2),
         jrouter.route(jx, jw, jb, depth=4, dense_levels=2, interpret=True))


def test_router_all_gather_levels_match_jax():
    """``dense_levels=0``: every level by per-token gathers, no kernel."""
    (jx, tx), (jw, tw), (jb, tb) = _router_inputs(8, 37, 4)
    same(router.route(tx, tw, tb, depth=4, dense_levels=0),
         jrouter.route(jx, jw, jb, depth=4, dense_levels=0, interpret=True))


def test_router_all_one_leaf():
    depth, dim, B = 3, 16, 37
    N, E = 2 ** depth - 1, 2 ** depth
    jx, tx = both(rng(2).normal(size=(B, dim)))
    for target, bias in [(0, -1.0), (E - 1, 1.0)]:       # all-left / all-right
        jw, tw = both(np.zeros((N, dim)))
        jb, tb = both(np.full((N,), bias))
        got = router.route(tx, tw, tb, depth=depth)
        same(got, jrouter.route(jx, jw, jb, depth=depth, interpret=True))
        assert bool((got == target).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 33, 65])
@pytest.mark.parametrize("dim", [20, 24])
@pytest.mark.parametrize("depth", [5, 8])
def test_router_deep_trees_match_jax(depth, dim, B, dtype):
    """Depths past one 16-node tile (the CUDA kernel's 8-tile and 16-tile
    variants), D on and off the 16-byte vector, partial and multiple
    64-token tiles."""
    (jx, tx), (jw, tw), (jb, tb) = _router_inputs(depth * 1000 + dim * 10 + B, B,
                                                  depth, dim=dim, dtype=dtype)
    got = router.route(tx, tw, tb, depth=depth)
    assert got.dtype == torch.int32
    same(got, jrouter.route(jx, jw, jb, depth=depth, interpret=True))
    same(got, jrouter_ref.tree_router_ref(jx, jw, jb, depth=depth))


def test_route_hands_back_the_kernel_output(monkeypatch):
    """With every level dense, ``route`` returns the kernel's int32 tensor
    itself: no widening and narrowing launches around it."""
    from repro_torch.kernels.tree_router import kernel as trk
    out = torch.tensor([3, 1, 0], dtype=torch.int32)
    monkeypatch.setattr(trk, "tree_router",
                        lambda x, w, b, *, depth: out if depth == 2 else out % 2)
    (_, tx), (_, tw), (_, tb) = _router_inputs(9, 3, 2)
    assert router.route(tx, tw, tb, depth=2) is out
    got = router.route(tx, tw, tb, depth=2, dense_levels=1)   # gathers past level 1
    assert got is not out and got.dtype == torch.int32


def test_route_forest_matches_jax():
    r = rng(6)
    jx, tx = both(r.normal(size=(7, 16)))
    jw, tw = both(r.normal(size=(2, 7, 16)))
    jb, tb = both(r.normal(size=(2, 7)))
    same(router.route_forest(tx, tw, tb, depth=3),
         jrouter.route_forest(jx, jw, jb, depth=3, interpret=True))


# ---------------------------------------------------------------------------
# grouped_matmul / grouped_matmul_dual
# ---------------------------------------------------------------------------

def _grouped_inputs(seed, H, dtype, E=3, C=16, D=32, sizes=None):
    r = rng(seed)
    gs = (np.asarray(sizes) if sizes is not None
          else r.integers(0, C + 1, (E,))).astype(np.int32)
    mask = (np.arange(C)[None, :] < gs[:, None])[..., None]
    x = both(r.normal(size=(E, C, D)) * mask, dtype)
    ws = [both(r.normal(size=(E, D, H)) / np.sqrt(D), dtype) for _ in range(2)]
    return x, ws, (jnp.asarray(gs), torch.from_numpy(gs))


#: group sizes at the edges of the bf16 CUDA kernel's 64-row halves, all
#: in one call at capacity 128: empty, one row, a half less one, a half, a
#: half and one, full less one, full (chip_smoke.py's ragged phase holds
#: the kernel to its plain version at these on the card)
EDGE_SIZES = [0, 1, 63, 64, 65, 127, 128]
# (dtype, H, sizes): random sizes at capacity 16, then EDGE_SIZES at 128
GROUPED_CASES = (
    [pytest.param(dt, H, None, id=f"{dt}-{H}") for dt in DTYPES for H in LEAF_WIDTHS]
    + [pytest.param(dt, H, EDGE_SIZES, id=f"{dt}-{H}-edges")
       for dt in DTYPES for H in LEAF_WIDTHS])


def _case_inputs(seed, H, dtype, sizes):
    """The grouped inputs of a GROUPED_CASES row and the Pallas row tile."""
    if sizes is None:
        return _grouped_inputs(seed, H, dtype), 16
    return _grouped_inputs(seed, H, dtype, E=len(sizes), C=128, sizes=sizes), 64


@pytest.mark.parametrize("dtype,H,sizes", GROUPED_CASES)
def test_grouped_matmul_matches_jax(dtype, H, sizes):
    ((jx, tx), ((jw, tw), _), (jgs, tgs)), bc = _case_inputs(H, H, dtype, sizes)
    got = gk.grouped_matmul(tx, tw, tgs, act="gelu")
    close(got, jgk.grouped_matmul(jx, jw, jgs, act="gelu", block_c=bc,
                                  block_h=8, block_k=32, interpret=True), dtype)
    close(got, jgr.grouped_matmul_ref(jx, jw, jgs, act="gelu"), dtype)


@pytest.mark.parametrize("dtype,H,sizes", GROUPED_CASES)
def test_grouped_matmul_dual_matches_jax(dtype, H, sizes):
    ((jx, tx), ((jg, tg), (ju, tu)), (jgs, tgs)), bc = _case_inputs(
        10 + H, H, dtype, sizes)
    got = gk.grouped_matmul_dual(tx, tg, tu, tgs)
    close(got, jgk.grouped_matmul_dual(jx, jg, ju, jgs, block_c=bc, block_h=8,
                                       block_k=32, interpret=True), dtype)
    close(got, jgr.grouped_matmul_dual_ref(jx, jg, ju, jgs), dtype)


def test_grouped_matmul_skew_one_group():
    """All tokens in one group: at capacity 16, then at capacity 128 with
    that group at each of EDGE_SIZES; every other group, and every row
    past the group's size, comes out exactly zero."""
    for C, sizes in [(16, [16, 0, 0, 0])] + [(128, [s, 0, 0, 0]) for s in EDGE_SIZES]:
        (jx, tx), ((jw, tw), _), (jgs, tgs) = _grouped_inputs(
            9, 8, "float32", E=4, C=C, D=16, sizes=sizes)
        got = gk.grouped_matmul(tx, tw, tgs, act="relu")
        close(got, jgk.grouped_matmul(jx, jw, jgs, act="relu", block_c=min(C, 64),
                                      block_h=8, block_k=16, interpret=True))
        assert float(got[1:].abs().max()) == 0.0
        assert int(torch.count_nonzero(got[0, sizes[0]:])) == 0


def test_scatter_gather_groups_match_jax():
    r = rng(11)
    jx, tx = both(r.normal(size=(37, 8)))
    idx = r.integers(0, 4, (37,)).astype(np.int32)
    jl = jg_ops.scatter_to_groups(jx, jnp.asarray(idx), 4, 8)
    tl = g_ops.scatter_to_groups(tx, torch.from_numpy(idx), 4, 8)
    close(tl.x_grouped, jl.x_grouped)
    same(tl.kept, jl.kept)
    same(tl.slot, jl.slot)
    same(tl.group_sizes, jl.group_sizes)
    close(g_ops.gather_from_groups(tl.x_grouped, tl),
          jg_ops.gather_from_groups(jl.x_grouped, jl))


@pytest.mark.parametrize("act", ["swiglu", "relu"])
def test_leaf_mlp_overflow_repair_is_exact(act):
    """Skewed routing under a tight capacity drops tokens; the dense repair
    of the dropped ones makes the result exact, as in the JAX package."""
    jp, jcfg, tp, tcfg = fff_pair(12, depth=2, act=act, leaf=8)
    r = rng(12)
    jx, tx = both(r.normal(size=(37, 16)))
    idx = np.where(r.random(37) < 0.7, 1, r.integers(0, 4, (37,))).astype(np.int32)
    leaves_j = {k: v[0] for k, v in jp.items() if k.startswith("leaf_")}
    leaves_t = {k: v[0] for k, v in tp.items() if k.startswith("leaf_")}
    got = g_ops.fff_leaf_mlp(tx, torch.from_numpy(idx), leaves_t,
                             activation=act, capacity_factor=0.5, block_c=4)
    layout = g_ops.scatter_to_groups(tx, torch.from_numpy(idx), 4, 8)
    assert not bool(layout.kept.all())                 # tokens were dropped
    want = jg_ops.fff_leaf_mlp(jx, jnp.asarray(idx), leaves_j, activation=act,
                               capacity_factor=0.5, interpret=True, block_c=4,
                               block_h=4, block_k=8)
    close(got, want, kind="e2e")


@pytest.mark.parametrize("act,trees", [("swiglu", 1), ("gelu", 2)])
def test_fff_infer_matches_jax(act, trees):
    jp, jcfg, tp, tcfg = fff_pair(13, act=act, trees=trees)
    jx, tx = both(rng(13).normal(size=(40, 16)))
    y, idx = g_ops.fff_infer(tx, tp, tcfg, return_leaf_idx=True)
    jy, jidx = jg_ops.fff_infer(jx, jp, jcfg, interpret=True,
                                return_leaf_idx=True)
    same(idx, jidx)
    close(y, jy, kind="e2e")


# ---------------------------------------------------------------------------
# fused_forest_decode
# ---------------------------------------------------------------------------

# every depth, leaf width and odd batch, in both dtypes (each batch size
# meets each leaf width; batch 7 runs a two-tree forest)
FUSED_CASES = [(1, 4, "gelu", 1), (2, 4, "gelu", 7), (4, 4, "gelu", 37),
               (1, 8, "swiglu", 37), (2, 8, "swiglu", 1), (4, 8, "swiglu", 7)]


@pytest.mark.parametrize("depth,leaf,act,B", FUSED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_decode_matches_jax(dtype, depth, leaf, act, B):
    trees = 2 if B == 7 else 1
    jp, jcfg, tp, tcfg = fff_pair(depth * 10 + leaf, depth=depth, act=act,
                                  trees=trees, leaf=leaf, dtype=dtype)
    jx, tx = both(rng(B).normal(size=(B, 16)), dtype)
    y, idx = fd_ops.fused_decode(tx, tp, tcfg, return_leaf_idx=True)
    jy, jidx = jax.jit(lambda x, p: jfd_ops.fused_decode_ref(
        x, p, jcfg, return_leaf_idx=True))(jx, jp)
    same(idx, jidx)
    close(y, jy, dtype)


@pytest.mark.parametrize("act", ["relu", "gelu", "swiglu"])
def test_fused_decode_master_leaf(act):
    jp, jcfg, tp, tcfg = fff_pair(21, act=act, trees=2, master=True)
    jx, tx = both(rng(21).normal(size=(7, 16)))
    y, idx = fd_ops.fused_decode(tx, tp, tcfg, return_leaf_idx=True)
    jy, jidx = jax.jit(lambda x, p: jfd_ops.fused_decode_ref(
        x, p, jcfg, return_leaf_idx=True))(jx, jp)
    same(idx, jidx)
    close(y, jy)


def test_fused_decode_all_one_leaf():
    jp, jcfg, tp, tcfg = fff_pair(22, act="swiglu")
    for k in ("node_w1",):
        jp[k] = jnp.zeros_like(jp[k])
        tp[k] = torch.zeros_like(tp[k])
    jp["node_b2"] = jnp.ones_like(jp["node_b2"])      # every logit is +1
    tp["node_b2"] = torch.ones_like(tp["node_b2"])
    jx, tx = both(rng(22).normal(size=(37, 16)))
    y, idx = fd_ops.fused_decode(tx, tp, tcfg, return_leaf_idx=True)
    jy, jidx = jax.jit(lambda x, p: jfd_ops.fused_decode_ref(
        x, p, jcfg, return_leaf_idx=True))(jx, jp)
    same(idx, jidx)
    assert bool((idx == tcfg.num_leaves - 1).all())
    close(y, jy)


def test_collapse_nodes_matches_jax():
    jp, jcfg, tp, tcfg = fff_pair(23, trees=2)
    for got, want in zip(fd_ops.collapse_nodes(tp, tcfg),
                         jfd_ops.collapse_nodes(jp, jcfg)):
        close(got, want)


def test_fused_decode_wrapper_validates_operands():
    _, _, tp, tcfg = fff_pair(24, act="swiglu")
    nw, nb = fd_ops.collapse_nodes(tp, tcfg)
    with pytest.raises(ValueError):                    # node_width > 1
        fd_ops.fused_decode(torch.zeros(2, 16), tp,
                            fff.FFFConfig(16, 16, 3, 8, node_width=2))
    leaves = (tp["leaf_wg"], tp["leaf_wu"], tp["leaf_wd"])
    y, _ = fdk.fused_forest_decode(torch.zeros(2, 16), nw, nb, leaves,
                                   depth=3, act="swiglu")
    assert y.shape == (2, 16)


# ---------------------------------------------------------------------------
# the FFF layer through api.apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("act,trees", [("swiglu", 1), ("gelu", 2)])
@pytest.mark.parametrize("backend", ["auto", "reference", "cuda", "cuda_decode"])
def test_apply_matches_jax_reference(backend, act, trees, master):
    jp, jcfg, tp, tcfg = fff_pair(30 + trees, act=act, trees=trees,
                                  master=master)
    jx, tx = both(rng(30).normal(size=(3, 5, 16)))
    y, out = api.apply(tp, tcfg, tx, api.ExecutionSpec(backend=backend))
    jy, jout = jax.jit(lambda p, x: japi.apply(p, jcfg, x, japi.ExecutionSpec(
        mode="infer", backend="reference")))(jp, jx)
    assert y.shape == (3, 5, 16) and out.leaf_idx.shape == (3, 5, trees)
    same(out.leaf_idx, jout.leaf_idx)
    close(y, jy, kind="e2e")


def test_auto_resolution_on_the_cpu_and_card():
    _, _, tp, tcfg = fff_pair(31)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert api.resolve_backend(tp, tcfg, "infer", (4, 1, 16), cpu) == "reference"
    assert api.resolve_backend(tp, tcfg, "infer", (4, 1, 16), cuda) == "cuda_decode"
    assert api.resolve_backend(tp, tcfg, "infer", (4, 9, 16), cuda) == "cuda"
    with api.overrides(backend="reference", mode="infer"):
        assert api.resolve_backend(tp, tcfg, "infer", (4, 1, 16), cuda) == "reference"
    biased = dict(tp, leaf_b1=torch.zeros(1))          # kernel-ineligible
    assert api.resolve_backend(biased, tcfg, "infer", (4, 9, 16), cuda) == "reference"
    with pytest.raises(KeyError):
        api.overrides(backend="pallas")


def test_cuda_decode_sentinel_masks_invalid_rows():
    jp, jcfg, tp, tcfg = fff_pair(32, act="swiglu")
    jx, tx = both(rng(32).normal(size=(6, 1, 16)))
    valid = np.array([True, False, True, True, False, True])
    y, out = api.apply(tp, tcfg, tx, api.ExecutionSpec(
        backend="cuda_decode", valid=torch.from_numpy(valid)[:, None]))
    jy, jout = jax.jit(lambda p, x: japi.apply(p, jcfg, x, japi.ExecutionSpec(
        mode="infer", backend="reference")))(jp, jx)
    want = np.where(valid[:, None, None], np.asarray(jout.leaf_idx),
                    tcfg.num_leaves)
    same(out.leaf_idx, want)
    close(y, jy, kind="e2e")                      # outputs stay exact
    stats = api.routing_stats_from(out, tcfg)
    assert float(stats.slots) == valid.sum()      # sentinel rows drop out


# ---------------------------------------------------------------------------
# the wrappers' CUDA branches, up to the launch
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_launch(monkeypatch):
    """Drive a wrapper's CUDA branch with CPU tensors: the device-type check
    and the launch are stubbed, every other operand check runs, and each
    launch's arguments are held against the kernel's ctypes signature
    (which tests/test_torch_isolation.py holds against the C source)."""
    launched = []
    check = common.check

    def check_but_device(t, name, **kw):
        try:
            check(t, name, **kw)
        except ValueError as e:
            if "expected a CUDA tensor" not in str(e):
                raise

    def launch(self, *args):
        assert len(args) == len(self.argtypes), self.name
        for a, t in zip(args, self.argtypes):
            if t is common.P:
                assert a is None or isinstance(a, int), (self.name, a)
            else:
                assert type(a) is int, (self.name, a)
        launched.append(self.name)

    monkeypatch.setattr(common, "check", check_but_device)
    monkeypatch.setattr(common, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(common.Kernel, "launch", launch)
    return launched


def test_cuda_branches_marshal_their_c_signatures(stub_launch):
    from repro_torch.kernels.tree_router import kernel as trk
    out = trk._launch(torch.zeros(5, 16), torch.zeros(7, 16), torch.zeros(7), 3)
    assert out.shape == (5,) and out.dtype == torch.int32
    x, w = torch.zeros(3, 16, 8), torch.zeros(3, 8, 4)
    gs = torch.zeros(3, dtype=torch.int32)
    assert gk._launch(gk.GMM, x, (w,), gs, (0,)).shape == (3, 16, 4)
    assert gk._launch(gk.GMM_DUAL, x, (w, w), gs, ()).shape == (3, 16, 4)
    for act, master in (("gelu", False), ("swiglu", True)):
        _, _, tp, tcfg = fff_pair(40, act=act, trees=2, master=master)
        nw, nb = fd_ops.collapse_nodes(tp, tcfg)
        leaf_w, _ = fd_ops._leaf_weights(tp, tcfg)
        y, idx = fdk._launch(torch.zeros(6, 16), nw, nb, leaf_w, 3, act,
                             fd_ops._master_weights(tp, tcfg))
        assert y.shape == (6, 16) and idx.shape == (6, 2)
    assert stub_launch == ["tree_router", "grouped_matmul", "grouped_matmul_dual",
                           "fused_forest_decode", "fused_forest_decode"]
    with pytest.raises(ValueError, match="expected shape"):
        gk._launch(gk.GMM, x, (torch.zeros(3, 9, 4),), gs, (0,))


@pytest.mark.parametrize("master", [False, True])
def test_fused_decode_marshals_its_slots_and_counter(stub_launch, monkeypatch,
                                                     master):
    """The fused decode wrapper's CUDA branch hands the kernel one float32
    partial-output slot per block of a token, S x B x O with S = trees x
    ceil(l / 32) + ceil(mw / 32) (mw = 0 without a master leaf), which the
    kernel sums in slot order and which needs no fill, and a zeroed int32
    arrival counter of B."""
    made = {}
    for name in ("empty", "zeros"):
        def record(*a, _fn=getattr(torch, name), **kw):
            t = _fn(*a, **kw)
            made[t.data_ptr()] = t
            return t
        monkeypatch.setattr(torch, name, record)
    args = []
    monkeypatch.setattr(common.Kernel, "launch", lambda self, *a: args.append(a))
    trees, leaf, B = 2, 40, 6
    _, _, tp, tcfg = fff_pair(41, act="swiglu", trees=trees, leaf=leaf,
                              master=master)
    nw, nb = fd_ops.collapse_nodes(tp, tcfg)
    leaf_w, _ = fd_ops._leaf_weights(tp, tcfg)
    master_w = fd_ops._master_weights(tp, tcfg)
    mw = master_w[0].shape[1] if master else 0
    fdk._launch(torch.zeros(B, 16), nw, nb, leaf_w, 3, "swiglu", master_w)
    (call,) = args
    part, counter = made[call[10]], made[call[11]]
    slots = trees * -(-leaf // 32) + -(-mw // 32)
    assert slots == (6 if master else 4)
    assert part.dtype == torch.float32 and part.shape == (slots, B, 16)
    assert counter.dtype == torch.int32 and counter.shape == (B,)
    assert not counter.any()
    assert call[-5] == mw
