"""The port's gathered leaf matmuls and the small-slab kernel path against
the JAX package, on the CPU.

The CUDA kernels ``gathered_matmul`` and ``gathered_matmul_dual``
(``csrc/fused_fff.cu``) run only on the card, in ``chip_smoke.py``; here
their wrappers run the plain versions (``fused_fff/ref.py``) and meet the
Pallas kernels in interpret mode and the JAX oracle on the same numpy
inputs, with the ``conftest.dtype_tol`` tolerances.  ``fff_decode`` (router
plus gathered MLP) is held against JAX's with exact leaf indices, the
``cuda`` backend's branch at ``PALLAS_DECODE_MAX_TOKENS`` is shown with
CPU tensors, and the wrappers' CUDA branches are marshalled up to the
launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.core import api as japi
from repro.core import fff as jfff
from repro.kernels.fused_fff import kernel as jfk
from repro.kernels.fused_fff import ops as jf_ops
from repro.kernels.fused_fff import ref as jfr
from repro_torch import weights
from repro_torch.core import api, fff
from repro_torch.kernels import common
from repro_torch.kernels.fused_fff import kernel as fk
from repro_torch.kernels.fused_fff import ops as f_ops
from repro_torch.kernels.fused_fff import ref as fr
from repro_torch.kernels.leaf_gemm import ops as g_ops

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ACTS = ["none", "relu", "gelu", "silu"]
# (batch, depth, leaf width): every batch meets a depth and a leaf width
SHAPES = [(1, 1, 4), (7, 2, 8), (32, 4, 8)]


def rng(seed):
    return np.random.default_rng(seed)


def both(a, dtype="float32"):
    ja = jnp.asarray(a, JDT[dtype])
    return ja, weights.tensor(np.asarray(ja), device="cpu")


def close(got, want, dtype="float32", kind="kernel"):
    rtol, atol = dtype_tol(JDT[dtype], kind)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=rtol, atol=atol)


def _inputs(seed, B, depth, H, dtype, D=24, skew=False):
    r = rng(seed)
    E = 2 ** depth
    x = both(r.normal(size=(B, D)), dtype)
    ws = [both(r.normal(size=(E, D, H)) / np.sqrt(D), dtype) for _ in range(2)]
    idx = (np.full((B,), E - 1) if skew else r.integers(0, E, (B,))
           ).astype(np.int32)
    return x, ws, (jnp.asarray(idx), torch.from_numpy(idx))


@pytest.mark.parametrize("B,depth,H", SHAPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gathered_matmul_matches_jax(dtype, act, B, depth, H):
    (jx, tx), ((jw, tw), _), (ji, ti) = _inputs(B * 10 + depth, B, depth, H,
                                                dtype)
    got = fk.gathered_matmul(tx, tw, ti, act=act)
    assert got.dtype == tx.dtype and got.shape == (B, H)
    close(got, jax.jit(lambda x, w, i: jfk.gathered_matmul(
        x, w, i, act=act, block_h=4, block_k=8, interpret=True))(jx, jw, ji),
        dtype)
    close(got, jfr.gathered_matmul_ref(jx, jw, ji, act=act), dtype)


@pytest.mark.parametrize("B,depth,H", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gathered_matmul_dual_matches_jax(dtype, B, depth, H):
    (jx, tx), ((jg, tg), (ju, tu)), (ji, ti) = _inputs(B + depth, B, depth, H,
                                                       dtype)
    got = fk.gathered_matmul_dual(tx, tg, tu, ti)
    close(got, jax.jit(lambda x, g, u, i: jfk.gathered_matmul_dual(
        x, g, u, i, block_h=4, block_k=8, interpret=True))(jx, jg, ju, ji),
        dtype)
    close(got, jfr.gathered_matmul_dual_ref(jx, jg, ju, ji), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gathered_all_one_leaf(dtype):
    """Every token on the last leaf: one slab, read by all of them."""
    (jx, tx), ((jg, tg), (ju, tu)), (ji, ti) = _inputs(5, 32, 4, 8, dtype,
                                                       skew=True)
    close(fk.gathered_matmul_dual(tx, tg, tu, ti),
          jfr.gathered_matmul_dual_ref(jx, jg, ju, ji), dtype)
    close(fk.gathered_matmul(tx, tg, ti, act="relu"),
          jfr.gathered_matmul_ref(jx, jg, ji, act="relu"), dtype)


# one leaf holding n of a 64-token slab's tokens, around the CUDA kernel's
# per-pass cap of 32 tokens a leaf (csrc/fused_fff.cu kMaxTok), the other
# tokens spread over the other leaves; and a 33-token slab, one past the
# 32-token verify slab
EDGES = [(64, n) for n in (0, 1, 31, 32, 33, 64)] + [(33, None)]


def _edge_inputs(seed, B, n, dtype, E=4, leaf=2, D=24, H=8):
    r = rng(seed)
    x = both(r.normal(size=(B, D)), dtype)
    ws = [both(r.normal(size=(E, D, H)) / np.sqrt(D), dtype) for _ in range(2)]
    idx = r.integers(0, E, B)
    if n is not None:
        idx = r.integers(0, E - 1, B)
        idx[idx >= leaf] += 1
        idx[r.permutation(B)[:n]] = leaf
        assert (idx == leaf).sum() == n
    idx = idx.astype(np.int32)
    return x, ws, (jnp.asarray(idx), torch.from_numpy(idx))


@pytest.mark.parametrize("B,n", EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gathered_per_leaf_token_counts_match_jax(dtype, B, n):
    """Both plain versions, which chip_smoke.py holds the CUDA kernels
    against at these counts, agree with the Pallas kernels (interpret mode)
    and the JAX oracles."""
    (jx, tx), ((jg, tg), (ju, tu)), (ji, ti) = _edge_inputs(B + (n or 0), B, n,
                                                           dtype)
    got = fk.gathered_matmul_dual(tx, tg, tu, ti)
    close(got, jax.jit(lambda x, g, u, i: jfk.gathered_matmul_dual(
        x, g, u, i, block_h=8, block_k=24, interpret=True))(jx, jg, ju, ji),
        dtype)
    close(got, jfr.gathered_matmul_dual_ref(jx, jg, ju, ji), dtype)
    got = fk.gathered_matmul(tx, tg, ti, act="gelu")
    close(got, jax.jit(lambda x, w, i: jfk.gathered_matmul(
        x, w, i, act="gelu", block_h=8, block_k=24, interpret=True))(jx, jg, ji),
        dtype)
    close(got, jfr.gathered_matmul_ref(jx, jg, ji, act="gelu"), dtype)


def test_gathered_index_guard():
    """An index outside [0, E) yields a zero row and never reads past w,
    in the plain version as in the kernel's guard."""
    (_, tx), ((_, tg), (_, tu)), (_, ti) = _inputs(6, 7, 2, 8, "float32")
    bad = ti.clone()
    bad[0], bad[3] = 4, -1
    want = fk.gathered_matmul_dual(tx, tg, tu, ti)
    got = fk.gathered_matmul_dual(tx, tg, tu, bad)
    assert float(got[[0, 3]].abs().max()) == 0.0
    keep = [1, 2, 4, 5, 6]
    torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=0)
    assert float(fk.gathered_matmul(tx, tg, bad)[0].abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown act"):
        fk.gathered_matmul(tx, tg, ti, act="tanh")


def fff_pair(seed, *, depth=3, act="swiglu", trees=1, dim=16, leaf=8,
             dtype="float32"):
    """One bias-free FFF layer's parameters in both packages."""
    kw = dict(dim_in=dim, dim_out=dim, depth=depth, leaf_width=leaf,
              activation=act, trees=trees, leaf_bias=False)
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


@pytest.mark.parametrize("act,trees", [("swiglu", 1), ("swiglu", 2),
                                       ("gelu", 1), ("relu", 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fff_decode_matches_jax(dtype, act, trees):
    jp, jcfg, tp, tcfg = fff_pair(40 + trees, act=act, trees=trees,
                                  dtype=dtype)
    jx, tx = both(rng(41).normal(size=(32, 16)), dtype)
    y, idx = f_ops.fff_decode(tx, tp, tcfg, return_leaf_idx=True)
    jy, jidx = jf_ops.fff_decode(jx, jp, jcfg, interpret=True,
                                 return_leaf_idx=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert y.dtype == tx.dtype and idx.shape == (32, trees)
    close(y, jy, dtype, kind="e2e")


def test_gathered_leaf_mlp_rounds_hidden_to_x_dtype():
    """bf16 tokens against float32 weights: the products run in float32
    and the hidden activation rounds to bf16 between them, as the JAX path
    stores it."""
    _, _, tp, tcfg = fff_pair(42)
    x = torch.from_numpy(rng(42).normal(size=(5, 16)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    idx = torch.tensor([0, 3, 7, 7, 1], dtype=torch.int32)
    leaves = {k: v[0] for k, v in tp.items() if k.startswith("leaf_")}
    got = f_ops.gathered_leaf_mlp(xb, idx, leaves)
    h = fr.gathered_matmul_dual_ref(xb.float(), leaves["leaf_wg"],
                                    leaves["leaf_wu"], idx)
    want = fr.gathered_matmul_ref(h.to(torch.bfloat16).float(),
                                  leaves["leaf_wd"], idx)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("tokens,branch", [(32, "gathered"), (33, "grouped")])
def test_cuda_backend_branches_at_32_tokens(monkeypatch, tokens, branch):
    """The cuda backend sends slabs of at most 32 flattened tokens through
    the gathered kernels and larger ones through the grouped GEMMs; both
    agree with the reference backend."""
    jp, jcfg, tp, tcfg = fff_pair(43, trees=2)
    ran = []
    for mod, name, tag in ((f_ops, "fff_decode", "gathered"),
                           (g_ops, "fff_infer", "grouped")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _t=tag, **kw:
                            (ran.append(_t), _fn(*a, **kw))[1])
    # (tokens // 4 rows, 4 positions) or (1, 33): the flattened count decides
    lead = (tokens // 4, 4) if tokens % 4 == 0 else (1, tokens)
    jx, tx = both(rng(43).normal(size=lead + (16,)))
    valid = torch.ones(lead, dtype=torch.bool)
    valid[0, 0] = False
    y, out = api.apply(tp, tcfg, tx, api.ExecutionSpec(backend="cuda",
                                                       valid=valid))
    assert ran == [branch]
    jy, jout = jax.jit(lambda p, x: japi.apply(p, jcfg, x, japi.ExecutionSpec(
        mode="infer", backend="reference")))(jp, jx)
    close(y, jy, kind="e2e")
    want = np.asarray(jout.leaf_idx).copy()
    want[0, 0] = tcfg.num_leaves                   # phantom row: the sentinel
    np.testing.assert_array_equal(out.leaf_idx.numpy(), want)


def test_gathered_branches_marshal_their_c_signatures(monkeypatch):
    """The wrappers' CUDA branches with CPU tensors: every operand check
    runs, the launch is held against the kernel's ctypes signature (which
    tests/test_torch_isolation.py holds against the C source)."""
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
        assert all(type(a) is int for a in args), (self.name, args)
        launched.append((self.name, args[-6:-3]))

    monkeypatch.setattr(common, "check", check_but_device)
    monkeypatch.setattr(common, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(common.Kernel, "launch", launch)
    x, w = torch.zeros(7, 20), torch.zeros(4, 20, 12)
    idx = torch.zeros(7, dtype=torch.int32)
    assert fk._launch(fk.GATHERED, x, (w,), idx, (2,)).shape == (7, 12)
    assert fk._launch(fk.GATHERED_DUAL, x, (w, w), idx, ()).shape == (7, 12)
    assert [n for n, _ in launched] == ["gathered_matmul",
                                        "gathered_matmul_dual"]
    assert launched[0][1] == (12, 4, 2) and launched[1][1] == (20, 12, 4)
    with pytest.raises(ValueError, match="expected shape"):
        fk._launch(fk.GATHERED, x, (torch.zeros(4, 21, 12),), idx, (0,))
    with pytest.raises(TypeError, match="int32"):
        fk._launch(fk.GATHERED, x, (w,), idx.long(), (0,))
