"""The grouped FFF paths at static shapes, on the CPU.

The card captures a prefill slab as a CUDA graph only if nothing in it reads
a value on the host.  A ``TorchDispatchMode`` records every op a call runs
with its output shapes: ``leaf_gemm.ops.fff_infer`` (the ``cuda`` backend's
grouped branch, whose wrappers run their plain versions here) and
``routing.grouped_leaf_apply_ep`` (``exact_dense``, no process group) must
run the same op-and-shape sequence under balanced routing and with every
token on one leaf, and none of the ops that make the host wait for the card
(``aten._local_scalar_dense`` behind ``.item()``/``.tolist()``,
``nonzero``, ``masked_select``, ``unique``, ``bincount``, a boolean index).
Their outputs match the JAX package's at 0%, ~50% and ~87% of the tokens
past capacity (the ``kernel`` tolerance of ``tests/conftest.py``), and a
valid row's output is bit-identical whatever the phantom rows hold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import assert_close
from repro.core import routing as jrouting
from repro.kernels.leaf_gemm import ops as jg_ops
from repro_torch.configs import registry
from repro_torch.core import api, fff, routing
from repro_torch.kernels.leaf_gemm import ops as g_ops
from repro_torch.models import lm

torch.set_num_threads(2)

#: ops whose result size or value the host must read off the device
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "bincount",
              "_unique", "_unique2", "unique_dim", "unique_consecutive",
              "repeat_interleave.Tensor"}
INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}


class OpRecorder(TorchDispatchMode):
    """Records (op, output shapes) of every op run inside it, and the ops
    that read a value on the host."""

    def __init__(self):
        super().__init__()
        self.ops, self.host_reads = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        full = f"{name}.{func._overloadname}"
        if name in HOST_READS or full in HOST_READS or (
                name in INDEXING and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in args[1] if i is not None)):
            self.host_reads.append(full)
        shapes = tuple(tuple(o.shape) for o in
                       (out if isinstance(out, (tuple, list)) else (out,))
                       if isinstance(o, torch.Tensor))
        self.ops.append((full, shapes))
        return out


def recorded(fn):
    rec = OpRecorder()
    with torch.inference_mode(), rec:
        out = fn()
    return out, rec


# ---------------------------------------------------------------------------
# one op-and-shape sequence, whatever the routing
# ---------------------------------------------------------------------------

B, E, D, LEAF = 1024, 16, 16, 8


@pytest.fixture(scope="module")
def forest():
    cfg = fff.FFFConfig(dim_in=D, dim_out=D, depth=4, leaf_width=LEAF,
                        activation="swiglu", leaf_bias=False)
    p = fff.init(torch.Generator().manual_seed(3), cfg)
    # zero node nets: every logit is 0, and ties go right, so every token
    # descends to the last leaf
    one_leaf = dict(p, node_w2=torch.zeros_like(p["node_w2"]),
                    node_b2=torch.zeros_like(p["node_b2"]))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(B, D)).astype(np.float32))
    return cfg, {"balanced": p, "one leaf": one_leaf}, x


def test_fff_infer_one_sequence_no_host_read(forest):
    cfg, params, x = forest
    runs = {}
    for name, p in params.items():
        (y, idx), rec = recorded(lambda: g_ops.fff_infer(
            x, p, cfg, capacity_factor=2.0, return_leaf_idx=True))
        runs[name] = (y, idx, rec)
    (y, idx, rec), (y1, idx1, rec1) = runs["balanced"], runs["one leaf"]
    assert bool((idx1 == E - 1).all()) and len(set(idx[:, 0].tolist())) > E // 2
    assert rec.host_reads == [] and rec1.host_reads == []
    assert rec.ops == rec1.ops
    # the overflow pass ran in both: the 896 rows past capacity 128, a leaf
    rows = g_ops.overflow_rows(B, 128)
    assert rows == 896 and any((E, rows, LEAF) in s for _, s in rec.ops)
    want = fff._forward_hard_gather(params["one leaf"], cfg, x)[0]
    assert_close(y1.numpy(), want.numpy())


@pytest.mark.parametrize("policy", ["exact_dense", "drop"])
def test_grouped_ep_one_sequence_no_host_read(forest, policy):
    cfg, params, x = forest
    leaves = {k: v[0] for k, v in params["balanced"].items() if k.startswith("leaf_")}
    r = np.random.default_rng(4)
    routings = {"balanced": torch.from_numpy(r.integers(0, E, B).astype(np.int32)),
                "one leaf": torch.full((B,), 5, dtype=torch.int32)}
    runs = {}
    for name, idx in routings.items():
        (y, kept), rec = recorded(lambda: routing.grouped_leaf_apply_ep(
            x, idx, leaves, "swiglu", capacity_factor=1.25,
            return_kept=True, overflow_policy=policy))
        runs[name] = (y, kept, rec)
    (_, _, rec), (y1, kept1, rec1) = runs["balanced"], runs["one leaf"]
    assert rec.host_reads == [] and rec1.host_reads == []
    assert rec.ops == rec1.ops
    assert int(kept1.sum()) == routing._capacity(B, E, 1.25)
    if policy == "exact_dense":
        want = fff.leaf_apply_grouped(leaves, x, routings["one leaf"], "swiglu",
                                      torch.float32)
        assert_close(y1.numpy(), want.numpy())


@pytest.mark.parametrize("backend", ["cuda", "grouped"])
def test_prefill_slab_reads_nothing_on_the_host(monkeypatch, backend):
    """A whole prefill slab (attention, the FFF sites on the kernel branch
    or the grouped backend with its repair, the head, routing telemetry)
    runs no op that reads a value on the host."""
    monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    cfg = registry.get_config("internlm2-20b").reduced(n_layers=2)
    p = lm.init(cfg, seed=0, device="cpu")
    caches = lm.init_caches(cfg, 4, 64, device="cpu", page_size=4)
    # 256 tokens: past the kernel branch's capacity of 128, so its overflow
    # pass runs too
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    valid = torch.tensor([64, 0, 7, 0], dtype=torch.int32)
    kw = (dict(backend=backend, mode="infer", overflow_policy="exact_dense",
               capacity_factor=0.5) if backend == "grouped" else {})
    with api.overrides(**kw), api.collect_routing():
        (logits, _, stats), rec = recorded(
            lambda: lm.prefill_chunk(p, cfg, tok, valid, caches))
    assert rec.host_reads == []
    assert logits.shape == (4, cfg.vocab_size) and stats is not None


# ---------------------------------------------------------------------------
# against the JAX package at 0-87% overflow
# ---------------------------------------------------------------------------

SB, SE, SD, SH = 64, 4, 16, 8
#: (capacity factor, tokens on leaf 0; the rest spread over leaves 1-3):
#: capacity 16 holds every token, then half the slab past it; capacity 8
#: with every token on leaf 0 leaves 56 of 64 past it
OVERFLOW = {"0%": (1.0, 16), "50%": (1.0, 48), "87%": (0.5, 64)}


def leaf_params(act, seed=6):
    r = np.random.default_rng(seed)
    names = (("leaf_wg", SD, SH), ("leaf_wu", SD, SH), ("leaf_wd", SH, SD)) \
        if act == "swiglu" else (("leaf_w1", SD, SH), ("leaf_w2", SH, SD))
    arrays = {n: (r.normal(size=(SE, a, b)) / np.sqrt(a)).astype(np.float32)
              for n, a, b in names}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def skewed(n0, seed=7):
    r = np.random.default_rng(seed)
    idx = np.concatenate([np.zeros(n0, np.int32),
                          1 + np.arange(SB - n0, dtype=np.int32) % (SE - 1)])
    x = r.normal(size=(SB, SD)).astype(np.float32)
    return x, r.permutation(idx).astype(np.int32)


@pytest.mark.parametrize("level", list(OVERFLOW))
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_fff_leaf_mlp_matches_jax(act, level):
    cf, n0 = OVERFLOW[level]
    x, idx = skewed(n0)
    jp, tp = leaf_params(act)
    got = g_ops.fff_leaf_mlp(torch.from_numpy(x), torch.from_numpy(idx), tp,
                             activation=act, capacity_factor=cf, block_c=8)
    want = jg_ops.fff_leaf_mlp(jnp.asarray(x), jnp.asarray(idx), jp,
                               activation=act, capacity_factor=cf,
                               interpret=True, block_c=8, block_h=8, block_k=16)
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("level", list(OVERFLOW))
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_grouped_leaf_apply_ep_matches_jax(act, level):
    cf, n0 = OVERFLOW[level]
    x, idx = skewed(n0)
    jp, tp = leaf_params(act)
    got, kept = routing.grouped_leaf_apply_ep(
        torch.from_numpy(x), torch.from_numpy(idx), tp, act,
        capacity_factor=cf, return_kept=True)
    want, jkept = jrouting.grouped_leaf_apply_ep(
        jnp.asarray(x), jnp.asarray(idx), jp, act, capacity_factor=cf,
        return_kept=True)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    assert_close(got.numpy(), np.asarray(want))
    assert int((~kept).sum()) == {"0%": 0, "50%": 32, "87%": 56}[level]


@pytest.mark.parametrize("level", list(OVERFLOW))
def test_valid_rows_ignore_phantom_rows(level):
    """Phantom rows (valid False) take only the capacity the valid rows
    leave and share the overflow pass with them: new phantom contents and
    leaves leave every valid row's output bit-identical."""
    cf, n0 = OVERFLOW[level]
    x, idx = skewed(n0)
    _, tp = leaf_params("swiglu")
    r = np.random.default_rng(8)
    valid = torch.from_numpy(r.random(SB) < 0.6)
    run = lambda xs, ids: g_ops.fff_leaf_mlp(
        torch.from_numpy(xs), torch.from_numpy(ids), tp, activation="swiglu",
        capacity_factor=cf, block_c=8, valid=valid)
    y = run(x, idx)
    ph = ~valid.numpy()
    x2, idx2 = x.copy(), idx.copy()
    x2[ph] = r.normal(size=(int(ph.sum()), SD))
    idx2[ph] = 0                                       # all on the busiest leaf
    assert torch.equal(run(x2, idx2)[valid], y[valid])
    want = fff.leaf_apply_grouped(tp, torch.from_numpy(x), torch.from_numpy(idx),
                                  "swiglu", torch.float32)
    assert_close(y.numpy(), want.numpy())
