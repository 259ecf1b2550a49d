"""The port's layouts, sharding rules and gradient compression against the
JAX package, with no processes.

JAX's ``spec_for_path`` and ``cache_specs`` read only a mesh's
``axis_names`` and ``shape``, so a stand-in with those two attributes and
``jax.eval_shape`` structs give JAX's specs with no fake devices.  The
port's parameter tree for the same config comes from ``weights.from_jax``
over zero-stride numpy arrays of the JAX shapes (no memory at any width),
so every parameter of every registry arch is compared at its published
widths: the port's spec must be JAX's less the leading ``n_periods`` axis
of the stacked entries.  The compression checks feed numpy-drawn gradients
to both packages' ``ef_compress``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.configs import registry as jregistry
from repro.distributed import compression as jcompression
from repro.distributed import sharding as jsharding
from repro.models import lm as jlm
from repro import optim as joptim
from repro_torch import optim, utils, weights
from repro_torch.configs import registry
from repro_torch.distributed import compression, sharding
from repro_torch.launch import mesh
from repro_torch.models import lm

torch.set_num_threads(2)

LAYOUTS = {"2x4": ((2, 4), ("data", "model")),
           "16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """What JAX's rules read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def jax_spec(spec, ndim):
    """A JAX PartitionSpec as the port's tuple, one entry per dimension."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


@functools.lru_cache(maxsize=None)
def structs(arch, ffn):
    cfg = jregistry.get_config(arch, ffn)
    return jax.eval_shape(functools.partial(jlm.init, cfg=cfg),
                          jax.random.PRNGKey(0))


def port_tree(arch, ffn, monkeypatch):
    """The port's parameter tree for the registry config, as zero-stride
    numpy arrays through ``weights.from_jax`` (its layer mapping, no data)."""
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        structs(arch, ffn))
    monkeypatch.setattr(weights, "tensor", lambda a, device=None: a)
    return weights.from_jax(zeros, registry.get_config(arch, ffn))


def at(tree, path: str):
    """The node of a nested dict/list tree at ``path``."""
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def jax_counterpart(path: str, n_pos: dict) -> tuple[str, bool]:
    """A port path -> (JAX path, whether JAX stacks it over periods)."""
    parts = path.split("/")
    if parts[0] in n_pos:
        parts[1] = str(int(parts[1]) % n_pos[parts[0]])
        return "/".join(parts), True
    return path, False


@pytest.mark.parametrize("ffn", ["fff", "native"])
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_param_specs_match_jax(arch, ffn, monkeypatch):
    """Every parameter of every registry arch at its published widths, at
    (2, 4), (16, 16) and (2, 16, 16), ZeRO-3 and ZeRO-1 layouts."""
    cfg = registry.get_config(arch, ffn)
    n_pos = {"stack": len(cfg.period)}
    if cfg.encoder is not None:
        n_pos["enc_stack"] = len(cfg.encoder.period)
    tree = port_tree(arch, ffn, monkeypatch)
    flat_s, _ = jax.tree_util.tree_flatten_with_path(structs(arch, ffn))
    jshapes = {jsharding.path_of(kp): s.shape for kp, s in flat_s}
    n = 0
    for shape, axes in LAYOUTS.values():
        stand_in, layout = StandIn(shape, axes), mesh.make_mesh(shape, axes)
        for fsdp in (True, False):
            specs = sharding.param_specs(tree, layout, fsdp)
            leaves = utils.tree_leaves_with_paths(tree)
            for path, _ in leaves:
                spec = at(specs, path)
                jpath, stacked = jax_counterpart(path, n_pos)
                js = jshapes[jpath]
                want = jax_spec(jsharding.spec_for_path(
                    jpath, len(js), stand_in, js, fsdp=fsdp), len(js))
                if stacked:
                    assert want[0] is None, (jpath, want)
                    want = want[1:]
                assert spec == want, (arch, path, shape, fsdp, spec, want)
                n += 1
    assert n == 6 * len(leaves)


def test_fallbacks_match_jax(monkeypatch):
    """olmoe's 8 leaves a tree on a 16-wide model axis fall back to the
    leaf width (column/row TP); a dimension that divides no axis stays
    replicated, as in JAX."""
    layout = mesh.make_mesh((16, 16), ("data", "model"))
    tree = port_tree("olmoe-1b-7b", "fff", monkeypatch)
    ffn = tree["stack"][0]["ffn"]
    assert ffn["leaf_wg"].shape[1] == 8
    spec = sharding.spec_for_path("stack/0/ffn/leaf_wg", 4, layout,
                                  ffn["leaf_wg"].shape)
    assert spec == (None, None, "data", "model")
    assert sharding.spec_for_path("stack/0/ffn/leaf_wd", 4, layout,
                                  ffn["leaf_wd"].shape) == (None, None, "model", "data")
    stand_in = StandIn((16, 16), ("data", "model"))
    for path, shape in [("x/ffn/w1", (7, 6)), ("x/mixer/wq", (24, 5, 3)),
                        ("x/embed/tok", (33, 48)), ("x/ffn/leaf_wg", (1, 3, 5, 7))]:
        for fsdp in (True, False):
            got = sharding.spec_for_path(path, len(shape), layout, shape, fsdp)
            want = jax_spec(jsharding.spec_for_path(path, len(shape), stand_in,
                                                    shape, fsdp), len(shape))
            assert got == want, (path, got, want)
    assert sharding.spec_for_path("x/ffn/w1", 2, layout, (7, 6)) == (None, None)


@pytest.mark.parametrize("arch", ["internlm2-20b", "olmoe-1b-7b"])
@pytest.mark.parametrize("page_size", [0, 4])
def test_cache_specs_match_jax(arch, page_size):
    """The paged pool (and the contiguous one), tables and lengths: the
    port's specs are JAX's less the n_periods axis, the pool laid out by
    its real pages (the sink page is the port's own)."""
    jcfg = jregistry.get_config(arch).reduced(n_layers=2)
    tcfg = registry.get_config(arch).reduced(n_layers=2)
    B, max_len = 8, 16
    num_pages = 32 if page_size else 0
    jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, B, max_len,
                                                page_size=page_size,
                                                num_pages=num_pages))
    tc = lm.init_caches(tcfg, B, max_len, page_size=page_size,
                        num_pages=num_pages, device="cpu")
    n_pos = len(tcfg.period)
    for shape, axes in [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
                        ((8, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]:
        stand_in, layout = StandIn(shape, axes), mesh.make_mesh(shape, axes)
        jspecs = jsharding.cache_specs(jc, stand_in, B)
        tspecs = sharding.cache_specs(tc, layout, B)
        for i, layer in enumerate(tspecs):
            kv_t, kv_j = layer["kv"], jspecs[i % n_pos]["kv"]
            for field in ("k", "v", "table", "length"):
                want = getattr(kv_j, field)
                ndim = getattr(jc[i % n_pos]["kv"], field).ndim
                assert getattr(kv_t, field) == jax_spec(want, ndim)[1:], (
                    arch, shape, field)
    assert tspecs[0]["kv"].k[0] is not None or page_size == 0


def test_layout_arithmetic_and_refusals():
    """Ranks row-major, first axis outermost (jax.make_mesh's order); the
    production layouts refuse a world of another size; serving(3) on 4
    ranks raises JAX's message."""
    lay = mesh.make_mesh((2, 3, 4), ("pod", "data", "model"))
    devices = np.arange(24).reshape(2, 3, 4)
    for r in range(24):
        assert devices[lay.coords(r)] == r and lay.rank_of(lay.coords(r)) == r
    assert lay.axis_ranks("model", 5) == [4, 5, 6, 7]
    assert lay.axis_ranks("data", 5) == [1, 5, 9]
    assert lay.axis_ranks("pod", 5) == [5, 17]
    assert mesh.data_axes(lay) == ("pod", "data") and mesh.num_chips(lay) == 24
    assert mesh.data_index(lay, 17) == (4, 6)
    assert mesh.make_host_mesh(world=8).shape == {"data": 8}
    assert mesh.make_serving_mesh(2, world=8).shape == {"data": 4, "model": 2}
    assert mesh.make_production_mesh(world=256).shape == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True, world=512).sizes == (2, 16, 16)
    with pytest.raises(ValueError, match="needs 256 ranks, the world has 8"):
        mesh.make_production_mesh(world=8)
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh.make_production_mesh(multi_pod=True, world=256)
    with pytest.raises(ValueError, match="model_parallel=3 must divide 4 devices"):
        mesh.make_serving_mesh(3, world=4)
    with pytest.raises(ValueError, match="model_parallel=3 must divide 4 devices"):
        mesh.serving_context(3, world=4)
    assert mesh.serving_context(1) == (None, __import__("contextlib").nullcontext)
    assert mesh.init_ranks() == (0, 1)
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        mesh.make_mesh((1, 2), ("data", "model")).groups()


def test_train_cli_refuses_prod_on_one_process():
    from repro_torch.launch import train
    with pytest.raises(ValueError, match=r"production layout \(16, 16\) needs 256"):
        train.main(["--reduced", "--steps", "1", "--mesh", "prod", "--device", "cpu"])


def test_shard_params_slices_and_records():
    """Each rank's slices tile the whole tensor; the placements hold the
    whole shapes and belong to their tree (an optimizer moment finds its
    parameter's by path suffix); a replicated tensor is returned as it is."""
    lay = mesh.make_mesh((2, 2), ("data", "model"))
    w = torch.arange(64.0).reshape(8, 8)
    norm = torch.ones(8)
    tree = {"ffn": {"w1": w}, "norm": {"scale": norm}}
    pls = sharding.Placements.of(tree, lay)
    parts = [sharding.shard_params(tree, lay, rank=r) for r in range(4)]
    assert pls.by_path["ffn/w1"] == sharding.Placement(("data", "model"), (8, 8))
    assert all(p["norm"]["scale"] is norm for p in parts)
    rows = [torch.cat([parts[d * 2 + m]["ffn"]["w1"] for m in range(2)], 1)
            for d in range(2)]
    assert torch.equal(torch.cat(rows, 0), w)
    assert parts[3]["ffn"]["w1"].is_contiguous()
    assert pls.is_slice("ffn/w1", parts[0]["ffn"]["w1"])
    assert not pls.is_slice("ffn/w1", w)
    lay3 = mesh.make_mesh((2, 2, 1), ("pod", "data", "model"))
    pls3 = sharding.Placements.of({"ffn": {"wd": w}}, lay3)
    p = pls3.shard({"ffn": {"wd": w}}, rank=3)                 # (pod, data) on dim 1
    assert pls3.by_path["ffn/wd"].spec == ("model", ("pod", "data"))
    assert torch.equal(p["ffn"]["wd"], w[:, 6:8])
    assert pls3.find("opt/mu/ffn/wd") is pls3.by_path["ffn/wd"]
    stand_in = pls3.whole_like({"params": p})["params"]["ffn"]["wd"]
    assert stand_in.shape == (8, 8) and stand_in.dtype == w.dtype
    assert pls3.spec_fn("params/ffn/wd", p["ffn"]["wd"]) == ("model", ("pod", "data"))
    assert pls3.spec_fn("other", w) == (None, None)


@pytest.mark.parametrize("arch,model", [
    ("internlm2-20b", 2), ("internlm2-20b", 4), ("olmoe-1b-7b", 2),
    ("olmoe-1b-7b", 16)], ids=["internlm2-M2", "internlm2-M4", "olmoe-M2",
                               "olmoe-M16-fallback"])
def test_shard_leaves_keeps_only_leaves_on_the_model_axis(arch, model):
    """The serving storage: each FFF site's leaf tensors hold E/M leaves,
    rank ``m``'s block of the leaf axis, where M divides E; olmoe's leaves
    on a 16-wide axis stay whole (the rules fall back to TP there, which
    serving does not store); every other tensor is the whole tensor
    itself."""
    cfg = registry.get_config(arch, ffn="fff").reduced(n_layers=1)
    params = lm.init(cfg, seed=0, device="cpu")
    E = params["stack"][0]["ffn"]["leaf_wg"].shape[1]
    held = E // model if E % model == 0 and E >= model else E
    assert (held == E) == (model == 16)
    lay = mesh.make_mesh((1, model), ("data", "model"))
    rank = model - 1
    local = sharding.shard_leaves(params, lay, rank=rank)
    whole = dict(utils.tree_leaves_with_paths(params))
    for path, t in utils.tree_leaves_with_paths(local):
        w = whole[path]
        if "/ffn/leaf_" in path:
            assert t.shape[1] == held, path
            if held < E:
                assert torch.equal(t, w[:, rank * held:(rank + 1) * held]), path
                assert t.is_contiguous()
            else:
                assert t is w, path
        else:
            assert t is w, path
    site = local["stack"][0]["ffn"]
    assert sharding.whole_leaves(site, held) is site
    if held < E:
        # a backend other than grouped_ep needs the whole leaves: a model
        # group to gather them over
        with pytest.raises(ValueError, match=f"hold \\[{held}\\] of {E} leaves"):
            sharding.whole_leaves(site, E)


def test_ef_compress_matches_jax():
    """Three steps of error-feedback int8 compression around SGD: the
    updates and the carried error within ``kernel`` fp32 of JAX's."""
    r = np.random.default_rng(3)
    shapes = {"a": (16, 8), "b": (5,), "c": (3, 4, 2)}
    params = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jopt = jcompression.ef_compress(joptim.sgd(0.1))
    topt = compression.ef_compress(optim.sgd(0.1))
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    tstate = topt.init({k: torch.from_numpy(v) for k, v in params.items()})
    rtol, atol = dtype_tol(jnp.float32, "kernel")
    for step in range(3):
        g = {k: (r.normal(size=s) * 10.0 ** (step - 1)).astype(np.float32)
             for k, s in shapes.items()}
        ju, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate)
        tu, tstate = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                 tstate)
        for k in shapes:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=rtol, atol=atol)
            np.testing.assert_allclose(tstate.error[k].numpy(),
                                       np.asarray(jstate.error[k]),
                                       rtol=rtol, atol=atol)
    q, scale = compression._quantize(torch.tensor([0.0, 1.0, -2.54]))
    jq, jscale = jcompression._quantize(jnp.asarray([0.0, 1.0, -2.54]))
    assert q.tolist() == np.asarray(jq).tolist() and q.dtype == torch.int8
    assert float(scale) == pytest.approx(float(jscale), rel=1e-7)
    assert compression.compression_ratio() == jcompression.compression_ratio() == 4.0


def test_collectives_of_one_rank_are_the_identity():
    """An axis of one rank has no group: every collective returns its input."""
    from repro_torch.distributed import collectives
    t = torch.arange(6.0)
    assert collectives.all_gather_cat(t, None) is t
    assert collectives.all_reduce(t, None) is t
    assert collectives.all_to_all_single(t, None) is t
    x = torch.randn(4, 3)
    assert torch.equal(compression.compressed_psum(x, None),
                       compression._dequantize(*compression._quantize(x)))


@pytest.mark.parametrize("zero_stage", [1, 3])
def test_training_a_layout_of_one_rank_is_one_process(zero_stage):
    """``train(layout=)`` over a world of one rank (every axis one rank)
    trains as one process does (the clip's norm sums in another order)."""
    from repro_torch.launch import train
    cfg = dataclasses.replace(
        registry.get_config("internlm2-20b").reduced(n_layers=1),
        zero_stage=zero_stage)
    params = lm.init(cfg, seed=0, device="cpu")
    one = train.train(cfg, steps=2, batch=2, seq=8, device="cpu",
                      params=params, log=lambda *a: None)
    lay = train.train(cfg, steps=2, batch=2, seq=8, device="cpu",
                      params=params, log=lambda *a: None,
                      layout=mesh.make_mesh((1, 1), ("data", "model")))
    rtol, atol = dtype_tol(jnp.float32, "kernel")
    np.testing.assert_allclose(lay.losses, one.losses, rtol=rtol, atol=atol)
    for (p, a), (_, b) in zip(utils.tree_leaves_with_paths(one.params),
                              utils.tree_leaves_with_paths(lay.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=rtol, atol=atol,
                                   err_msg=p)
