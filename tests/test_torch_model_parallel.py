"""Serving and training over gloo ranks against the JAX package and the
one-process port, on the CPU.

One spawn of 4 gloo ranks and one of 2 (``launch/mesh.spawn_ranks``, one
thread a rank, a bounded join) run every case of their world size; the
rank function lives in this module, which imports no JAX at top level, so
the spawned ranks load torch alone.  The model is the 2-layer
internlm2-20b FFF ``reduced`` config at d 64 (8 leaves of 16), float32,
with JAX weights carried over by ``weights.from_jax``:

* serving at layouts (1, 2), (2, 2) and (1, 4) (``serve
  --model-parallel``'s setup): each rank stores E/M leaves of every FFF
  site and ``grouped_ep`` runs exactly those; the fixed loop's greedy
  tokens equal JAX's ``lm.generate`` and the one-process port's, its
  prefill logits JAX's within ``e2e``; the engine's tokens equal the
  one-process engine's and JAX's greedy decode of each request; every
  rank returns the same; every other tensor is the whole tensor on each
  rank;
* at (1, 2), the engine speculating with a registry draft
  (``--draft-config starcoder2-15b``, whole on each rank; its FFF sites
  also run ``grouped_ep``) gives the one-process engine's tokens with the
  same draft;
* training at (2,), (2, 2) and (4,), ZeRO stages 1 and 3: the loss is
  JAX's ``lm.loss_fn`` within 1e-3, the step-0 gradients and the
  parameters after two AdamW steps the one-process port's within
  ``kernel``; the gradients would be off by 2x at (2, 2) if the gather's
  backward summed over the model axis;
* ``compressed_psum`` over 2 and 4 ranks equals JAX's under ``jax.vmap``
  (to float32 rounding) and is within 0.05 of the exact sum;
* a checkpoint saved from 4 ranks at (2, 2) restores onto 2 at (1, 2), and
  the supervisor restores and replays a failure every rank raises.
"""
import contextlib
import dataclasses
import io
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import utils
from repro_torch.checkpoint import CheckpointManager, reshard_restore
from repro_torch.configs import registry
from repro_torch.core import api, routing
from repro_torch.data import tokens as tokens_lib
from repro_torch.distributed import compression, sharding
from repro_torch.launch import mesh
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.nn import mlp
from repro_torch.serving.engine import EngineConfig

B, S, GEN = 4, 8, 6                      # the fixed loop
SLOTS, N_REQ, REQ_LEN, REQ_GEN = 4, 4, 8, 4    # the engine
TB, TSEQ, TSTEPS = 8, 16, 2               # training
SERVE = {4: ((2, 2), (1, 4)), 2: ((1, 2),)}
TRAIN = {4: ((2, 2), (4,)), 2: ((2,),)}
LIMIT_S = 150


def model_cfg(zero_stage: int = 1):
    cfg = registry.get_config("internlm2-20b", ffn="fff").reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, zero_stage=zero_stage)


def ecfg(**kw):
    return EngineConfig(num_slots=SLOTS, max_len=REQ_LEN + REQ_GEN + 1,
                        max_prompt_len=REQ_LEN, device="cpu", **kw)


#: the engine speculating with a registry draft
DRAFT = dict(spec_k=2, draft_config="starcoder2-15b")


def requests(cfg):
    return serve_mod.build_requests(cfg.vocab_size, N_REQ, REQ_LEN, REQ_GEN)


def loop_prompt(cfg) -> np.ndarray:
    """The fixed loop's prompt (``serve``'s draw)."""
    return tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=0).sample(
        B, S, seed=1)[:, :S]


def tokens_by_rid(run) -> dict:
    return {r.rid: list(r.tokens) for r in run.results}


def train_run(cfg, params, layout=None):
    """Two steps of ``train``: (losses, step-0 gradients and final
    parameters, whole)."""
    grads0 = {}
    pls = (None if layout is None else
           sharding.Placements.of(params, layout, fsdp=cfg.zero_stage >= 3))

    def inspect(i, grads, metrics):
        if i == 0:
            grads0.update(grads if pls is None else pls.gather(grads))

    r = train_mod.train(cfg, steps=TSTEPS, batch=TB, seq=TSEQ, device="cpu",
                        params=params, inspect=inspect, log=lambda *a: None,
                        layout=layout)
    final = r.params if layout is None else r.placements.gather(r.params)
    return r.losses, grads0, final


def _serve_case(cfg, params, M: int) -> dict:
    seen = []
    inner = routing._leaf_mlp_on_buffers

    def recording(xbuf, leaves, *a, **kw):
        seen.append(next(v.shape[0] for k, v in leaves.items()
                         if k.startswith("leaf_")))
        return inner(xbuf, leaves, *a, **kw)

    routing._leaf_mlp_on_buffers = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            layout, ctx, local = serve_mod.setup_model_parallel(
                cfg, M, params=params)
            with ctx(), torch.inference_mode():
                auto = api.resolve_backend(
                    local["stack"][0]["ffn"], mlp.make_fff_config(
                        cfg.period[0].ffn, cfg.d_model,
                        param_dtype=cfg.param_dtype,
                        accum_dtype=cfg.accum_dtype), "infer")
                logits, _ = lm.prefill(local, cfg, {"tokens": torch.from_numpy(
                    loop_prompt(cfg))}, lm.init_caches(cfg, B, S + GEN + 1,
                                                       device="cpu"))
                loop = serve_mod.serve(cfg, batch=B, prompt_len=S, gen=GEN,
                                       device="cpu", params=local)
                eng = serve_mod.serve_engine(cfg, ecfg(), requests(cfg),
                                             params=local)
                n_seen = len(seen)
                draft = (serve_mod.serve_engine(cfg, ecfg(**DRAFT), requests(cfg),
                                                params=local)
                         if M == 2 else None)
    finally:
        routing._leaf_mlp_on_buffers = inner
    held = [layer["ffn"]["leaf_wg"].shape[1] for layer in local["stack"]]
    nbytes = lambda stack: sum(t.numel() * t.element_size() for layer in stack
                               for k, t in layer["ffn"].items()
                               if k.startswith("leaf_"))
    whole = dict(utils.tree_leaves_with_paths(params))
    other_whole = all(t is whole[p] for p, t in utils.tree_leaves_with_paths(local)
                      if "/ffn/leaf_" not in p)
    return {"layout": tuple(layout.sizes), "held": held, "seen": seen[:n_seen],
            "draft_seen": seen[n_seen:],
            "other_whole": other_whole,
            "draft": None if draft is None else tokens_by_rid(draft),
            "auto": auto, "prefill": logits.numpy(),
            "loop": loop.tokens.numpy(), "engine": tokens_by_rid(eng),
            "leaf_bytes": nbytes(local["stack"]),
            "whole_leaf_bytes": nbytes(params["stack"])}


def _fail_once_at(step: int):
    failed = []

    def hook(i):
        if i == step and not failed:
            failed.append(i)
            return True
        return False
    return hook


def _rank_main(rank: int, world: int, d: str) -> dict:
    """One gloo rank: every case of ``world`` ranks."""
    torch.set_num_threads(1)
    params = torch.load(f"{d}/params.pt")
    cfg = model_cfg()
    out = {"serve": [_serve_case(cfg, params, M) for _, M in SERVE[world]]}
    out["train"] = {}
    for shape in TRAIN[world]:
        axes = ("data", "model")[:len(shape)]
        for z in (1, 3):
            out["train"][shape, z] = train_run(model_cfg(z), params,
                                               mesh.make_mesh(shape, axes))
    x = torch.from_numpy(np.load(f"{d}/psum.npy"))
    out["psum"] = compression.compressed_psum(x[rank], dist.group.WORLD).numpy()
    whole = {"ffn": {"w1": torch.arange(64.0).reshape(8, 8)}}
    if world == 4:
        lay = mesh.make_mesh((2, 2), ("data", "model"))
        pls = sharding.Placements.of(whole, lay)
        local = pls.shard(whole)
        CheckpointManager(f"{d}/ckpt", placements=pls).save(3, {"params": local})
        out["saved"] = local["ffn"]["w1"].numpy()
    else:
        lay = mesh.make_mesh((1, 2), ("data", "model"))

        def spec_fn(path, leaf):
            return sharding.spec_for_path(path, leaf.ndim, lay, tuple(leaf.shape))

        got, step, _ = reshard_restore(f"{d}/ckpt/step_3", {"params": whole},
                                       lay, spec_fn)
        pls = sharding.Placements.of(whole, lay)
        like = {"params": {"ffn": {"w1": torch.zeros_like(pls.shard(whole)["ffn"]["w1"])}}}
        got2, step2, _ = CheckpointManager(f"{d}/ckpt", placements=pls).restore(like)
        back = pls.gather(got2["params"])
        out["restored"] = (got["params"]["ffn"]["w1"].numpy(), step,
                           got2["params"]["ffn"]["w1"].numpy(), step2,
                           back["ffn"]["w1"].numpy())
        # a failure every rank raises at step 3: restore (ZeRO-3 slices of
        # the parameters and moments) and replay, against a run without it
        cfg3, lay = model_cfg(3), mesh.make_mesh((2,), ("data",))
        runs = []
        for name, hook in (("plain", None), ("failed", _fail_once_at(3))):
            r = train_mod.train(cfg3, steps=4, batch=TB, seq=TSEQ, device="cpu",
                                params=params, log=lambda *a: None, layout=lay,
                                ckpt_dir=f"{d}/sup_{name}", ckpt_every=2,
                                failure_hook=hook)
            runs.append((r.losses, r.restarts, r.end,
                         r.placements.gather(r.params)))
        out["supervised"] = runs
        # the command lines, run by every rank of the world
        cli = {}
        for name, fn, argv in [
                ("serve", serve_mod.main, ["--device", "cpu", "--model-parallel",
                                           "2", "--engine", "off", "--batch", "2",
                                           "--prompt-len", "8", "--gen", "2"]),
                ("train", train_mod.main, ["--arch", "internlm2-20b", "--reduced",
                                           "--steps", "2", "--batch", "4",
                                           "--seq", "8", "--device", "cpu"])]:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = fn(argv)
            cli[name] = buf.getvalue()
            if name == "train":
                cli["train_losses"] = res.losses
        out["cli"] = cli
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's references, the one-process port's, and each rank's results."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.distributed import compression as jcompression
    from repro.models import lm as jlm
    from repro_torch import weights

    d = tmp_path_factory.mktemp("mp")
    cfg = model_cfg()
    jcfg = dataclasses.replace(jregistry.get_config("internlm2-20b", ffn="fff").reduced(),
                               n_layers=2, d_model=64, n_heads=4, n_kv_heads=2)
    r = np.random.default_rng(5)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 8.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg)))
    params = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
    torch.save(params, d / "params.pt")
    x = r.normal(size=(4, 64)).astype(np.float32)
    np.save(d / "psum.npy", x)

    out = {"params": params, "x": x}
    prompt = loop_prompt(cfg)
    out["jax_loop"] = np.asarray(jax.jit(lambda p, t: jlm.generate(
        p, jcfg, t, GEN, S + GEN + 1))(jp, jnp.asarray(prompt)))[:, S:]
    out["jax_prefill"] = np.asarray(jax.jit(lambda p, t: jlm.prefill(
        p, jcfg, {"tokens": t}, jlm.init_caches(jcfg, B, S + GEN + 1)))(
            jp, jnp.asarray(prompt))[0])
    gen1 = jax.jit(lambda p, t: jlm.generate(p, jcfg, t, REQ_GEN,
                                             REQ_LEN + REQ_GEN + 1))
    out["jax_engine"] = {q.rid: np.asarray(gen1(jp, jnp.asarray(q.prompt[None])))
                         [0, len(q.prompt):].tolist() for q in requests(cfg)}
    b0 = train_mod.step_batch(cfg, tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=0),
                              TB, TSEQ, 0, 0)
    out["jax_loss"] = float(jax.jit(lambda p, b: jlm.loss_fn(p, jcfg, b)[0])(
        jp, {k: jnp.asarray(v) for k, v in b0.items()}))
    out["jax_psum"] = {w: np.asarray(jax.vmap(lambda a: jcompression.compressed_psum(
        a, "pod"), axis_name="pod")(jnp.asarray(x[:w]))) for w in (2, 4)}

    with contextlib.redirect_stdout(io.StringIO()), torch.inference_mode():
        out["one_loop"] = serve_mod.serve(cfg, batch=B, prompt_len=S, gen=GEN,
                                          device="cpu", params=params).tokens.numpy()
        out["one_engine"] = tokens_by_rid(serve_mod.serve_engine(
            cfg, ecfg(), requests(cfg), params=params))
        out["one_draft"] = tokens_by_rid(serve_mod.serve_engine(
            cfg, ecfg(**DRAFT), requests(cfg), params=params))
    out["one_train"] = train_run(cfg, params)
    for world in (4, 2):
        out[world] = mesh.spawn_ranks(_rank_main, world, (str(d),),
                                      timeout_s=LIMIT_S)
    return out


def close(got, want, kind="kernel"):
    from conftest import dtype_tol
    rtol, atol = dtype_tol(np.float32, kind)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("world,i", [(2, 0), (4, 0), (4, 1)],
                         ids=["1x2", "2x2", "1x4"])
def test_serving_over_ranks_matches_jax(runs, world, i):
    cfg = model_cfg()
    E = 2 ** cfg.period[0].ffn.fff_depth
    per_rank = [rk["serve"][i] for rk in runs[world]]
    G, M = per_rank[0]["layout"]
    assert G * M == world and (G, M) == SERVE[world][i]
    for rk in per_rank:
        # each rank stores E/M leaves of every site and runs only those
        assert rk["held"] == [E // M] * cfg.n_layers
        assert rk["seen"] and set(rk["seen"]) == {E // M}
        assert rk["leaf_bytes"] * M == rk["whole_leaf_bytes"]
        assert rk["other_whole"]
        assert rk["auto"] == "grouped_ep"
        np.testing.assert_array_equal(rk["loop"][:, :GEN], runs["jax_loop"])
        np.testing.assert_array_equal(rk["loop"], runs["one_loop"])
        close(rk["prefill"], runs["jax_prefill"], kind="e2e")
        assert rk["engine"] == runs["one_engine"]
        assert rk["engine"] == runs["jax_engine"]
    for rk in per_rank[1:]:
        np.testing.assert_array_equal(rk["prefill"], per_rank[0]["prefill"])


@pytest.mark.parametrize("zero_stage", [1, 3])
@pytest.mark.parametrize("world,shape", [(2, (2,)), (4, (2, 2)), (4, (4,))],
                         ids=["2", "2x2", "4"])
def test_training_over_ranks_matches_jax(runs, world, shape, zero_stage):
    losses1, grads1, params1 = runs["one_train"]
    for rk in runs[world]:
        losses, grads, params = rk["train"][shape, zero_stage]
        assert abs(losses[0] - runs["jax_loss"]) < 1e-3
        close(np.asarray(losses), np.asarray(losses1))
        for (p, g), (_, g1) in zip(utils.tree_leaves_with_paths(grads),
                                   utils.tree_leaves_with_paths(grads1)):
            close(g.numpy(), g1.numpy())
        for (p, w), (_, w1) in zip(utils.tree_leaves_with_paths(params),
                                   utils.tree_leaves_with_paths(params1)):
            close(w.numpy(), w1.numpy())


def test_registry_draft_over_two_ranks(runs):
    """``--draft-config starcoder2-15b`` under ``--model-parallel 2``: the
    draft is whole on each rank (only the target's leaves are sharded) and
    both ranks' speculative engine gives the one-process engine's tokens
    with the same draft, which in float32 are the greedy tokens."""
    for rk in runs[2]:
        assert rk["serve"][0]["draft"] == runs["one_draft"]
        assert rk["serve"][0]["draft_seen"]         # grouped_ep ran, both models
    assert runs["one_draft"] == runs["one_engine"]


def test_compressed_psum_over_ranks_matches_jax(runs):
    x = runs["x"]
    for world in (2, 4):
        exact = x[:world].sum(0)
        for rank, rk in enumerate(runs[world]):
            np.testing.assert_allclose(rk["psum"], runs["jax_psum"][world][rank],
                                       rtol=1e-6, atol=0)
            assert np.abs(rk["psum"] - exact).max() / np.abs(exact).max() < 0.05


def test_elastic_restore_from_four_ranks_onto_two(runs):
    whole = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    saved = [rk["saved"] for rk in runs[4]]
    assert all(s.shape == (4, 4) for s in saved)       # (2, 2): rows x columns
    for rank, rk in enumerate(runs[2]):
        got, step, got2, step2, back = rk["restored"]
        want = whole[:, rank * 4:(rank + 1) * 4]        # (1, 2): columns
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got2, want)
        np.testing.assert_array_equal(back, whole)
        assert step == step2 == 3


def test_supervisor_restart_under_ranks(runs):
    """A failure every rank raises at the same step: the supervisor
    restores the newest checkpoint (whole arrays, rank 0 wrote them) into
    each rank's ZeRO-3 slices and replays; the parameters at the end are
    the uninterrupted run's, bit for bit."""
    for rk in runs[2]:
        (l0, r0, e0, p0), (l1, r1, e1, p1) = rk["supervised"]
        assert (r0, r1, e0, e1) == (0, 1, 4, 4)
        assert l1[-1] == l0[-1]
        for (p, a), (_, b) in zip(utils.tree_leaves_with_paths(p0), utils.tree_leaves_with_paths(p1)):
            assert torch.equal(a, b), p


def test_command_lines_over_two_ranks(runs):
    """``serve --model-parallel 2`` and ``train --mesh host`` (the default)
    in a world of 2: rank 0 reports, rank 1 prints nothing; training is
    data-parallel over both and every rank's losses are the one-process
    run's (internlm2-20b's FFF trains by the soft mixture: no capacity, so
    no token's treatment depends on which rank holds it)."""
    r0, r1 = (rk["cli"] for rk in runs[2])
    assert "layout: {'data': 1, 'model': 2} (expert-parallel serving" in r0["serve"]
    assert "kernel launches:" in r0["serve"] and r1["serve"] == ""
    assert "layout: {'data': 2} (data-parallel over 2 ranks" in r0["train"]
    assert "done at step 2" in r0["train"] and r1["train"] == ""
    with contextlib.redirect_stdout(io.StringIO()):
        one = train_mod.main(["--arch", "internlm2-20b", "--reduced", "--steps",
                              "2", "--batch", "4", "--seq", "8", "--device", "cpu"])
    close(np.asarray(r0["train_losses"]), np.asarray(one.losses))
    assert r0["train_losses"] == r1["train_losses"]


def test_cluster_refuses_model_parallel():
    """JAX's refusal, with its message."""
    with pytest.raises(ValueError, match="--cluster and --model-parallel are "
                       "exclusive: cluster workers are single-process engines"):
        serve_mod.main(["--device", "cpu", "--cluster", "1", "1",
                        "--model-parallel", "2"])


def test_model_parallel_needs_a_world_it_divides():
    with pytest.raises(ValueError, match="model_parallel=2 must divide 1 devices"):
        serve_mod.main(["--device", "cpu", "--model-parallel", "2", "--engine", "off"])
    assert math.prod(SERVE[4][0]) == 4
