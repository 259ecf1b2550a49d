"""The paper's Table-3 ViT (``configs/paper_vit``) on the port against the
JAX package, on the CPU, in float32 at the ``e2e`` tolerance of
``tests/conftest.py`` (1e-3):

* ``vit_config``, ``CONFIG`` and ``FFF_CONFIG`` field for field;
* the ViT forward of ``examples/vit_cifar_fff_torch.py`` (the fixed patch
  projection, ``lm._embed_inputs`` over ``embeds``, the non-causal stack,
  the mean over tokens, ``lm._head``) against the same composition of
  JAX's pieces (``benchmarks/table3.py``'s), with weights from
  ``weights.from_jax`` and JAX's projection passed in, in ``train``
  (FORWARD_T) and ``eval`` (hard FORWARD_I) modes, at leaf widths 32 and 1
  and dense; ``eval`` also down the resolver's CUDA branch (router and
  grouped GEMMs, their plain versions here);
* ``optim.EarlyStopper`` over a metric sequence in both modes;
* three AdamW steps of the example's ``train_classifier`` against
  ``benchmarks/common.train_classifier`` at leaf widths 32 and 1.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from conftest import dtype_tol
from repro import optim as joptim
from repro.configs import paper_vit as jvit
from repro.models import lm as jlm
from repro.nn import transformer as jtransformer
from repro.optim import schedules as jschedules
from repro_torch import optim, utils, weights
from repro_torch.configs import paper_vit as vit
from repro_torch.core import api
from repro_torch.kernels.leaf_gemm import kernel as gemm_kernel
from repro_torch.kernels.leaf_gemm import ops as gemm_ops
from repro_torch.kernels.tree_router import kernel as router_kernel

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
B, DPATCH, N_TRAIN, STEPS, TRAIN_B = 4, 48, 32, 3, 8


def load_example():
    spec = importlib.util.spec_from_file_location(
        "vit_cifar_fff_torch", ROOT / "examples" / "vit_cifar_fff_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ex = load_example()


def close(got, want, err_msg=""):
    rtol, atol = dtype_tol(jnp.float32, "e2e")
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=err_msg)


def fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name.endswith("_dtype"):
            v = str(v).removeprefix("torch.") if isinstance(v, torch.dtype) \
                else jnp.dtype(v).name
        elif f.name == "period":
            v = [dataclasses.asdict(b) for b in v]
        out[f.name] = v
    return out


def configs(leaf):
    if leaf == 0:
        return jvit.vit_config("dense"), vit.vit_config("dense")
    return (jvit.vit_config("fff", leaf_width=leaf),
            vit.vit_config("fff", leaf_width=leaf))


@pytest.mark.parametrize("leaf", [0, 32, 8, 1])
def test_paper_vit_config_matches_jax(leaf):
    jc, tc = configs(leaf)
    assert fields(tc) == fields(jc)


def test_paper_vit_module_configs_match_jax():
    assert fields(vit.CONFIG) == fields(jvit.CONFIG)
    assert fields(vit.FFF_CONFIG) == fields(jvit.FFF_CONFIG)
    assert vit.vit_config("fff", hardening_scale=3.0).period[0].ffn.hardening_scale == 3.0


def jax_forward(cfg, proj):
    """``benchmarks/table3.py``'s ViT forward over JAX's pieces."""
    def fwd(p, x, mode):
        emb = jnp.einsum("bsp,pd->bsd", x, proj)
        h = jlm._embed_inputs(p, cfg, {"embeds": emb})
        h, _, aux = jtransformer.stack_forward(p["stack"], cfg, h, mode=mode,
                                               causal=False)
        return jlm._head(p, cfg, h.mean(axis=1)[:, None, :])[:, 0], aux["hardening"]
    return fwd


def model(leaf, seed=0):
    """JAX's init of the ViT, its weights carried over, and a projection."""
    jc, tc = configs(leaf)
    jp = jax.jit(lambda k: jlm.init(k, jc))(jax.random.PRNGKey(seed))
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    proj = (np.random.default_rng(seed + 1).normal(size=(DPATCH, tc.d_model))
            / np.sqrt(DPATCH)).astype(np.float32)
    return jc, tc, jp, tp, proj


@pytest.mark.parametrize("leaf", [0, 32, 1])
def test_vit_forward_matches_jax(leaf, monkeypatch):
    jc, tc, jp, tp, proj = model(leaf)
    x = np.random.default_rng(9).uniform(size=(B, 64, DPATCH)).astype(np.float32)
    fwd = jax.jit(jax_forward(jc, jnp.asarray(proj)), static_argnums=2)
    tproj = torch.from_numpy(proj)
    for mode in ("train", "eval"):
        want, jh = fwd(jp, x, mode)
        with torch.inference_mode():
            got, aux = ex.vit_forward(tp, tc, tproj, torch.from_numpy(x), mode)
        close(got.numpy(), want, err_msg=mode)
        if mode == "train":
            close(aux["hardening"].numpy(), jh)
    if leaf == 0:
        return
    # the card's branch of the resolver: tree_router, then grouped_matmul up
    # (gelu) and down, their plain versions on CPU tensors; up and down once
    # more where the site's tokens can pass a leaf's capacity (the overflow
    # pass, which the shape alone decides)
    calls = []
    for mod, name in ((router_kernel, "tree_router"), (gemm_kernel, "grouped_matmul")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    assert api.resolve_backend(tp["stack"][0]["ffn"], _site_cfg(tc), "infer",
                               (B, 64, tc.d_model), torch.device("cpu")) == "cuda"
    with torch.inference_mode():
        got, _ = ex.vit_forward(tp, tc, tproj, torch.from_numpy(x), "eval")
    close(got.numpy(), fwd(jp, x, "eval")[0])
    passes = gemm_ops.grouped_passes(B * 64, _site_cfg(tc).num_leaves,
                                     api.DEFAULT_CAPACITY_INFER)
    assert calls.count("tree_router") == tc.n_layers
    assert calls.count("grouped_matmul") == 2 * tc.n_layers * passes


def _site_cfg(cfg):
    from repro_torch.nn import mlp
    return mlp.make_fff_config(cfg.period[0].ffn, cfg.d_model,
                               param_dtype=cfg.param_dtype, accum_dtype=cfg.accum_dtype)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_early_stopper_matches_jax(mode):
    seq = [0.3, 0.5, 0.5, 0.4, 0.6, 0.6, 0.55, 0.2, 0.7, 0.1, 0.1, 0.1]
    ts, js = optim.EarlyStopper(patience=2, mode=mode), jschedules.EarlyStopper(2, mode)
    for i, m in enumerate(seq):
        assert ts.step(m, i) == js.step(m, i), i
        assert (ts.best, ts.best_step, ts.bad) == (js.best, js.best_step, js.bad), i


@pytest.mark.parametrize("leaf", [32, 1])
def test_train_classifier_three_adamw_steps_match_jax(leaf):
    """Three AdamW steps (lr 4e-4) from the same weights over the same
    batches (the loops draw them with the same numpy generator): every
    parameter after the steps."""
    jc, tc, jp, tp, proj = model(leaf)
    r = np.random.default_rng(4)

    class DS:
        x_train = r.uniform(size=(N_TRAIN, 64, DPATCH)).astype(np.float32)
        y_train = r.integers(0, 10, N_TRAIN).astype(np.int32)

    jfwd = jax_forward(jc, jnp.asarray(proj))
    want, _ = jcommon.train_classifier(lambda p, x, rng=None: jfwd(p, x, "train"),
                                       jp, DS, steps=STEPS, batch=TRAIN_B,
                                       opt=joptim.adamw(4e-4))
    tproj = torch.from_numpy(proj)

    def fwd_train(p, x, gen=None):
        logits, aux = ex.vit_forward(p, tc, tproj, x, "train")
        return logits, aux["hardening"]

    losses = []
    got, _ = ex.train_classifier(fwd_train, tp, DS, steps=STEPS, batch=TRAIN_B,
                                 opt=optim.adamw(4e-4), losses=losses)
    assert len(losses) == STEPS and all(np.isfinite(losses))
    want_t = weights.from_jax(jax.tree_util.tree_map(np.asarray, want), tc, device="cpu")
    for (k, g), (_, w) in zip(utils.tree_leaves_with_paths(got),
                              utils.tree_leaves_with_paths(want_t)):
        close(g.numpy(), w.numpy(), err_msg=k)
