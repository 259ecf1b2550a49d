"""The port's mixture-of-experts baseline (``repro_torch.core.moe`` and the
``moe`` FFN site) against the JAX package's, on the CPU.

The same numpy-drawn parameters and inputs go through both packages in
float32, compared at the ``kernel`` tolerance of ``tests/conftest.py``
(one layer, no routing decision close to a tie):

* ``init``'s shapes and dtypes, and its zero gates;
* ``forward`` with noisy gating off (no generator), in training and
  evaluation: output, gates, load, importance and the aux loss, and every
  ``jax.grad`` gradient of a weighted sum of them;
* ``_top_k_gates`` on numpy-drawn noisy logits: gates, the normal-CDF load
  estimate and its gradient; ties go to the lower expert, as
  ``jax.lax.top_k`` sends them;
* noisy gating: the port's noise comes from its generator, and its gates
  and load are JAX's ``_top_k_gates`` fed that same noise;
* ``forward_sparse`` (grouped by expert) and ``forward_sparse_gather`` (the
  JAX form) against JAX's ``forward_sparse``, and against each other;
* the ``moe`` site of ``nn/mlp.py`` in training (``moe_aux``) and at
  inference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.configs.base import FFNSpec as JFFNSpec
from repro.core import moe as jmoe
from repro.nn import mlp as jmlp
from repro_torch import weights
from repro_torch.configs.base import FFNSpec
from repro_torch.core import moe
from repro_torch.nn import mlp

torch.set_num_threads(2)


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return weights.tensor(np.asarray(a, np.float32), device="cpu")


def close(got, want, kind="kernel"):
    rtol, atol = dtype_tol(jnp.float32, kind)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def configs(bias=True, act="gelu", E=6, k=2, noisy=True, D=12, H=10, O=8):
    kw = dict(dim_in=D, dim_out=O, num_experts=E, expert_width=H, top_k=k,
              activation=act, noisy_gating=noisy, bias=bias)
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def params(jcfg, seed=0):
    """Every parameter drawn with numpy (gates too, so top-k is decided)."""
    shapes = jax.eval_shape(lambda: jmoe.init(jax.random.PRNGKey(0), jcfg))
    r = rng(seed)
    jp = {n: jnp.asarray(r.normal(size=s.shape) / 2.0, s.dtype)
          for n, s in shapes.items()}
    return jp, {n: t(v) for n, v in jp.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_init_shapes_and_dtypes_match_jax(bias, dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(dim_in=16, dim_out=12, num_experts=4, expert_width=8, bias=bias)
    jcfg = jmoe.MoEConfig(**kw, param_dtype=jd)
    tcfg = moe.MoEConfig(**kw, param_dtype=td)
    want = jax.eval_shape(lambda: jmoe.init(jax.random.PRNGKey(0), jcfg))
    got = moe.init(torch.Generator().manual_seed(0), tcfg)
    assert set(got) == set(want)
    for name, s in want.items():
        assert tuple(got[name].shape) == s.shape, name
        assert got[name].dtype == td, name
    assert not got["gate_w"].any() and not got["noise_w"].any()
    w1 = got["expert_w1"].float()
    assert abs(float(w1.std()) - (2.0 / 16) ** 0.5) < 0.05     # He normal, fan-in D


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_without_noise_matches_jax(train, bias, act):
    """Output and aux, and the gradients of a weighted sum of the output and
    the aux loss with respect to every parameter and the input."""
    jcfg, tcfg = configs(bias=bias, act=act)
    jp, tp = params(jcfg)
    x = rng(1).normal(size=(3, 5, 12)).astype(np.float32)
    ct = rng(2).normal(size=(3, 5, 8)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.forward(p, jcfg, x, rng=None, train=train)
        return (y * ct).sum() + aux["aux_loss"], (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = {n: v.requires_grad_() for n, v in tp.items()}
    tx = t(x).requires_grad_()
    y, aux = moe.forward(tp, tcfg, tx, gen=None, train=train)
    ((y * t(ct)).sum() + aux["aux_loss"]).backward()
    close(y, jy)
    for key in ("gates", "load", "importance", "aux_loss"):
        close(aux[key], jaux[key])
    for name in tp:      # noise_w takes no part without noise: JAX's zeros
        grad = tp[name].grad
        close(torch.zeros_like(tp[name]) if grad is None else grad, jg[name])
    close(tx.grad, jgx)


@pytest.mark.parametrize("k,E", [(1, 4), (2, 6), (3, 3)])
def test_top_k_gates_and_load_gradient_match_jax(k, E):
    """Noisy logits drawn with numpy: gates, the normal-CDF load estimate
    (or the hard count when k = E) and the load's gradient with respect to
    the clean logits and the noise scale."""
    r = rng(3)
    B = 9
    clean = r.normal(size=(B, E)).astype(np.float32)
    std = (np.abs(r.normal(size=(B, E))) + 0.05).astype(np.float32)
    noisy = (clean + r.normal(size=(B, E)) * std).astype(np.float32)
    ct = r.normal(size=(E,)).astype(np.float32)

    def jfn(c, s):
        g, load = jmoe._top_k_gates(c, jnp.asarray(noisy), s, k, True, E)
        return (load * ct).sum(), (g, load)

    (_, (jg, jload)), (jdc, jds) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(clean), jnp.asarray(std))
    c, s = t(clean).requires_grad_(), t(std).requires_grad_()
    g, load = moe._top_k_gates(c, t(noisy), s, k, True, E)
    close(g, jg)
    close(load, jload)
    if k < E:
        (load * t(ct)).sum().backward()
        close(c.grad, jdc)
        close(s.grad, jds)
    # clean gating (evaluation): the hard load count
    g, load = moe._top_k_gates(t(clean), t(noisy), t(std), k, False, E)
    jg, jload = jmoe._top_k_gates(jnp.asarray(clean), jnp.asarray(noisy),
                                  jnp.asarray(std), k, False, E)
    close(g, jg)
    close(load, jload)


def test_ties_go_to_the_lower_expert_as_in_jax():
    """Zero gates tie every expert: both packages pick experts 0..k-1."""
    jcfg, tcfg = configs(k=2, E=5)
    jp, tp = params(jcfg)
    jp = dict(jp, gate_w=jnp.zeros_like(jp["gate_w"]))
    tp = dict(tp, gate_w=torch.zeros_like(tp["gate_w"]))
    x = rng(4).normal(size=(4, 12)).astype(np.float32)
    y, aux = moe.forward_sparse(tp, tcfg, t(x))
    jy, jaux = jmoe.forward_sparse(jp, jcfg, jnp.asarray(x))
    np.testing.assert_array_equal(aux["expert_idx"].numpy(), np.asarray(jaux["expert_idx"]))
    assert aux["expert_idx"].tolist() == [[0, 1]] * 4
    close(y, jy)


def test_noisy_gating_draws_from_the_generator():
    """The port's noise is N(0, 1) from its generator, scaled by softplus(x
    Wn) + 0.01; its gates and load equal JAX's _top_k_gates fed that same
    noise, and a generator with another seed gives other gates."""
    jcfg, tcfg = configs(E=6, k=2)
    jp, tp = params(jcfg, seed=5)
    x = rng(6).normal(size=(7, 12)).astype(np.float32)
    y, aux = moe.forward(tp, tcfg, t(x), gen=torch.Generator().manual_seed(3))
    noise = torch.randn((7, 6), generator=torch.Generator().manual_seed(3)).numpy()
    clean = x @ np.asarray(jp["gate_w"])
    std = np.asarray(jax.nn.softplus(jnp.asarray(x @ np.asarray(jp["noise_w"])))) + 1e-2
    jg, jload = jmoe._top_k_gates(jnp.asarray(clean), jnp.asarray(clean + noise * std),
                                  jnp.asarray(std), 2, True, 6)
    close(aux["gates"], jg)
    close(aux["load"], jload)
    _, other = moe.forward(tp, tcfg, t(x), gen=torch.Generator().manual_seed(4))
    assert not torch.equal(other["gates"], aux["gates"])
    assert bool(torch.isfinite(aux["aux_loss"])) and float(aux["aux_loss"]) > 0


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("k,E,B", [(2, 6, 13), (3, 8, 1), (2, 4, 40)])
def test_forward_sparse_matches_jax(B, E, k, bias):
    """The grouped form and the gather form against JAX's forward_sparse,
    and against each other; the expert indices exactly."""
    jcfg, tcfg = configs(bias=bias, E=E, k=k)
    jp, tp = params(jcfg, seed=7)
    x = rng(8).normal(size=(B, 12)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.forward_sparse(p, jcfg, x))(jp, jnp.asarray(x))
    y, aux = moe.forward_sparse(tp, tcfg, t(x))
    yg, auxg = moe.forward_sparse_gather(tp, tcfg, t(x))
    np.testing.assert_array_equal(aux["expert_idx"].numpy(), np.asarray(jaux["expert_idx"]))
    assert torch.equal(aux["expert_idx"], auxg["expert_idx"])
    close(y, jy)
    close(yg, jy)
    close(y, yg.numpy())


def site_specs(act):
    kw = dict(kind="moe", d_ff=10, activation=act, moe_experts=6, moe_top_k=2)
    return JFFNSpec(**kw), FFNSpec(**kw)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_mlp_moe_site_matches_jax(train, act):
    """nn/mlp's moe site: make_moe_config (SwiGLU becomes GELU, no biases),
    forward with moe_aux in training, forward_sparse at inference."""
    jspec, tspec = site_specs(act)
    kw = dict(param_dtype=jnp.float32, accum_dtype=jnp.float32)
    jcfg = jmlp.make_moe_config(jspec, 12, **kw)
    tcfg = mlp.make_moe_config(tspec, 12, param_dtype=torch.float32,
                               accum_dtype=torch.float32)
    assert tcfg.activation == jcfg.activation == "gelu" and not tcfg.bias
    shapes = jax.eval_shape(lambda: jmlp.init(jax.random.PRNGKey(0), jspec, 12, **kw))
    got = mlp.init(torch.Generator().manual_seed(0), tspec, 12,
                   param_dtype=torch.float32, accum_dtype=torch.float32)
    assert {n: tuple(v.shape) for n, v in got.items()} == {
        n: s.shape for n, s in shapes.items()}
    jp, tp = params(jcfg, seed=9)
    x = rng(10).normal(size=(2, 5, 12)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmlp.forward(p, jspec, 12, x, train=train, **kw))(
        jp, jnp.asarray(x))
    y, aux = mlp.forward(tp, tspec, 12, t(x), param_dtype=torch.float32,
                         accum_dtype=torch.float32, train=train)
    close(y, jy)
    if train:
        assert set(aux) == {"hardening", "moe_aux", "balance"}
        for key in aux:
            close(aux[key], jaux[key])
        assert float(aux["moe_aux"]) > 0
    else:
        assert aux == {}
