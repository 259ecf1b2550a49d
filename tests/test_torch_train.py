"""The port's training path against the JAX package's, on the CPU.

The same numpy-drawn parameters and inputs go through both packages, in
float32 at the ``e2e`` tolerance of ``tests/conftest.py`` unless a test
says otherwise:

* the soft-routing math (``mixture_weights``, the hardening and balance
  losses, ``leaf_usage``, the decision entropies, ``decisive_fraction``) and
  its gradient, node logits of about +-30 included (the entropy clip), and
  ``as_dense_ff_params``;
* one FFF layer in training mode, FORWARD_T (``train/reference``) and the
  straight-through estimator (``train/grouped``, with an overflowing
  capacity), and ``auto``: outputs, aux and every ``jax.grad`` gradient;
* ``lm.loss_fn`` on ``FFF_CONFIG.reduced()``: loss, metrics and every
  parameter gradient (carried over by ``weights.from_jax``), under both
  train backends, plain, with a balance weight and with the master leaf;
  ``remat`` none, dots and full agree, also when the backward runs in
  another thread;
* the optimizers, schedules and gradient accumulation, and three steps of
  ``launch.train.train`` against three JAX train steps;
* the forward-only kernel wrappers refuse inputs that require grad, and the
  train backends never take a kernel branch.
"""
import dataclasses
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro import optim as joptim
from repro.configs import registry as jregistry
from repro.core import api as japi
from repro.core import fff as jfff
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import transformer as jtransformer
from repro_torch import optim, utils, weights
from repro_torch.configs import registry
from repro_torch.core import api, fff, routing
from repro_torch.data import tokens as tokens_lib
from repro_torch.kernels.fused_decode import kernel as fd_kernel
from repro_torch.kernels.fused_fff import kernel as fused_kernel
from repro_torch.kernels.leaf_gemm import kernel as gemm_kernel
from repro_torch.kernels.tree_router import kernel as router_kernel
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.nn import attention, transformer

torch.set_num_threads(2)

BATCH, SEQ = 2, 16


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return weights.tensor(np.asarray(a), device="cpu")


def close(got, want, kind="e2e", tol=None):
    rtol, atol = tol if tol is not None else dtype_tol(jnp.float32, kind)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def close_trees(got, want, kind="e2e", tol=None):
    """Leaf by leaf: ``got`` a port tree, ``want`` the same tree of
    tensors (carried over from JAX)."""
    assert len(utils.tree_leaves(got)) == len(utils.tree_leaves(want))
    utils.tree_map(lambda g, w: close(g, w.numpy(), kind, tol), got, want)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# soft-routing math and the losses
# ---------------------------------------------------------------------------

def node_logits(seed, B=24, T=2, N=7):
    """Logits with about a third of the entries saturated at +-30."""
    r = rng(seed)
    logits = r.normal(size=(B, T, N)) * 2.0
    sat = r.random((B, T, N)) < 0.35
    return np.where(sat, np.sign(logits) * 30.0, logits).astype(np.float32)


SOFT_FNS = {
    "mixture": (lambda m, p: m.mixture_weights(p, 3)),
    "hardening": (lambda m, p: m.hardening_loss(p)),
    "hardening_sum": (lambda m, p: m.hardening_loss(p, reduction="sum")),
    "balance": (lambda m, p: m.balance_loss(p, 3)),
    "leaf_usage": (lambda m, p: m.leaf_usage(p, 3)),
    "entropy_per_node": (lambda m, p: m.decision_entropy_per_node(p)),
    "decisive": (lambda m, p: m.decisive_fraction(p)),
}


@pytest.mark.parametrize("name", sorted(SOFT_FNS))
def test_soft_routing_math_matches_jax(name):
    """Values, and the gradient of their sum with respect to the node
    logits (through the sigmoid and the entropy clip) against jax.grad."""
    fn = SOFT_FNS[name]
    logits = node_logits(1)
    ct = rng(2).normal(size=np.shape(fn(jfff, jax.nn.sigmoid(logits)))).astype(np.float32)
    jval, jgrad = jax.value_and_grad(
        lambda z: (fn(jfff, jax.nn.sigmoid(z)) * ct).sum())(jnp.asarray(logits))
    z = t(logits).requires_grad_()
    val = fn(fff, torch.sigmoid(z))
    close(val, fn(jfff, jax.nn.sigmoid(logits)))
    if name == "decisive":        # a count: no gradient
        return
    (val * t(ct)).sum().backward()
    close(z.grad, jgrad)
    close((val * t(ct)).sum(), jval)


def test_bf16_entropy_is_finite_where_the_jax_clip_cannot_act():
    """1 - 1e-7 rounds to 1 in bfloat16: the JAX package's bf16 entropy of a
    saturated probability is NaN, the port's (evaluated in float32) is 0."""
    p = np.array([0.5, 0.99, 1.0, 1e-9], np.float32)
    jent = np.asarray(jfff.bernoulli_entropy(jnp.asarray(p, jnp.bfloat16)), np.float32)
    assert np.isnan(jent[2]) and not np.isnan(jent[[0, 1, 3]]).any()
    ent = fff.bernoulli_entropy(t(p).to(torch.bfloat16))
    assert ent.dtype == torch.bfloat16 and bool(torch.isfinite(ent).all())
    close(ent, np.nan_to_num(jent, nan=0.0), tol=dtype_tol(jnp.bfloat16, "e2e"))
    close(fff.bernoulli_entropy(t(p)), jfff.bernoulli_entropy(jnp.asarray(p)))


def test_as_dense_ff_params_matches_jax():
    jp, jcfg, tp, tcfg = fff_pair(3, act="gelu", trees=1, bias=True, master=False)
    got = fff.as_dense_ff_params(tp, tcfg)
    want = jfff.as_dense_ff_params(jp, jcfg)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    with pytest.raises(ValueError):
        fff.as_dense_ff_params(tp, dataclasses.replace(tcfg, trees=2))


# ---------------------------------------------------------------------------
# one FFF layer in training mode
# ---------------------------------------------------------------------------

def fff_pair(seed, *, depth=3, act="swiglu", trees=1, dim=16, leaf=8,
             master=False, bias=False, skew=0.0, saturate=False, **kw):
    """One FFF layer drawn with numpy under the JAX package's shapes, in
    both packages.  ``skew`` shifts the root's bias (most tokens go right);
    ``saturate`` pins some node biases at +-30."""
    kw = dict(dim_in=dim, dim_out=dim, depth=depth, leaf_width=leaf,
              activation=act, trees=trees, leaf_bias=bias, master_leaf=master, **kw)
    shapes = {k: tuple(v.shape) for k, v in
              fff.init(torch.Generator().manual_seed(0), fff.FFFConfig(**kw)).items()}
    r = rng(seed)
    params = {}
    for k, shp in shapes.items():
        fan_in = shp[-2] if len(shp) >= 2 and not k.startswith(("node_b", "leaf_b")) else 1
        params[k] = (r.normal(size=shp) / np.sqrt(fan_in)).astype(np.float32)
        if k.startswith(("node_b", "leaf_b")):
            params[k] *= 0.1
    params["node_b2"][:, 0] += skew
    if saturate:
        params["node_b2"][:, 1::2] = 30.0 * np.sign(r.normal(size=params["node_b2"][:, 1::2].shape))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return jp, jfff.FFFConfig(**kw), weights.tree(params, device="cpu"), fff.FFFConfig(**kw)


LAYER_CASES = {
    "plain": dict(),
    "forest": dict(act="gelu", trees=2, bias=True, master=True),
    "saturated": dict(saturate=True),
    "overflow": dict(skew=1.5, cf=0.25),
    "transpose": dict(transposition_prob=1.0),
    "freeze": dict(freeze_tree=True, act="relu", master=True),
}


def layer_objective(pkg, params, cfg, x, spec, ct):
    """sum(y * ct) + hardening + balance: the output and both aux losses
    feed the gradient."""
    y, out = pkg.apply(params, cfg, x, spec)
    F = jfff if pkg is japi else fff
    obj = ((y * ct).sum() + F.hardening_loss(out.node_probs)
           + F.balance_loss(out.node_probs, cfg.depth))
    return obj, (y, out)


@pytest.mark.parametrize("backend,case", [
    (b, c) for b in ("reference", "grouped") for c in sorted(LAYER_CASES)]
    + [("auto", "plain"), ("auto", "overflow")])
def test_train_layer_matches_jax(backend, case):
    """api.apply(mode="train"): output, node probabilities, mixture,
    entropy, leaf indices and overflow, and the gradients of every
    parameter and of x.  ``auto`` resolves as JAX does: FORWARD_T, or the
    straight-through estimator where the config sets ``st_training``
    (the overflow case)."""
    kw = dict(LAYER_CASES[case])
    cf = kw.pop("cf", None)
    if backend == "auto" and case == "overflow":
        kw["st_training"] = True
    jp, jcfg, tp, tcfg = fff_pair(10 + len(case), **kw)
    B = 61
    x = rng(5).normal(size=(B, 16)).astype(np.float32)
    ct = rng(6).normal(size=(B, 16)).astype(np.float32)
    jspec = japi.ExecutionSpec(mode="train", backend=backend, capacity_factor=cf,
                               rng=jax.random.PRNGKey(0))
    (jobj, (jy, jout)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        lambda p, x: layer_objective(japi, p, jcfg, x, jspec, ct),
        argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    spec = api.ExecutionSpec(mode="train", backend=backend, capacity_factor=cf,
                             gen=torch.Generator().manual_seed(0))
    (obj, (y, out)), grads = optim.value_and_grad(
        lambda tree: layer_objective(api, tree["p"], tcfg, tree["x"], spec, t(ct)))(
        {"p": tp, "x": t(x)})
    close(obj, jobj)
    close(y, jy)
    for f in ("node_probs", "mixture", "entropy", "overflow_fraction"):
        want = getattr(jout, f)
        if want is None:
            assert getattr(out, f) is None, f
        else:
            close(getattr(out, f), want)
    if jout.leaf_idx is None:
        assert out.leaf_idx is None
    else:
        np.testing.assert_array_equal(out.leaf_idx.numpy(), np.asarray(jout.leaf_idx))
    if case == "overflow" and backend != "reference":
        assert float(out.overflow_fraction) > 0.05       # dropped tokens
    close(grads["x"], jgx)
    assert set(grads["p"]) == set(jgp)
    for k in jgp:
        close(grads["p"][k], jgp[k])
    if case == "freeze":
        for k in ("node_w1", "node_b1", "node_w2", "node_b2"):
            assert not bool(grads["p"][k].any()), k


def test_train_output_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(api.FFFOutput)]
            == [f.name for f in dataclasses.fields(japi.FFFOutput)])
    assert api.list_backends("train") == japi.list_backends("train") == ["grouped", "reference"]


# ---------------------------------------------------------------------------
# the model: attention, eval mode, the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
def test_attention_forward_matches_jax(window):
    kw = dict(d_model=16, n_heads=4, n_kv_heads=2, head_dim=4, sliding_window=window)
    jcfg, tcfg = jattn.AttnConfig(**kw), attention.AttnConfig(**kw)
    r = rng(20)
    p = {k: r.normal(size=v.shape).astype(np.float32) / 4 for k, v in
         attention.init(torch.Generator().manual_seed(0), tcfg).items()}
    x = r.normal(size=(2, 11, 16)).astype(np.float32)
    want = jattn.forward({k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x))
    close(attention.forward(weights.tree(p, device="cpu"), tcfg, t(x)), want)
    # above FLASH_ABOVE both packages take their blocked flash attention (on
    # a chunk the window is a whole number of)
    kw.update(chunk=window or 32)
    jcfg, tcfg = jattn.AttnConfig(**kw), attention.AttnConfig(**kw)
    x = r.normal(size=(1, attention.FLASH_ABOVE + 32, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: jattn.forward(p, jcfg, x))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    close(attention.forward(weights.tree(p, device="cpu"), tcfg, t(x)), want)


def test_cross_entropy_matches_jax():
    r = rng(21)
    logits = r.normal(size=(3, 7, 11)).astype(np.float32)
    labels = r.integers(0, 11, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -1
    loss, acc = lm.cross_entropy(t(logits), t(labels))
    jloss, jacc = jlm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    close(loss, jloss)
    close(acc, jacc)


def model_cfgs(variant="plain", n_layers=1):
    jcfg = jregistry.get_config("internlm2-20b").reduced(n_layers=n_layers)
    tcfg = registry.get_config("internlm2-20b").reduced(n_layers=n_layers)
    kw = {"plain": {}, "balance": dict(balance=0.01), "master": dict(master=True)}[variant]
    if kw:
        jcfg = jtrain._with_fff_training_opts(jcfg, **kw)
        tcfg = train_mod._with_fff_training_opts(tcfg, **kw)
    return jcfg, tcfg


def model_params(jcfg, tcfg, seed=30):
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = rng(seed)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 8.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    return jp, weights.from_jax(np_tree(jp), tcfg, device="cpu")


def markov_batch(vocab, seed=0):
    return tokens_lib.MarkovTokenSource(vocab, seed=0).batch(BATCH, SEQ, seed=seed)


def test_eval_mode_matches_jax():
    """Full attention without a cache and hard FFF routing."""
    jcfg, tcfg = model_cfgs(n_layers=2)
    jp, tp = model_params(jcfg, tcfg)
    x = rng(31).normal(size=(BATCH, SEQ, tcfg.d_model)).astype(np.float32)
    jy, _, _ = jax.jit(lambda p, x: jtransformer.stack_forward(
        p["stack"], jcfg, x, mode="eval"))(jp, jnp.asarray(x))
    y, caches, aux = transformer.stack_forward(tp["stack"], tcfg, t(x), mode="eval")
    assert caches is None and aux == {}
    close(y, jy)


@pytest.mark.parametrize("variant", ["plain", "balance", "master"])
@pytest.mark.parametrize("backend", ["reference", "grouped"])
def test_loss_fn_matches_jax(backend, variant):
    """Loss, every metric and every parameter gradient of lm.loss_fn on
    FFF_CONFIG.reduced(), the JAX gradients carried over by from_jax."""
    jcfg, tcfg = model_cfgs(variant)
    jp, tp = model_params(jcfg, tcfg)
    batch = markov_batch(tcfg.vocab_size)
    with japi.overrides(backend=backend, mode="train"):
        (jloss, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(jp, batch)
    with api.overrides(backend=backend, mode="train"):
        (loss, m), g = optim.value_and_grad(lambda p, b: lm.loss_fn(p, tcfg, b))(tp, batch)
    close(loss, jloss)
    assert set(m) == set(jm)
    for k in jm:
        close(m[k], jm[k])
    if variant == "balance":
        assert float(m["balance"]) > 0
    close_trees(g, weights.from_jax(np_tree(jg), tcfg, device="cpu"))


def loss_and_grads(tcfg, tp, batch):
    return optim.value_and_grad(lambda p, b: lm.loss_fn(p, tcfg, b))(tp, batch)


@pytest.mark.parametrize("backend", ["reference", "grouped"])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_keeps_loss_and_gradients(remat, backend):
    """Checkpointing changes what the backward recomputes, not its result
    (within 1e-6); the metric tensors come back detached."""
    jcfg, tcfg = model_cfgs(n_layers=2)
    _, tp = model_params(jcfg, tcfg)
    batch = markov_batch(tcfg.vocab_size)
    with api.overrides(backend=backend, mode="train"):
        (loss, m), g = loss_and_grads(tcfg, tp, batch)
        (rloss, rm), rg = loss_and_grads(dataclasses.replace(tcfg, remat=remat), tp, batch)
    assert not rm["loss"].requires_grad
    tol = (1e-6, 1e-6)
    close(rloss, loss.numpy(), tol=tol)
    for k in m:
        close(rm[k], m[k].numpy(), tol=tol)
    close_trees(rg, g, tol=tol)


def test_remat_recompute_in_another_thread_keeps_the_override():
    """A checkpointed layer's recompute runs the backward's thread (on the
    card, autograd's own): it must still resolve the backend that was
    installed in the forward's thread.  Here the forward runs under
    overrides(backend="grouped") and the backward in a fresh thread with
    no override: the gradients are grouped's, not FORWARD_T's."""
    jcfg, tcfg = model_cfgs(n_layers=2)
    _, tp = model_params(jcfg, tcfg)
    batch = markov_batch(tcfg.vocab_size)
    with api.overrides(backend="grouped", mode="train"):
        _, want = loss_and_grads(tcfg, tp, batch)
    _, soft = loss_and_grads(tcfg, tp, batch)
    live = utils.tree_map(lambda p: p.detach().requires_grad_(), tp)
    with api.overrides(backend="grouped", mode="train"):
        loss, _ = lm.loss_fn(live, dataclasses.replace(tcfg, remat="full"), batch)
    out = {}
    th = threading.Thread(target=lambda: out.update(grads=torch.autograd.grad(
        loss, utils.tree_leaves(live))))
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    got = out["grads"]
    for a, b in zip(got, utils.tree_leaves(want)):
        close(a, b.numpy(), tol=(1e-6, 1e-6))
    assert any(not torch.allclose(a, b, atol=1e-5)
               for a, b in zip(got, utils.tree_leaves(soft)))


# ---------------------------------------------------------------------------
# optimizers, schedules, accumulation and the driver
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw_clip_cosine": lambda O: O.chain_clip(O.adamw(O.cosine_warmup(0.05, 2, 3),
                                                        weight_decay=0.1), 1.0),
    "adamw_const": lambda O: O.adamw(0.01, b1=0.8, b2=0.9, eps=1e-6),
    "sgd": lambda O: O.sgd(0.1),
    "sgd_momentum": lambda O: O.sgd(O.constant(0.1), momentum=0.9),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    """Three update + apply_updates steps on a small tree; params within
    1e-4 after each."""
    r = rng(40)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}
    params = jax.tree_util.tree_map(lambda s: r.normal(size=s).astype(np.float32),
                                    shapes, is_leaf=lambda s: isinstance(s, tuple))
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), weights.tree(params, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda a: (r.normal(size=a.shape) * 2).astype(np.float32),
                                   params)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(weights.tree(g, device="cpu"), ts, tp)
        tp = optim.apply_updates(tp, tu)
        close_trees(tp, weights.tree(np_tree(jp), device="cpu"), tol=(1e-4, 1e-4))


def test_schedules_match_jax():
    for sched in ((lambda O: O.cosine_warmup(3e-4, 3, 20)),
                  (lambda O: O.cosine_warmup(1.0, 0, 5, final_frac=0.0)),
                  (lambda O: O.constant(0.2))):
        for step in range(0, 24):
            assert sched(optim)(step) == pytest.approx(
                float(sched(joptim)(jnp.asarray(step))), rel=1e-6, abs=1e-9)
    metrics = [0.1, 0.2, 0.2, 0.15, 0.2, 0.19, 0.3, 0.1, 0.1]
    jh, th = joptim.plateau_halving(1.0, 2), optim.plateau_halving(1.0, 2)
    assert [th.step(m) for m in metrics] == [jh.step(m) for m in metrics]


@pytest.mark.parametrize("num_micro", [1, 2])
def test_gradient_accumulation_matches_jax(num_micro):
    r = rng(41)
    w = r.normal(size=(4, 3)).astype(np.float32)
    batch = {"x": r.normal(size=(6, 4)).astype(np.float32),
             "y": r.normal(size=(6, 3)).astype(np.float32)}

    def loss(pkg):
        def fn(p, b, key):
            err = (b["x"] @ p["w"] - b["y"]) ** 2
            return err.mean(), {"loss": err.mean(), "max": err.max()}
        return fn

    jg, (jl, jm) = joptim.gradient_accumulation(loss(jnp), num_micro)(
        {"w": jnp.asarray(w)}, jax.tree_util.tree_map(jnp.asarray, batch), None)
    g, (l, m) = optim.gradient_accumulation(loss(torch), num_micro)(
        {"w": t(w)}, {k: t(v) for k, v in batch.items()})
    close(g["w"], jg["w"], kind="kernel")
    close(l, jl, kind="kernel")
    assert set(m) == set(jm)


def test_train_matches_three_jax_steps():
    """launch.train.train from carried-over weights against the JAX driver's
    train step (its optimizer, batches and loss), three steps: losses and
    the final parameters within 1e-3."""
    jcfg, tcfg = model_cfgs()
    jp, tp = model_params(jcfg, tcfg)
    steps, lr, seed = 3, 3e-4, 0
    res = train_mod.train(tcfg, steps=steps, batch=BATCH, seq=SEQ, lr=lr, seed=seed,
                          device="cpu", params=tp, log=lambda s: None)
    opt = joptim.chain_clip(joptim.adamw(joptim.cosine_warmup(lr, steps // 10 + 1,
                                                             steps)), 1.0)
    source = tokens_lib.MarkovTokenSource(jcfg.vocab_size, seed=seed)

    @jax.jit
    def step(p, s, b):
        (_, m), g = jax.value_and_grad(lambda p: jlm.loss_fn(p, jcfg, b), has_aux=True)(p)
        u, s = opt.update(g, s, p)
        return joptim.apply_updates(p, u), s, m

    js = opt.init(jp)
    for i in range(steps):
        jp, js, jm = step(jp, js, source.batch(BATCH, SEQ, seed=seed + i))
        assert res.metrics[i]["loss"] == pytest.approx(float(jm["loss"]), abs=1e-3, rel=1e-3)
    assert len(res.step_ms) == steps
    close_trees(res.params, weights.from_jax(np_tree(jp), tcfg, device="cpu"))


STEP_LINE = re.compile(r"^step +\d+ loss +[\d.]+ ce +[\d.]+ harden +[\d.]+ "
                       r"balance +[\d.]+ +[\d.]+ms$")


@pytest.mark.parametrize("flags", [[], ["--balance-weight", "0.01"], ["--master-leaf"]],
                         ids=["plain", "balance", "master"])
def test_train_cli_on_cpu(capsys, flags):
    res = train_mod.main(["--arch", "internlm2-20b", "--reduced", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu", *flags])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("internlm2-20b: ") and lines[-1] == "done at step 2 (restarts=0)"
    assert all(STEP_LINE.match(line) for line in lines[1:-1]), lines
    assert all(np.isfinite(res.losses))
    assert (res.metrics[0]["balance"] > 0) == ("--balance-weight" in flags)
    assert ("master_wg" in res.params["stack"][0]["ffn"]) == ("--master-leaf" in flags)


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# the forward-only kernels stay out of autograd graphs
# ---------------------------------------------------------------------------

def _kernel_calls():
    r = torch.Generator().manual_seed(0)
    x2, w = torch.randn(4, 8, generator=r), torch.randn(2, 8, 6, generator=r)
    x3, gs = torch.randn(2, 4, 8, generator=r), torch.tensor([4, 2], dtype=torch.int32)
    idx = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    leaf = (torch.randn(1, 4, 8, 5, generator=r), torch.randn(1, 4, 5, 8, generator=r))
    return {
        "tree_router": (router_kernel.tree_router, (x2, torch.randn(3, 8), torch.randn(3)),
                        dict(depth=2)),
        "grouped_matmul": (gemm_kernel.grouped_matmul, (x3, w, gs), {}),
        "grouped_matmul_dual": (gemm_kernel.grouped_matmul_dual, (x3, w, w, gs), {}),
        "gathered_matmul": (fused_kernel.gathered_matmul, (x2, w, idx), {}),
        "gathered_matmul_dual": (fused_kernel.gathered_matmul_dual, (x2, w, w, idx), {}),
        "fused_forest_decode": (fd_kernel.fused_forest_decode,
                                (x2, torch.randn(1, 3, 8), torch.randn(1, 3), leaf),
                                dict(depth=2, act="gelu")),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    fn, args, kw = _kernel_calls()[name]
    fn(*args, **kw)                                     # no grad anywhere: runs
    w = args[1].clone().requires_grad_()
    args = (args[0], w) + args[2:]
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*args, **kw)
    with torch.no_grad():
        fn(*args, **kw)


def _forbid_kernels(monkeypatch):
    """Every kernel entry and the card's leaf-MLP branch raise; the resolver
    takes its CUDA branches for CPU tensors."""
    def forbidden(*a, **kw):
        raise AssertionError("a kernel branch ran")

    monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    for mod, names in ((router_kernel, ["tree_router"]),
                       (gemm_kernel, ["grouped_matmul", "grouped_matmul_dual"]),
                       (fused_kernel, ["gathered_matmul", "gathered_matmul_dual"]),
                       (fd_kernel, ["fused_forest_decode"])):
        for n in names:
            monkeypatch.setattr(mod, n, forbidden)
    monkeypatch.setattr(routing, "_leaf_mlp_kernels", forbidden)
    monkeypatch.setattr(routing, "_leaf_mlp_on_buffers", forbidden)


@pytest.mark.parametrize("backend", ["auto", "reference", "grouped", "infer"])
def test_train_backends_never_take_a_kernel_branch(monkeypatch, backend):
    """With the kernel entries forbidden and the resolver on its CUDA
    branch, training runs under every train backend; inference, which does
    take the kernels, trips the trap (so the trap is live)."""
    _forbid_kernels(monkeypatch)
    jcfg, tcfg = model_cfgs()
    _, tp = model_params(jcfg, tcfg)
    batch = markov_batch(tcfg.vocab_size)
    if backend == "infer":
        with pytest.raises(AssertionError, match="kernel branch"), torch.no_grad():
            lm.generate(tp, tcfg, torch.as_tensor(batch["tokens"]), 1, SEQ + 2)
        return
    with api.overrides(backend=None if backend == "auto" else backend, mode=None
                       if backend == "auto" else "train"):
        (loss, _), g = loss_and_grads(tcfg, tp, batch)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(x).all()) for x in utils.tree_leaves(g))
