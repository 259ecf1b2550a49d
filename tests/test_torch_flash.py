"""The port's blocked ``flash_attention`` against the JAX package's, on the
CPU.

The same numpy inputs go through both packages, compared at the ``e2e``
tolerance of ``tests/conftest.py`` (float32; ``kernel``'s bf16 entry for
bf16 inputs):

* ``flash_attention`` itself: causal, a sliding window of whole chunks,
  GQA, a sequence that is not a multiple of the chunk (the chunk drops to
  their gcd), not causal, and bf16 inputs; and against the plain masked
  attention (``full_attention`` with a band); and its gradients with
  respect to q, k and v against ``jax.grad`` of JAX's;
* a window that is not a whole number of chunks: the port masks every
  chunk pair the band cuts and equals the plain masked attention, where
  the JAX package leaves the nearer pairs unmasked (a deliberate
  deviation, pinned here);
* the attention entry points route above ``FLASH_ABOVE`` tokens;
* the LM above ``FLASH_ABOVE``: a reduced starcoder2-15b FFF model with a
  64-token window, the same weights in both packages (``from_jax``),
  prefill logits of a 2080-token prompt and two greedy decode steps, and
  ``lm.loss_fn``'s loss and every parameter gradient over that prompt.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro_torch import optim, utils, weights
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.nn import attention

torch.set_num_threads(2)


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, kind="e2e", dtype=jnp.float32):
    rtol, atol = dtype_tol(dtype, kind)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def qkv(seed, B, S, H, K, hd=8, dtype=np.float32):
    r = rng(seed)
    return tuple(r.normal(size=(B, S, n, hd)).astype(dtype) for n in (H, K, K))


def plain(q, k, v, causal, window):
    """The materialized-score attention with the window as a band mask."""
    i = torch.arange(q.shape[1])
    band = (i[:, None] - i[None, :]) < window if window else None
    return attention.full_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal, bias_mask=band)


CASES = {
    "causal": dict(S=64, H=4, K=4, chunk=16, window=0, causal=True),
    "window": dict(S=96, H=4, K=4, chunk=16, window=32, causal=True),
    "gqa": dict(S=64, H=6, K=2, chunk=16, window=0, causal=True),
    "gqa window": dict(S=80, H=4, K=1, chunk=16, window=16, causal=True),
    "ragged": dict(S=60, H=4, K=2, chunk=16, window=0, causal=True),
    "ragged window": dict(S=84, H=4, K=2, chunk=16, window=24, causal=True),
    "one chunk": dict(S=12, H=2, K=2, chunk=16, window=0, causal=True),
    "not causal": dict(S=48, H=4, K=2, chunk=16, window=0, causal=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax(case):
    c = CASES[case]
    q, k, v = qkv(1, 2, c["S"], c["H"], c["K"])
    kw = dict(causal=c["causal"], chunk=c["chunk"], sliding_window=c["window"])
    want = jax.jit(lambda q, k, v: jattn.flash_attention(q, k, v, **kw))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = attention.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    close(got, want)
    close(got, plain(q, k, v, c["causal"], c["window"]).numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_grad_matches_jax(case):
    """The gradients of <flash(q, k, v), w> for numpy-drawn q, k, v and w
    against ``jax.grad`` of JAX's flash_attention."""
    c = CASES[case]
    q, k, v = qkv(5, 2, c["S"], c["H"], c["K"])
    w = rng(6).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=c["causal"], chunk=c["chunk"], sliding_window=c["window"])
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        jattn.flash_attention(q, k, v, **kw) * w), argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (attention.flash_attention(tq, tk, tv, **kw) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        close(got, ref)


def test_flash_bf16_matches_jax():
    q, k, v = (a.astype(jnp.bfloat16) for a in qkv(2, 1, 64, 4, 2))
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 chunk=16, sliding_window=32)
    got = attention.flash_attention(*(weights.tensor(a, device="cpu") for a in (q, k, v)),
                                    chunk=16, sliding_window=32)
    assert got.dtype == torch.bfloat16
    close(got, want, kind="kernel", dtype=jnp.bfloat16)


@pytest.mark.parametrize("window", [20, 40])
def test_window_off_the_chunks_is_exact(window):
    """A window that is not a whole number of chunks: the port equals the
    plain masked attention; the JAX package leaves the chunk pairs nearer
    than the band's edge unmasked and does not."""
    q, k, v = qkv(3, 1, 64, 4, 2)
    got = attention.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    chunk=16, sliding_window=window)
    want = plain(q, k, v, True, window)
    close(got, want.numpy())
    jax_out = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=16, sliding_window=window))
    assert np.abs(jax_out - want.numpy()).max() > 1e-2


def test_chunk_schedule_matches_jax_on_whole_chunks():
    """On windows of whole chunks the port's pair schedule is JAX's."""
    for n, causal, w in ((5, True, 0), (6, True, 2), (4, False, 0), (7, True, 1)):
        qi, kj, mk = (np.asarray(a).tolist() for a in jattn._chunk_pairs(n, n, causal, w))
        got = attention._chunk_pairs(n, n, causal, w, 16, 16 * w)
        assert got == list(zip(qi, kj, mk))


@pytest.mark.parametrize("entry", ["forward", "forward_prefill"])
def test_entry_points_route_above_flash_above(entry, monkeypatch):
    """Above FLASH_ABOVE tokens forward and forward_prefill call
    flash_attention with the config's chunk and window; at it, they do
    not."""
    cfg = attention.AttnConfig(d_model=16, n_heads=4, n_kv_heads=2, head_dim=4,
                               sliding_window=8, chunk=4)
    params = attention.init(torch.Generator().manual_seed(0), cfg)
    calls = []
    flash = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: (calls.append(kw), flash(*a, **kw))[1])
    monkeypatch.setattr(attention, "FLASH_ABOVE", 12)
    for S in (12, 16):
        x = torch.randn(1, S, 16, generator=torch.Generator().manual_seed(S))
        if entry == "forward":
            attention.forward(params, cfg, x)
        else:
            attention.forward_prefill(params, cfg, x, attention.init_cache(1, S, cfg))
    assert calls == [dict(causal=True, chunk=4, sliding_window=8)]


S_LONG, WINDOW = 2080, 64


@pytest.fixture(scope="module")
def long_model():
    """Reduced starcoder2-15b FFF (2 layers, LayerNorm, attention biases,
    GELU leaves), its window cut to 64 so that it binds, float32, the same
    numpy-drawn weights in both packages."""
    def cut(cfg):
        cfg = cfg.reduced(n_layers=2, seq=S_LONG + 4)
        return dataclasses.replace(cfg, period=tuple(
            dataclasses.replace(b, sliding_window=WINDOW) for b in cfg.period))
    jcfg = cut(jregistry.get_config("starcoder2-15b"))
    tcfg = cut(registry.get_config("starcoder2-15b"))
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = rng(4)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 8.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    prompt = r.integers(0, jcfg.vocab_size, (1, S_LONG)).astype(np.int32)
    return jcfg, tcfg, jp, tp, prompt


def test_lm_prefill_above_flash_above_matches_jax(long_model):
    """Prefill logits of the 2080-token prompt (every layer through flash
    attention with the window), then two greedy decode steps against the
    window-masked cache: logits within e2e, the same greedy tokens."""
    jcfg, tcfg, jp, tp, prompt = long_model
    max_len = S_LONG + 3
    jl, jc = jax.jit(lambda p, x, c: jlm.prefill(p, jcfg, {"tokens": x}, c))(
        jp, jnp.asarray(prompt), jlm.init_caches(jcfg, 1, max_len))
    step = jax.jit(lambda p, x, c, i: jlm.decode_step(p, jcfg, x, c, i))
    with torch.inference_mode():
        tl, tc = lm.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)},
                            lm.init_caches(tcfg, 1, max_len, device="cpu"))
        close(tl, jl)
        for i in range(2):
            tok = tl.argmax(-1)[:, None].to(torch.int32)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jl.argmax(-1))[:, None])
            jl, jc = step(jp, jnp.asarray(tok.numpy()), jc, S_LONG + i)
            tl, tc = lm.decode_step(tp, tcfg, tok, tc, S_LONG + i)
            close(tl, jl)


def test_lm_loss_grad_above_flash_above_matches_jax(long_model):
    """Training above FLASH_ABOVE: ``lm.loss_fn`` over the 2080-token prompt
    (every layer's attention through flash with the window), its loss and
    every parameter gradient against ``jax.value_and_grad`` of JAX's."""
    jcfg, tcfg, jp, tp, prompt = long_model
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(jp, batch)
    (loss, _), grads = optim.value_and_grad(
        lambda p, b: lm.loss_fn(p, tcfg, b))(tp, batch)
    close(loss, jloss)
    want = weights.from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg,
                            device="cpu")
    assert len(utils.tree_leaves(grads)) == len(utils.tree_leaves(want))
    utils.tree_map(lambda g, w: close(g.detach(), w.numpy()), grads, want)
