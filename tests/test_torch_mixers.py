"""The port's recurrent mixers (``repro_torch.nn.mamba``, ``nn.xlstm`` and
their blocks in ``nn/transformer.py``) against the JAX package's, on the
CPU in float32.

The same parameters (JAX's ``init``, carried over as numpy) and the same
numpy-drawn inputs go through both packages; outputs and states are held
at the ``e2e`` tolerance of ``tests/conftest.py``:

* Mamba: ``forward`` from zeros (output and final state, over two chunks),
  a prefill then ``forward_step``s from the prefill's state, and chunk
  invariance (chunk 8 against 32);
* mLSTM: ``mlstm_chunkwise`` and ``mlstm_sequential`` against JAX's on
  drawn gates (with a carried state and at the stabilizer's start), the
  state carried across two segments, chunkwise against sequential, and
  ``mlstm_block`` both ways;
* sLSTM: ``slstm_block``'s output and state, from zeros and from a state;
* the ``mamba``, ``mlstm`` and ``slstm`` blocks of ``nn/transformer.py``:
  training mode, and prefill plus decode steps through their caches (the
  JAX cache keys and shapes); chunk mode refused in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.configs.base import BlockSpec as JBlockSpec, FFNSpec as JFFNSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.nn import mamba as jmamba, transformer as jtransformer, xlstm as jxlstm
from repro_torch import weights
from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig
from repro_torch.nn import mamba, transformer, xlstm

torch.set_num_threads(2)

B = 2


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return weights.tensor(np.asarray(a, np.float32), device="cpu")


def close(got, want, kind="e2e"):
    rtol, atol = dtype_tol(jnp.float32, kind)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def close_state(got, want):
    assert type(got)._fields == type(want)._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

MAMBA_KW = dict(d_model=16, d_state=4, d_conv=4, expand=2, chunk=8)


@pytest.fixture(scope="module")
def mamba_case():
    jcfg = jmamba.MambaConfig(**MAMBA_KW)
    jp = jmamba.init(jax.random.PRNGKey(3), jcfg)
    x = rng(0).normal(size=(B, 32, 16)).astype(np.float32)
    fwd = jax.jit(lambda p, x, s: jmamba.forward(p, jcfg, x, s))
    return jcfg, jp, weights.tree(np_tree(jp), "cpu"), x, fwd


def test_mamba_init_matches_jax_layout():
    jcfg = jmamba.MambaConfig(**MAMBA_KW)
    jp = jmamba.init(jax.random.PRNGKey(0), jcfg)
    tp = mamba.init(torch.Generator().manual_seed(0), mamba.MambaConfig(**MAMBA_KW))
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].is_contiguous(), k
    for k in ("A_log", "D_skip", "conv_b"):
        close(tp[k], jp[k], "kernel")
    # dt = softplus(dt_bias) is log-uniform on [1e-3, 1e-1]
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001


def test_mamba_forward_matches_jax(mamba_case):
    """S = 32 from zeros (four chunks of 8): output and final state."""
    jcfg, jp, tp, x, fwd = mamba_case
    want, wstate = fwd(jp, x, jmamba.init_state(B, jcfg))
    got, state = mamba.forward(tp, mamba.MambaConfig(**MAMBA_KW), t(x))
    close(got, want)
    close_state(state, wstate)


def test_mamba_prefill_then_steps_match_jax(mamba_case):
    """A 12-token prefill (chunk 8 does not divide it: gcd chunking), then
    four one-token ``forward_step``s, each from the last state."""
    jcfg, jp, tp, x, fwd = mamba_case
    cfg = mamba.MambaConfig(**MAMBA_KW)
    want, wstate = fwd(jp, x[:, :12], jmamba.init_state(B, jcfg))
    got, state = mamba.forward(tp, cfg, t(x[:, :12]))
    close(got, want)
    for i in range(12, 16):
        want, wstate = jax.jit(lambda p, x, s: jmamba.forward_step(p, jcfg, x, s))(
            jp, x[:, i:i + 1], wstate)
        got, state = mamba.forward_step(tp, cfg, t(x[:, i:i + 1]), state)
        close(got, want)
        close_state(state, wstate)


def test_mamba_chunk_invariance(mamba_case):
    """Chunk 8 and chunk 32 compute the same function (against JAX at 32)."""
    jcfg, jp, tp, x, _ = mamba_case
    jcfg32 = dataclasses.replace(jcfg, chunk=32)
    want, wstate = jax.jit(lambda p, x: jmamba.forward(p, jcfg32, x))(jp, x)
    outs = []
    for chunk in (8, 32):
        cfg = mamba.MambaConfig(**dict(MAMBA_KW, chunk=chunk))
        got, state = mamba.forward(tp, cfg, t(x))
        close(got, want)
        close_state(state, wstate)
        outs.append(got)
    close(outs[0], outs[1].numpy())


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

H, HD, S = 2, 8, 24


def gates(seed, s=S):
    r = rng(seed)
    q, k, v = (r.normal(size=(B, s, H, HD)).astype(np.float32) for _ in range(3))
    log_i = r.normal(size=(B, s, H)).astype(np.float32)
    log_f = np.asarray(jax.nn.log_sigmoid(r.normal(size=(B, s, H)) + 3.0), np.float32)
    return q, k / np.sqrt(HD), v, log_i, log_f


def mlstm_states(seed):
    """The stabilizer's start (zeros, m = -1e30) and a drawn state."""
    r = rng(seed)
    start = jxlstm.MLSTMState(jnp.zeros((B, H, HD, HD)), jnp.zeros((B, H, HD)),
                              jnp.full((B, H), -1e30))
    drawn = jxlstm.MLSTMState(
        jnp.asarray(r.normal(size=(B, H, HD, HD)) * 0.1, jnp.float32),
        jnp.asarray(r.normal(size=(B, H, HD)) * 0.1, jnp.float32),
        jnp.asarray(r.normal(size=(B, H)), jnp.float32))
    return {"start": start, "drawn": drawn}


_J_SEQ = jax.jit(jxlstm.mlstm_sequential)
_J_CHUNK = jax.jit(jxlstm.mlstm_chunkwise, static_argnums=6)


@pytest.mark.parametrize("state", ["start", "drawn"])
@pytest.mark.parametrize("form", ["chunkwise", "sequential"])
def test_mlstm_forms_match_jax(form, state):
    g = gates(1)
    jst = mlstm_states(2)[state]
    st = weights.state(np_tree(jst), xlstm.MLSTMState, "cpu")
    if form == "chunkwise":
        want, wst = _J_CHUNK(*g, jst, 8)
        got, gst = xlstm.mlstm_chunkwise(*map(t, g), st, 8)
    else:
        want, wst = _J_SEQ(*g, jst)
        got, gst = xlstm.mlstm_sequential(*map(t, g), st)
    close(got, want)
    close_state(gst, wst)


def test_mlstm_state_carries_across_segments():
    """Two segments (16 then 8 steps) with the state carried between them
    equal one 24-step pass, and JAX's two segments; the chunkwise form
    equals the sequential one."""
    g = gates(3)
    jst = mlstm_states(4)["start"]
    st = weights.state(np_tree(jst), xlstm.MLSTMState, "cpu")
    whole, whole_st = xlstm.mlstm_chunkwise(*map(t, g), st, 8)
    seq, seq_st = xlstm.mlstm_sequential(*map(t, g), st)
    close(whole, seq.numpy())
    close_state(whole_st, seq_st)
    first, mid = xlstm.mlstm_chunkwise(*(t(a[:, :16]) for a in g), st, 8)
    second, end = xlstm.mlstm_chunkwise(*(t(a[:, 16:]) for a in g), mid, 8)
    close(torch.cat([first, second], dim=1), whole.numpy())
    close_state(end, whole_st)
    _, jmid = _J_CHUNK(*(a[:, :16] for a in g), jst, 8)
    jsecond, jend = _J_CHUNK(*(a[:, 16:] for a in g), jmid, 8)
    close(second, jsecond)
    close_state(end, jend)


def test_mlstm_chunk_masks_with_exact_zeros():
    """The intra-chunk weights above the diagonal are exact zeros: a
    source step after t changes nothing at t, even with a huge value."""
    q, k, v, li, lf = gates(5, s=8)
    st = weights.state(np_tree(mlstm_states(0)["start"]), xlstm.MLSTMState, "cpu")
    base, _ = xlstm.mlstm_chunkwise(*map(t, (q, k, v, li, lf)), st, 8)
    v2 = v.copy()
    v2[:, 5:] = 1e30
    moved, _ = xlstm.mlstm_chunkwise(*map(t, (q, k, v2, li, lf)), st, 8)
    assert torch.equal(moved[:, :5], base[:, :5])


XL_KW = dict(d_model=16, n_heads=2, chunk=8)


@pytest.fixture(scope="module")
def xl_params():
    jcfg = jxlstm.XLSTMConfig(**XL_KW)
    jm = jxlstm.mlstm_init(jax.random.PRNGKey(5), jcfg)
    js = jxlstm.slstm_init(jax.random.PRNGKey(6), jcfg)
    r = rng(7)
    # gn_scale drawn, so a wrong head layout shows
    jm["gn_scale"] = jnp.asarray(1.0 + 0.1 * r.normal(size=jm["gn_scale"].shape),
                                 jnp.float32)
    js["gn_scale"] = jnp.asarray(1.0 + 0.1 * r.normal(size=js["gn_scale"].shape),
                                 jnp.float32)
    x = r.normal(size=(B, S, 16)).astype(np.float32)
    return jcfg, jm, js, x


def test_xlstm_init_matches_jax_layout():
    cfg = xlstm.XLSTMConfig(**XL_KW)
    jcfg = jxlstm.XLSTMConfig(**XL_KW)
    gen = torch.Generator().manual_seed(0)
    for tp, jp in ((xlstm.mlstm_init(gen, cfg), jxlstm.mlstm_init(jax.random.PRNGKey(0), jcfg)),
                   (xlstm.slstm_init(gen, cfg), jxlstm.slstm_init(jax.random.PRNGKey(0), jcfg))):
        assert list(tp) == list(jp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
        for k in ("b_if", "b", "gn_scale"):
            if k in jp:
                close(tp[k], jp[k], "kernel")


@pytest.mark.parametrize("sequential", [False, True])
def test_mlstm_block_matches_jax(xl_params, sequential):
    jcfg, jm, _, x = xl_params
    want, wst = jax.jit(lambda p, x: jxlstm.mlstm_block(p, jcfg, x, sequential=sequential))(
        jm, x)
    got, st = xlstm.mlstm_block(weights.tree(np_tree(jm), "cpu"),
                                xlstm.XLSTMConfig(**XL_KW), t(x), sequential=sequential)
    close(got, want)
    close_state(st, wst)


@pytest.mark.parametrize("from_state", [False, True])
def test_slstm_block_matches_jax(xl_params, from_state):
    jcfg, _, js, x = xl_params
    jst = None
    if from_state:
        r = rng(8)
        jst = jxlstm.SLSTMState(*(jnp.asarray(r.normal(size=(B, 16)) * 0.5, jnp.float32)
                                  for _ in range(4)))
    want, wst = jax.jit(lambda p, x, s: jxlstm.slstm_block(p, jcfg, x, s))(js, x, jst)
    st = None if jst is None else weights.state(np_tree(jst), xlstm.SLSTMState, "cpu")
    got, gst = xlstm.slstm_block(weights.tree(np_tree(js), "cpu"),
                                 xlstm.XLSTMConfig(**XL_KW), t(x), st)
    close(got, want)
    close_state(gst, wst)


# ---------------------------------------------------------------------------
# the blocks of nn/transformer.py
# ---------------------------------------------------------------------------

def block_configs(mixer):
    """A one-position float32 model per mixer; the Mamba block carries a
    dense FFN site (as Jamba's do), the xLSTM blocks none."""
    kind = "dense" if mixer == "mamba" else "none"
    kw = dict(arch_id="t", family="hybrid", d_model=16, n_layers=1, n_heads=2,
              n_kv_heads=2, vocab_size=32, mamba_d_state=4, lstm_heads=2,
              pos_emb="none")
    jc = JModelConfig(period=(JBlockSpec(mixer=mixer, ffn=JFFNSpec(kind=kind, d_ff=32)),),
                      **kw)
    tc = ModelConfig(period=(BlockSpec(mixer=mixer, ffn=FFNSpec(kind=kind, d_ff=32)),),
                     **kw)
    return jc, tc


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_block_matches_jax(mixer):
    """Training mode, then a 12-token prefill and three decode steps
    through the block's cache (the state under the mixer's key)."""
    jc, tc = block_configs(mixer)
    spec, jspec = tc.period[0], jc.period[0]
    jp = jtransformer.block_init(jax.random.PRNGKey(9), jc, jspec)
    tp = weights.tree(np_tree(jp), "cpu")
    fresh = transformer.block_init(torch.Generator().manual_seed(0), tc, spec)
    assert sorted(fresh) == sorted(tp) and sorted(fresh["mixer"]) == sorted(tp["mixer"])
    x = rng(10).normal(size=(B, 15, 16)).astype(np.float32)
    fwd = jax.jit(lambda p, x, c, mode: jtransformer.block_forward(p, jc, jspec, x,
                                                                   mode=mode, cache=c),
                  static_argnums=3)
    want, _, _ = fwd(jp, x, None, "train")
    got, cache, _ = transformer.block_forward(tp, tc, spec, t(x), mode="train")
    assert cache is None
    close(got, want)

    jcache = jtransformer.init_block_cache(jc, jspec, B, 16)
    cache = transformer.init_block_cache(tc, spec, B, 16)
    assert list(cache) == list(jcache) == [mixer]
    close_state(cache[mixer], jcache[mixer])
    want, jcache, _ = fwd(jp, x[:, :12], jcache, "prefill")
    got, cache, _ = transformer.block_forward(tp, tc, spec, t(x[:, :12]),
                                              mode="prefill", cache=cache)
    close(got, want)
    for i in range(12, 15):
        want, jcache, _ = fwd(jp, x[:, i:i + 1], jcache, "decode")
        got, cache, _ = transformer.block_forward(tp, tc, spec, t(x[:, i:i + 1]),
                                                  mode="decode", cache=cache)
        close(got, want)
        close_state(cache[mixer], jcache[mixer])


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_chunk_mode_refuses_recurrent_mixers(mixer):
    jc, tc = block_configs(mixer)
    spec = tc.period[0]
    tp = transformer.block_init(torch.Generator().manual_seed(0), tc, spec)
    cache = transformer.init_block_cache(tc, spec, B, 16)
    with pytest.raises(ValueError, match="attention mixers"):
        transformer.block_forward(tp, tc, spec, torch.zeros(B, 4, 16), mode="chunk",
                                  cache=cache, chunk_valid=torch.full((B,), 4))
    jp = jtransformer.block_init(jax.random.PRNGKey(0), jc, jc.period[0])
    with pytest.raises(ValueError, match="attention mixers"):
        jtransformer.block_forward(jp, jc, jc.period[0], jnp.zeros((B, 4, 16)),
                                   mode="chunk",
                                   cache=jtransformer.init_block_cache(jc, jc.period[0], B, 16),
                                   chunk_valid=jnp.full((B,), 4))
