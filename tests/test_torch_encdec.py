"""The encoder-decoder and frontend archs against the JAX package, on the
CPU in float32: whisper-small (an encoder over precomputed frame
embeddings, cross-attention in every decoder block, learned decoder
positions, a sinusoidal encoder table) and internvl2-26b (a vision stub:
the prompt enters as precomputed patch embeddings).

The same numpy-drawn parameters (carried over with ``weights.from_jax``)
and inputs go through both packages; values are held at the tolerances of
``tests/conftest.py``:

* ``sinusoidal_embedding``; ``learned_pos`` with a scalar and a per-row
  offset (and JAX's clamp and fill past the table); ``frontend`` with and
  without its projection; ``cross_kv`` and ``forward_cross`` (GQA, with
  and without biases);
* a cross-attention block in train, prefill and decode mode (the cross
  K/V stored by prefill and read back by decode), and chunk mode refused
  with the JAX message;
* ``encode`` on the reduced whisper, FFF and native, and that its FFF
  sites take the train-mode reference (FORWARD_T) even with the kernel
  branch of the resolver forced and under ``inference_mode``;
* both archs, FFF and native, 2 reduced layers: ``lm.loss_fn``'s loss,
  metrics and every gradient (the encoder's too), and a prefill plus two
  greedy ``decode_step``s (FFF also down the resolver's CUDA branch);
* the engine's refusal of both with the JAX message; the fixed-batch loop
  (``serve``, the JAX driver's batch: ``enc_embeds`` or an ``embeds``
  prompt from ``default_rng(0)``) against JAX's prefill and decode; the
  command lines of both drivers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.configs import registry as jregistry
from repro.data import tokens as jtokens
from repro.models import lm as jlm
from repro.nn import attention as jattention, embeddings as jembeddings
from repro.nn import rope as jrope, transformer as jtransformer
from repro_torch import optim, utils, weights
from repro_torch.configs import registry
from repro_torch.core import api
from repro_torch.models import lm
from repro_torch.nn import attention, embeddings, rope, transformer

torch.set_num_threads(2)

ARCHS = ("whisper-small", "internvl2-26b")
B, S, STEPS = 2, 12, 2


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return weights.tensor(np.asarray(a, np.float32), device="cpu")


def close(got, want, kind="e2e"):
    rtol, atol = dtype_tol(jnp.float32, kind)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def drawn(shapes, r):
    """numpy draws for a JAX parameter tree of shapes: scales 1, the rest
    N(0, 1/64)."""
    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 8.0, s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,dim", [(1500, 768), (32, 64), (7, 2), (5, 3)])
def test_sinusoidal_embedding(seq, dim):
    """whisper's table, divisor max(half - 1, 1) included (dim 2 and 3:
    half 1).  At e2e: the float32 timescales of the two packages' powers
    differ in the last bit, which position 1499 scales to ~1.2e-4."""
    got = rope.sinusoidal_embedding(seq, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, 2 * (dim // 2))
    close(got, jrope.sinusoidal_embedding(seq, dim))


@pytest.mark.parametrize("offset", [0, 5, 58, "rows", "rows past the table"])
def test_learned_pos(offset):
    """A scalar offset (a window past the table is clamped, as
    ``lax.dynamic_slice`` does) and per-row (B,) offsets (rows past the
    table read NaN, as ``jnp.take``'s fill)."""
    r = rng(1)
    table = r.normal(size=(64, 16)).astype(np.float32)
    x = r.normal(size=(3, 8, 16)).astype(np.float32)
    if offset == "rows":
        off = np.array([0, 3, 56], np.int32)
    elif offset == "rows past the table":
        off = np.array([0, 60, 57], np.int32)
    else:
        off = offset
    want = jembeddings.learned_pos({"pos": jnp.asarray(table)}, jnp.asarray(x),
                                   jnp.asarray(off) if isinstance(off, np.ndarray) else off)
    got = embeddings.learned_pos({"pos": t(table)}, t(x),
                                 torch.from_numpy(off) if isinstance(off, np.ndarray) else off)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    close(torch.nan_to_num(got), np.nan_to_num(np.asarray(want)), "kernel")


@pytest.mark.parametrize("kind", ["vision_stub", "none"])
def test_frontend(kind):
    r = rng(2)
    shapes = jax.eval_shape(lambda: jembeddings.frontend_init(
        jax.random.PRNGKey(0), kind, 16, jnp.float32))
    jp = drawn(shapes, r)
    tp = weights.tree(np_tree(jp), device="cpu")
    assert set(tp) == set(embeddings.frontend_init(torch.Generator(), kind, 16,
                                                   torch.float32))
    x = r.normal(size=(2, 5, 16)).astype(np.float32)
    close(embeddings.frontend(tp, t(x)), jembeddings.frontend(jp, jnp.asarray(x)), "kernel")


@pytest.mark.parametrize("bias,kv_heads", [(True, 2), (False, 4)])
def test_cross_kv_and_forward_cross(bias, kv_heads):
    """Queries from the decoder (8 positions), K/V from an encoder output
    of 11 positions, full and non-causal."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=kv_heads, head_dim=8, bias=bias,
              use_rope=False, causal=False)
    jcfg, tcfg = jattention.AttnConfig(**kw), attention.AttnConfig(**kw)
    r = rng(3)
    jp = drawn(jax.eval_shape(lambda: jattention.init(jax.random.PRNGKey(0), jcfg)), r)
    tp = weights.tree(np_tree(jp), device="cpu")
    enc = r.normal(size=(B, 11, 32)).astype(np.float32)
    x = r.normal(size=(B, 8, 32)).astype(np.float32)
    jk, jv = jattention.cross_kv(jp, jcfg, jnp.asarray(enc))
    k, v = attention.cross_kv(tp, tcfg, t(enc))
    assert tuple(k.shape) == (B, 11, kv_heads, 8)
    close(k, jk, "kernel")
    close(v, jv, "kernel")
    close(attention.forward_cross(tp, tcfg, t(x), k, v),
          jattention.forward_cross(jp, jcfg, jnp.asarray(x), jk, jv), "kernel")


def test_cross_attention_block_modes():
    """whisper's decoder block (reduced, native): train mode over a whole
    sequence, then prefill of 6 positions (the cache takes cross_kv's K/V)
    and two decode steps that read them back."""
    jcfg = jregistry.get_config("whisper-small", "native").reduced()
    tcfg = registry.get_config("whisper-small", "native").reduced()
    jspec, tspec = jcfg.period[0], tcfg.period[0]
    r = rng(4)
    jp = drawn(jax.eval_shape(lambda: jtransformer.block_init(
        jax.random.PRNGKey(0), jcfg, jspec)), r)
    tp = weights.tree(np_tree(jp), device="cpu")
    assert {"norm_x", "cross"} <= set(tp)
    enc = r.normal(size=(B, 10, 64)).astype(np.float32)
    x = r.normal(size=(B, 8, 64)).astype(np.float32)
    y, cache, _ = transformer.block_forward(tp, tcfg, tspec, t(x), mode="train",
                                            enc_out=t(enc))
    assert cache is None
    close(y, jtransformer.block_forward(jp, jcfg, jspec, jnp.asarray(x), mode="train",
                                        enc_out=jnp.asarray(enc))[0])
    jc = jtransformer.init_block_cache(jcfg, jspec, B, 16, 10)
    tc = transformer.init_block_cache(tcfg, tspec, B, 16, enc_len=10)
    assert tuple(tc["cross_k"].shape) == tuple(jc["cross_k"].shape) == (B, 10, 4, 16)
    assert not tc["cross_k"].any()
    jy, jc, _ = jtransformer.block_forward(jp, jcfg, jspec, jnp.asarray(x[:, :6]),
                                           mode="prefill", cache=jc,
                                           enc_out=jnp.asarray(enc))
    with torch.inference_mode():
        ty, tc, _ = transformer.block_forward(tp, tcfg, tspec, t(x[:, :6]),
                                              mode="prefill", cache=tc, enc_out=t(enc))
        close(ty, jy)
        assert set(tc) == set(jc) == {"kv", "cross_k", "cross_v"}
        close(tc["cross_k"], jc["cross_k"])
        close(tc["cross_v"], jc["cross_v"])
        for i in (6, 7):
            jy, jc, _ = jtransformer.block_forward(jp, jcfg, jspec,
                                                   jnp.asarray(x[:, i:i + 1]),
                                                   mode="decode", cache=jc)
            ty, tc, _ = transformer.block_forward(tp, tcfg, tspec, t(x[:, i:i + 1]),
                                                  mode="decode", cache=tc)
            close(ty, jy)
    ones = np.ones(B, np.int32)
    with pytest.raises(ValueError, match="cross-attn slabs are unsupported") as want:
        jtransformer.block_forward(jp, jcfg, jspec, jnp.asarray(x[:, :2]), mode="chunk",
                                   cache=jc, chunk_valid=jnp.asarray(ones))
    with pytest.raises(ValueError, match="cross-attn slabs are unsupported") as got:
        transformer.block_forward(tp, tcfg, tspec, t(x[:, :2]), mode="chunk", cache=tc,
                                  chunk_valid=torch.from_numpy(ones))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the reduced models, same weights in both packages
# ---------------------------------------------------------------------------

_MODELS = {}


def inputs(cfg, r, n=B, seq=S):
    """The prompt inputs and labels: tokens (whisper adds enc_embeds);
    internvl's prompt as embeds."""
    prompt = r.integers(0, cfg.vocab_size, (n, seq)).astype(np.int32)
    batch = {"tokens": prompt}
    if cfg.encoder is not None:
        batch["enc_embeds"] = r.normal(size=(n, cfg.encoder.seq_len, cfg.d_model)
                                       ).astype(np.float32)
    if cfg.frontend != "none" and cfg.encoder is None:
        batch = {"embeds": r.normal(size=(n, seq, cfg.d_model)).astype(np.float32)}
    return batch, np.roll(prompt, -1, axis=1)


def model(arch, ffn):
    """The 2-layer reduced configs, the port's params (JAX's carried over),
    the batch and the JAX oracles, once per (arch, ffn): loss, metrics and
    gradients; the encoder output; prefill and greedy decode logits."""
    if (arch, ffn) in _MODELS:
        return _MODELS[arch, ffn]
    jcfg = jregistry.get_config(arch, ffn).reduced(n_layers=2)
    tcfg = registry.get_config(arch, ffn).reduced(n_layers=2)
    r = rng(ARCHS.index(arch) * 2 + (ffn == "native"))
    jp = drawn(jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg)), r)
    tp = weights.from_jax(np_tree(jp), tcfg, device="cpu")
    prompt, labels = inputs(jcfg, r)
    batch = dict(prompt, labels=labels)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(jp, batch)
    enc = (np.asarray(jax.jit(lambda p, e: jlm.encode(p, jcfg, e))(jp, prompt["enc_embeds"]))
           if jcfg.encoder is not None else None)
    logits, caches = jax.jit(lambda p, b, c: jlm.prefill(p, jcfg, b, c))(
        jp, prompt, jlm.init_caches(jcfg, B, S + STEPS + 1))
    step = jax.jit(lambda p, x, c, i: jlm.decode_step(p, jcfg, x, c, i))
    seq = [np.asarray(logits)]
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, caches = step(jp, tok, caches, S + i)
        seq.append(np.asarray(logits))
    _MODELS[arch, ffn] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, prompt=prompt,
                              batch=batch, loss=loss, metrics=metrics,
                              grads=np_tree(grads), enc=enc, logits=seq)
    return _MODELS[arch, ffn]


def recording(monkeypatch):
    """Patch every registered FFF backend to record (mode, name) when it
    runs; returns the record."""
    ran = []
    for key, fn in list(api._REGISTRY.items()):
        monkeypatch.setitem(api._REGISTRY, key,
                            lambda *a, _fn=fn, _k=key: (ran.append(_k), _fn(*a))[1])
    return ran


@pytest.mark.parametrize("ffn", ["fff", "native"])
@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carry_over(arch, ffn):
    """from_jax carries the new entries: whisper's pos table, enc_frontend,
    enc_stack (one dict per encoder layer) and enc_norm, its decoder
    blocks' norm_x and cross; internvl's frontend.  Shapes and dtypes are
    lm.init's."""
    m = model(arch, ffn)
    tp, tcfg = m["tp"], m["tcfg"]
    fresh = lm.init(tcfg, seed=0, device="cpu")
    assert set(tp) == set(fresh) == set(m["jp"])
    assert len(utils.tree_leaves(tp)) == len(utils.tree_leaves(fresh))
    utils.tree_map(lambda a, b: None if a.shape == b.shape and a.dtype == b.dtype
                   else pytest.fail(f"{a.shape} {a.dtype} != {b.shape} {b.dtype}"),
                   tp, fresh)
    if arch == "whisper-small":
        assert len(tp["enc_stack"]) == tcfg.encoder.n_layers == 1
        assert {"norm_x", "cross"} <= set(tp["stack"][0])
        assert "cross" not in tp["enc_stack"][0]
        assert tuple(tp["pos"]["pos"].shape) == (tcfg.max_seq_len, tcfg.d_model)
    else:
        assert set(tp["frontend"]) == {"proj", "bias"}


@pytest.mark.parametrize("ffn", ["fff", "native"])
def test_encode_matches_jax_and_launches_nothing(ffn, monkeypatch):
    """The encoder output within e2e; its FFF sites run the train-mode
    reference (FORWARD_T, no kernel) even under inference_mode with the
    resolver's CUDA branch forced, as JAX's encode runs its stack in train
    mode."""
    m = model("whisper-small", ffn)
    ran = recording(monkeypatch)
    monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    with torch.inference_mode():
        enc = lm.encode(m["tp"], m["tcfg"], m["prompt"]["enc_embeds"])
    close(enc, m["enc"])
    assert set(ran) == ({("train", "reference")} if ffn == "fff" else set())


@pytest.mark.parametrize("ffn", ["fff", "native"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch, ffn):
    """Loss, every metric and every parameter gradient, the encoder's and
    the frontend's included."""
    m = model(arch, ffn)
    (loss, metrics), grads = optim.value_and_grad(
        lambda p, b: lm.loss_fn(p, m["tcfg"], b))(m["tp"], m["batch"])
    close(loss, m["loss"])
    assert set(metrics) == set(m["metrics"])
    for k in metrics:
        close(metrics[k], m["metrics"][k])
    want = weights.from_jax(m["grads"], m["tcfg"], device="cpu")
    assert set(grads) == set(want)
    assert len(utils.tree_leaves(grads)) == len(utils.tree_leaves(want))
    utils.tree_map(lambda g, w: close(g, w.numpy()), grads, want)


@pytest.mark.parametrize("arch,ffn,resolution", [
    (arch, ffn, res) for arch in ARCHS
    for ffn, res in (("fff", "auto"), ("fff", "kernels"), ("native", "auto"))])
def test_prefill_and_greedy_decode_match_jax(arch, ffn, resolution, monkeypatch):
    """Prefill (whisper: tokens and enc_embeds; internvl: an embeds
    prompt) and two greedy decode steps at learned or RoPE positions.
    Under ``kernels`` the decoder's FFF sites take the cuda (prefill) and
    cuda_decode backends, whose wrappers run their plain versions here;
    whisper's encoder stays on the train-mode reference.  A native model
    has no FFF site to resolve, so it runs once."""
    m = model(arch, ffn)
    tcfg = m["tcfg"]
    ran = recording(monkeypatch)
    if resolution == "kernels":
        monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    caches = lm.init_caches(tcfg, B, S + STEPS + 1, device="cpu")
    with torch.inference_mode():
        logits, caches = lm.prefill(m["tp"], tcfg, m["prompt"], caches)
        close(logits, m["logits"][0])
        for i in range(STEPS):
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            np.testing.assert_array_equal(tok[:, 0].numpy(), m["logits"][i].argmax(-1))
            logits, caches = lm.decode_step(m["tp"], tcfg, tok, caches, S + i)
            close(logits, m["logits"][i + 1])
    want = set()
    if ffn == "fff":
        want = ({("infer", "cuda"), ("infer", "cuda_decode")} if resolution == "kernels"
                else {("infer", "reference")})
        if arch == "whisper-small":
            want.add(("train", "reference"))
    assert set(ran) == want, set(ran)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_encoder_and_frontend_models(arch):
    from repro.serving import engine as jengine
    from repro_torch.serving import engine
    with pytest.raises(ValueError, match="decoder-only token LMs") as got:
        engine.ContinuousBatchingEngine(None, registry.get_config(arch).reduced(),
                                        engine.EngineConfig(device="cpu"))
    with pytest.raises(ValueError, match="decoder-only token LMs") as want:
        jengine.ContinuousBatchingEngine(None, jregistry.get_config(arch).reduced(),
                                         jengine.EngineConfig())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pos_emb", ["learned", "sinusoidal"])
def test_engine_refuses_absolute_positions(pos_emb):
    """A decoder-only token LM with learned or sinusoidal positions (no
    registry arch: whisper-small's decoder without its encoder) is refused
    by the port's engine, whose slabs and decode steps read positions off
    the cache lengths; the fixed-batch loop serves it."""
    from repro_torch.serving import engine
    w = registry.get_config("whisper-small").reduced()
    cfg = dataclasses.replace(w, encoder=None, frontend="none", pos_emb=pos_emb,
                              period=tuple(dataclasses.replace(b, cross_attention=False)
                                           for b in w.period))
    with pytest.raises(ValueError, match="serves through the fixed-batch loop"):
        engine.ContinuousBatchingEngine(None, cfg, engine.EngineConfig(device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_builds_the_jax_drivers_batch(arch):
    """``serve`` on JAX's weights gives the tokens of JAX's prefill and
    decode fed the batch the JAX driver's fixed-batch loop builds: the
    Markov prompt (whisper) with enc_embeds, or an embeds prompt
    (internvl), N(0, 1) from default_rng(0)."""
    from repro_torch.launch import serve as serve_mod
    m = model(arch, "fff")
    jcfg, jp, tcfg = m["jcfg"], m["jp"], m["tcfg"]
    n, plen, gen = 2, 8, 3
    src = jtokens.MarkovTokenSource(jcfg.vocab_size, seed=0)
    batch = {"tokens": jnp.asarray(src.sample(n, plen, seed=1)[:, :plen])}
    if jcfg.encoder is not None:
        batch["enc_embeds"] = jnp.asarray(np.random.default_rng(0).normal(
            0, 1, (n, jcfg.encoder.seq_len, jcfg.d_model)), jnp.float32)
    else:
        batch = {"embeds": jnp.asarray(np.random.default_rng(0).normal(
            0, 1, (n, plen, jcfg.d_model)), jnp.float32)}
    logits, caches = jax.jit(lambda p, b, c: jlm.prefill(p, jcfg, b, c))(
        jp, batch, jlm.init_caches(jcfg, n, plen + gen + 1))
    step = jax.jit(lambda p, x, c, i: jlm.decode_step(p, jcfg, x, c, i))
    want = [jnp.argmax(logits, -1)]
    for i in range(gen):
        logits, caches = step(jp, want[-1][:, None].astype(jnp.int32), caches, plen + i)
        want.append(jnp.argmax(logits, -1))
    res = serve_mod.serve(tcfg, batch=n, prompt_len=plen, gen=gen, device="cpu",
                          params=m["tp"])
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(want, axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_drivers_take_the_archs(arch, capsys):
    """Both command lines take the new ids: the fixed-batch loop serves
    the reduced model (--engine off; the engine's refusal surfaces from
    the default), and the train driver trains it."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    argv = ["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "8",
            "--gen", "3"]
    serve_mod.main(argv + ["--engine", "off"])
    out = capsys.readouterr().out
    assert out.startswith(f"{arch}: ")
    launches = out.split("kernel launches: ")[1].split()
    assert launches and all(kv.endswith("=0") for kv in launches), launches
    with pytest.raises(ValueError, match="decoder-only token LMs"):
        serve_mod.main(argv)
    res = train_mod.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"{arch}: ")
    assert lines[-1] == "done at step 2 (restarts=0)"
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))


def test_train_step_batch_and_encoder_training_options():
    """step_batch draws the JAX driver's per-step inputs; the FFF training
    options reach the encoder's period too."""
    from repro_torch.data import tokens as tokens_lib
    from repro_torch.launch import train as train_mod
    for arch in ARCHS:
        cfg = registry.get_config(arch).reduced()
        src = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=0)
        b = train_mod.step_batch(cfg, src, 2, 16, seed=0, i=3)
        ref = src.batch(2, 16, seed=3)
        np.testing.assert_array_equal(b["labels"], ref["labels"])
        if arch == "whisper-small":
            np.testing.assert_array_equal(b["tokens"], ref["tokens"])
            np.testing.assert_array_equal(b["enc_embeds"], np.random.default_rng(3).normal(
                0, 1, (2, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
        else:
            assert set(b) == {"embeds", "labels"}
            np.testing.assert_array_equal(b["embeds"], np.random.default_rng(3).normal(
                0, 1, (2, 16, cfg.d_model)).astype(np.float32))
    cfg = train_mod._with_fff_training_opts(registry.get_config("whisper-small"),
                                            balance=0.01, master=True)
    for b in cfg.period + cfg.encoder.period:
        assert (b.ffn.balance_scale, b.ffn.fff_master_leaf) == (0.01, True)
