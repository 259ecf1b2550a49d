"""The port's model stack against the JAX package, on the CPU.

Configs field by field; norms, RoPE, embeddings, attention and the KV
cache on shared numpy inputs; and the 2-layer ``internlm2-20b`` FFF
``reduced`` model (float32) with the same weights in both packages
(``repro_torch.weights.from_jax``): prefill logits, decode logits and
routing stats within the ``e2e`` tolerance, and greedy generation token
for token.  The model checks run twice: under auto resolution (the
reference backend for CPU tensors) and with the resolver driven down its
CUDA branch (``api._kernels_native`` patched, so prefill takes ``cuda`` and
decode ``cuda_decode``, whose wrappers run their plain versions here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.configs import registry as jregistry
from repro.core import api as japi
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import embeddings as jemb
from repro.nn import norms as jnorms
from repro.nn import rope as jrope
from repro_torch import weights
from repro_torch.configs import registry
from repro_torch.core import api
from repro_torch.kernels import common
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm
from repro_torch.nn import attention, embeddings, norms, rope

torch.set_num_threads(2)

B, S, STEPS = 3, 12, 8
MAX_LEN = S + STEPS + 1


def t(a):
    a = np.asarray(a)
    return weights.tensor(a.astype(np.float32) if a.dtype == np.float64 else a,
                          device="cpu")


def close(got, want, kind="kernel"):
    rtol, atol = dtype_tol(jnp.float32, kind)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_config_matches_jax(cut):
    jc = jregistry.get_config("internlm2-20b")
    tc = registry.get_config("internlm2-20b")
    if cut == "reduced":
        jc, tc = jc.reduced(n_layers=2), tc.reduced(n_layers=2)
    for f in dataclasses.fields(tc):
        got, want = getattr(tc, f.name), getattr(jc, f.name)
        if f.name.endswith("_dtype"):
            assert str(got).removeprefix("torch.") == jnp.dtype(want).name
        elif f.name == "period":
            assert ([dataclasses.asdict(b) for b in got]
                    == [dataclasses.asdict(b) for b in want])
        else:
            assert got == want, f.name
    assert tc.period[0].ffn.fff_depth == (4 if cut == "full" else 3)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_match_jax():
    x = rng(0).normal(size=(2, 5, 16))
    scale = rng(1).normal(size=(16,))
    close(norms.rmsnorm({"scale": t(scale)}, t(x)),
          jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    p = {"scale": scale, "bias": rng(2).normal(size=(16,))}
    close(norms.layernorm({k: t(v) for k, v in p.items()}, t(x)),
          jnorms.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x)))


def test_rope_matches_jax():
    x = rng(3).normal(size=(2, 7, 4, 8)).astype(np.float32)
    pos = rng(4).integers(0, 100, (2, 7))
    close(rope.apply_rope(t(x), torch.from_numpy(pos), 1e6),
          jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_embed_and_logits_match_jax():
    p = {"tok": rng(5).normal(size=(32, 8)).astype(np.float32),
         "head": rng(6).normal(size=(8, 32)).astype(np.float32)}
    tok = rng(7).integers(0, 32, (2, 5))
    x = embeddings.embed({k: t(v) for k, v in p.items()}, torch.from_numpy(tok))
    close(x, jemb.embed(p, jnp.asarray(tok)))
    for params in (p, {"tok": p["tok"]}):              # untied and tied head
        got = embeddings.logits({k: t(v) for k, v in params.items()}, x)
        assert got.dtype == torch.float32
        close(got, jemb.logits(params, jnp.asarray(x.numpy())))


def test_full_attention_matches_jax():
    r = rng(8)
    q = r.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k = r.normal(size=(2, 6, 2, 8)).astype(np.float32)
    v = r.normal(size=(2, 6, 2, 8)).astype(np.float32)
    close(attention.full_attention(t(q), t(k), t(v)),
          jattn.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def _attn_cfgs():
    kw = dict(d_model=16, n_heads=4, n_kv_heads=2, head_dim=4)
    return attention.AttnConfig(**kw), jattn.AttnConfig(**kw)


def test_kv_cache_prefill_append_decode_match_jax():
    tcfg, jcfg = _attn_cfgs()
    r = rng(9)
    k = r.normal(size=(3, 5, 2, 4)).astype(np.float32)
    v = r.normal(size=(3, 5, 2, 4)).astype(np.float32)
    k1 = r.normal(size=(3, 1, 2, 4)).astype(np.float32)
    v1 = r.normal(size=(3, 1, 2, 4)).astype(np.float32)
    q1 = r.normal(size=(3, 1, 4, 4)).astype(np.float32)
    mask = np.array([True, False, True])
    tc = attention.prefill_into_cache(attention.init_cache(3, 8, tcfg), t(k), t(v))
    jc = jattn.prefill_into_cache(jattn.init_cache(3, 8, jcfg), jnp.asarray(k),
                                  jnp.asarray(v))
    tc = attention.append_to_cache(tc, t(k1), t(v1), torch.from_numpy(mask))
    jc = jattn.append_to_cache(jc, jnp.asarray(k1), jnp.asarray(v1),
                               jnp.asarray(mask))
    for got, want in zip(tc, jc):
        close(got, want)
    close(attention.decode_attend(t(q1), tc),
          jattn.decode_attend(jnp.asarray(q1), jc))


def test_chunk_into_cache_matches_jax():
    tcfg, jcfg = _attn_cfgs()
    r = rng(10)
    k = r.normal(size=(3, 4, 2, 4)).astype(np.float32)
    valid = np.array([4, 0, 2], np.int32)
    tc = attention.init_cache(3, 6, tcfg)._replace(
        length=torch.tensor([1, 2, 5], dtype=torch.int32))
    jc = jattn.init_cache(3, 6, jcfg)._replace(length=jnp.array([1, 2, 5]))
    tc = attention.chunk_into_cache(tc, t(k), t(-k), torch.from_numpy(valid))
    jc = jattn.chunk_into_cache(jc, jnp.asarray(k), jnp.asarray(-k),
                                jnp.asarray(valid))
    for got, want in zip(tc, jc):                      # row 2 overflows: dropped
        close(got, want)


# ---------------------------------------------------------------------------
# the 2-layer internlm2-20b FFF model, same weights in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jregistry.get_config("internlm2-20b").reduced(n_layers=2)
    tcfg = registry.get_config("internlm2-20b").reduced(n_layers=2)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = rng(11)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 8.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    tp = weights.from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                          device="cpu")
    prompt = r.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    tok = r.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)

    prefill = jax.jit(lambda p, x, c: jlm.prefill(p, jcfg, {"tokens": x}, c))
    jl, jc = prefill(jp, jnp.asarray(prompt), jlm.init_caches(jcfg, B, MAX_LEN))
    with japi.collect_routing():
        jd, _, jstats = jax.jit(lambda p, x, c: jlm.decode_step(
            p, jcfg, x, c, S, with_stats=True))(jp, jnp.asarray(tok), jc)
    jgen = jax.jit(lambda p, x: jlm.generate(p, jcfg, x, STEPS, MAX_LEN))(
        jp, jnp.asarray(prompt))
    return dict(tcfg=tcfg, tp=tp, jp=jp, prompt=prompt, tok=tok,
                prefill=np.asarray(jl), decode=np.asarray(jd),
                counts=np.asarray(jstats[0].leaf_counts),
                generate=np.asarray(jgen))


@pytest.fixture(params=["auto", "kernels"])
def resolution(request, monkeypatch):
    """auto: CPU tensors resolve to the reference backend.  kernels: the
    resolver takes its CUDA branch, and every backend call is recorded."""
    ran = []
    for key, fn in list(api._REGISTRY.items()):
        monkeypatch.setitem(api._REGISTRY, key,
                            lambda *a, _fn=fn, _n=key[1]: (ran.append(_n), _fn(*a))[1])
    if request.param == "kernels":
        monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    yield request.param, ran
    want = {"cuda", "cuda_decode"} if request.param == "kernels" else {"reference"}
    assert set(ran) == want, set(ran)


def test_prefill_and_decode_logits_match_jax(model, resolution):
    cfg, params = model["tcfg"], model["tp"]
    caches = lm.init_caches(cfg, B, MAX_LEN, device="cpu")
    with torch.inference_mode():
        logits, caches = lm.prefill(params, cfg,
                                    {"tokens": torch.from_numpy(model["prompt"])},
                                    caches)
        close(logits, model["prefill"], kind="e2e")
        with api.collect_routing():
            logits, caches, stats = lm.decode_step(
                params, cfg, torch.from_numpy(model["tok"]), caches, S,
                with_stats=True)
    close(logits, model["decode"], kind="e2e")
    np.testing.assert_array_equal(stats[0].leaf_counts.numpy(), model["counts"])
    assert float(stats[0].slots) == B * cfg.n_layers
    assert float(stats[0].overflow) == 0.0


def test_generate_matches_jax(model, resolution):
    with torch.inference_mode():
        got = lm.generate(model["tp"], model["tcfg"],
                          torch.from_numpy(model["prompt"]), STEPS, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), model["generate"])


@pytest.mark.parametrize("backend,seq", [("cuda", S), ("cuda_decode", 1)])
def test_kernel_backend_overrides_match_jax(model, backend, seq):
    """overrides(backend=...) steers every FFF site, whatever the shape."""
    cfg, params = model["tcfg"], model["tp"]
    caches = lm.init_caches(cfg, B, MAX_LEN, device="cpu")
    with api.overrides(backend=backend, mode="infer"), torch.inference_mode():
        logits, caches = lm.prefill(params, cfg,
                                    {"tokens": torch.from_numpy(model["prompt"])},
                                    caches)
        dec, _ = lm.decode_step(params, cfg, torch.from_numpy(model["tok"]),
                                caches, S)
        gen = lm.generate(params, cfg, torch.from_numpy(model["prompt"]),
                          STEPS, MAX_LEN)
    close(logits, model["prefill"], kind="e2e")
    close(dec, model["decode"], kind="e2e")
    np.testing.assert_array_equal(gen.numpy(), model["generate"])


def test_weights_bridge_layout(model):
    jp, tp, cfg = model["jp"], model["tp"], model["tcfg"]
    assert len(tp["stack"]) == cfg.n_layers
    for i, layer in enumerate(tp["stack"]):
        np.testing.assert_array_equal(
            layer["ffn"]["leaf_wg"].numpy(),
            np.asarray(jp["stack"][0]["ffn"]["leaf_wg"][i]))
        np.testing.assert_array_equal(
            layer["mixer"]["wq"].numpy(), np.asarray(jp["stack"][0]["mixer"]["wq"][i]))
    bf = np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))
    got = weights.tensor(bf, device="cpu")
    assert got.dtype == torch.bfloat16 and got.float().tolist() == [1.5, -2.25]


def test_serve_loop_on_cpu(model):
    cfg, params = model["tcfg"], model["tp"]
    res = serve_mod.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu",
                          params=params)
    from repro_torch.data import tokens as tokens_lib
    prompt = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=0).sample(
        2, 8, seed=1)[:, :8]
    with torch.inference_mode():
        want = lm.generate(params, cfg, torch.from_numpy(prompt), 4, 8 + 4 + 1)
    np.testing.assert_array_equal(res.tokens[:, :4].numpy(), want[:, 8:].numpy())
    assert res.tokens.shape == (2, 5) and len(res.decode_s) == 4
    assert res.steady.n == 3 and res.tokens_per_s > 0
    assert set(res.launches.values()) == {0}           # CPU: no kernel launched
    assert set(res.launches) == set(common.KERNELS)


def test_serve_eos_pins_finished_rows(model):
    cfg, params = model["tcfg"], model["tp"]
    first = serve_mod.serve(cfg, batch=2, prompt_len=8, gen=3, device="cpu",
                            params=params).tokens
    eos = int(first[0, 0])
    res = serve_mod.serve(cfg, batch=2, prompt_len=8, gen=3, eos_id=eos,
                          device="cpu", params=params)
    assert bool((res.tokens[0] == eos).all())
    if int(first[1, 0]) != eos:                        # row 1 still decodes
        assert res.step_tokens[0] == 1


def test_serve_cli_on_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--engine", "off", "--batch", "2",
                    "--prompt-len", "8", "--gen", "2", "--fff-backend", "cuda"])
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "kernel launches:" in out
