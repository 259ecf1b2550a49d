"""The registry archs against the JAX package, on the CPU:
phi3-medium-14b, starcoder2-15b (LayerNorm, attention biases, GELU leaves,
a sliding window), command-r-35b (tied embeddings, rope_theta 8e6),
olmoe-1b-7b (an FFF forest of 8 trees; ``native`` is the noisy top-k MoE),
kimi-k2-1t-a32b (a forest of 8 trees of depth 6 from 384 experts;
head_dim 112), jamba-1.5-large-398b (a period of seven Mamba blocks and
one attention block, MoE and dense sites alternating, so two FFF site
configs in one model) and xlstm-1.3b (mLSTM and sLSTM blocks, no FFN
site, no positional embedding).

* the registry's ids (the JAX registry's, in its order), and
  ``get_config(arch, ffn)`` and ``reduced()`` equal to JAX's field for
  field for every arch and FFN kind (whisper-small's ``EncoderSpec`` and
  internvl2-26b's frontend too; ``tests/test_torch_encdec.py`` holds their
  models), with the FFN sites' training and active widths;
* for each new arch, FFF and native, the 2-layer ``reduced()`` float32
  model with the same numpy-drawn weights in both packages
  (``weights.from_jax``): ``lm.loss_fn``'s loss, metrics and every
  parameter gradient within the ``e2e`` tolerance of ``tests/conftest.py``;
  and a prefill of 2 x 20 tokens plus two ``decode_step``s fed the greedy
  tokens, logits within ``e2e`` and the same greedy tokens.  FFF models run
  twice: under auto resolution (the reference backend for CPU tensors) and
  down the resolver's CUDA branch (``api._kernels_native`` patched: the
  prefill takes the grouped kernel path, decode the fused decode kernel,
  whose wrappers run their plain versions here).  ``reduced()`` rounds
  jamba and xlstm up to one whole period of 8 layers;
* the engine refuses the recurrent archs with the JAX package's message,
  the cache helpers leave recurrent state alone or refuse it, and both
  drivers take the new ``--arch`` ids (the fixed-batch loop serves jamba
  and xlstm; the train driver trains all three, reduced).
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
from repro_torch import optim, utils, weights
from repro_torch.configs import registry
from repro_torch.core import api
from repro_torch.models import lm

torch.set_num_threads(2)

NEW_ARCHS = ("phi3-medium-14b", "starcoder2-15b", "command-r-35b", "olmoe-1b-7b",
             "kimi-k2-1t-a32b", "jamba-1.5-large-398b", "xlstm-1.3b")
RECURRENT = ("jamba-1.5-large-398b", "xlstm-1.3b")
B, S, STEPS = 2, 20, 2
# each arch's draw seed: its index here (the ids registered before the
# encoder and frontend archs, so their arrival leaves these draws as they were)
SEEDED = sorted(NEW_ARCHS + ("internlm2-20b",))


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, kind="e2e"):
    rtol, atol = dtype_tol(jnp.float32, kind)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_ids():
    """Every arch of the JAX registry, in its order (the encoder and
    frontend archs too)."""
    assert set(registry.ARCH_IDS) == set(NEW_ARCHS) | {
        "internlm2-20b", "whisper-small", "internvl2-26b"}
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("paper-vit")


def same_fields(tc, jc):
    """The port's config has JAX's fields, each equal (dtypes by name; the
    period's blocks and the encoder spec as dicts, since the two packages'
    dataclasses never compare equal)."""
    assert ([f.name for f in dataclasses.fields(tc)]
            == [f.name for f in dataclasses.fields(jc)])
    for f in dataclasses.fields(tc):
        got, want = getattr(tc, f.name), getattr(jc, f.name)
        if f.name.endswith("_dtype"):
            assert str(got).removeprefix("torch.") == jnp.dtype(want).name, f.name
        elif f.name == "period":
            assert ([dataclasses.asdict(b) for b in got]
                    == [dataclasses.asdict(b) for b in want])
        elif f.name == "encoder":
            assert (got is None) == (want is None), f.name
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name


@pytest.mark.parametrize("cut", ["full", "reduced"])
@pytest.mark.parametrize("ffn", ["fff", "native", "dense"])
@pytest.mark.parametrize("arch", sorted(registry.ARCH_IDS))
def test_config_matches_jax(arch, ffn, cut):
    jc, tc = jregistry.get_config(arch, ffn), registry.get_config(arch, ffn)
    if cut == "reduced":
        jc, tc = jc.reduced(n_layers=2), tc.reduced(n_layers=2)
    same_fields(tc, jc)
    for tb, jb in zip(tc.period, jc.period):
        assert tb.ffn.training_width == jb.ffn.training_width
        assert tb.ffn.active_width == jb.ffn.active_width


def test_olmoe_sites():
    """FFF: a forest of 8 trees of depth 3 with 1024-wide leaves, trained
    straight-through; native: 64 experts, top 8; the same active width."""
    f = registry.get_config("olmoe-1b-7b").period[0].ffn
    m = registry.get_config("olmoe-1b-7b", "native").period[0].ffn
    assert (f.kind, f.fff_trees, f.fff_depth, f.fff_leaf_width, f.fff_st) == (
        "fff", 8, 3, 1024, True)
    assert (m.kind, m.moe_experts, m.moe_top_k, m.d_ff) == ("moe", 64, 8, 1024)
    assert f.active_width == m.active_width == 8 * 1024
    assert f.training_width == m.training_width == 64 * 1024


def test_slice11_sites():
    """kimi: a forest of 8 trees of depth 6 with 2048-wide leaves from 384
    experts, top 8; jamba: the MoE sites a forest of 2 trees of depth 3 x
    24576, the dense sites one tree of 16 x 1536, attention at position 7;
    xlstm: no FFN site and no positions.  kimi and jamba record ZeRO-3."""
    f = registry.get_config("kimi-k2-1t-a32b").period[0].ffn
    m = registry.get_config("kimi-k2-1t-a32b", "native").period[0].ffn
    assert (f.kind, f.fff_trees, f.fff_depth, f.fff_leaf_width, f.fff_st) == (
        "fff", 8, 6, 2048, True)
    assert (m.kind, m.moe_experts, m.moe_top_k, m.d_ff) == ("moe", 384, 8, 2048)
    assert f.active_width == m.active_width
    jamba = registry.get_config("jamba-1.5-large-398b")
    assert [b.mixer for b in jamba.period] == ["mamba"] * 7 + ["attn"]
    sites = [(b.ffn.fff_trees, b.ffn.fff_depth, b.ffn.fff_leaf_width, b.ffn.fff_st)
             for b in jamba.period]
    assert sites == [(2, 3, 24576, True), (1, 4, 1536, False)] * 4
    xl = registry.get_config("xlstm-1.3b")
    assert xl == registry.get_config("xlstm-1.3b", "native")
    assert [b.mixer for b in xl.period] == ["mlstm"] * 7 + ["slstm"]
    assert {b.ffn.kind for b in xl.period} == {"none"} and xl.pos_emb == "none"
    assert [registry.get_config(a).zero_stage for a in
            ("kimi-k2-1t-a32b", "jamba-1.5-large-398b", "xlstm-1.3b")] == [3, 3, 1]


# ---------------------------------------------------------------------------
# the reduced models, same weights in both packages
# ---------------------------------------------------------------------------

_MODELS = {}


def model(arch, ffn):
    """The reduced configs, the port's params (JAX's carried over), the
    prompt and batch and the JAX oracles, built once per (arch, ffn): the
    loss, metrics and gradients on one batch, and the prefill and greedy
    decode logits."""
    jcfg = jregistry.get_config(arch, ffn).reduced(n_layers=2)
    tcfg = registry.get_config(arch, ffn).reduced(n_layers=2)
    key = (arch, tcfg)          # xlstm's FFF config is its native one
    if key in _MODELS:
        return _MODELS[key]
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = rng(SEEDED.index(arch))

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 8.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    if arch == "xlstm-1.3b":
        # the JAX package's own init (forget-gate bias 3, unit GroupNorm
        # scales): under the draw above the loss's gradient is too
        # ill-conditioned for float32 (1e-7 relative parameter noise moves
        # it by 5e-3 in either package; 8e-4 under this init, where the two
        # packages differ by 3e-4)
        jp = jax.jit(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))()
    tp = weights.from_jax(np_tree(jp), tcfg, device="cpu")
    prompt = r.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(jp, batch)
    max_len = S + STEPS + 1
    logits, caches = jax.jit(lambda p, x, c: jlm.prefill(p, jcfg, {"tokens": x}, c))(
        jp, jnp.asarray(prompt), jlm.init_caches(jcfg, B, max_len))
    step = jax.jit(lambda p, x, c, i: jlm.decode_step(p, jcfg, x, c, i))
    seq = [np.asarray(logits)]
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, caches = step(jp, tok, caches, S + i)
        seq.append(np.asarray(logits))
    _MODELS[key] = dict(jcfg=jcfg, tcfg=tcfg, tp=tp, prompt=prompt, batch=batch,
                        loss=loss, metrics=metrics, grads=np_tree(grads), logits=seq)
    return _MODELS[key]


@pytest.mark.parametrize("ffn", ["fff", "native"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_weights_carry_over(arch, ffn):
    """from_jax carries every leaf of the arch's tree with no special case:
    LayerNorm and attention biases, tied embeddings, MoE experts and gates,
    and the forest's per-tree leaves."""
    m = model(arch, ffn)
    tcfg, tp = m["tcfg"], m["tp"]
    fresh = lm.init(tcfg, seed=0, device="cpu")
    assert len(utils.tree_leaves(tp)) == len(utils.tree_leaves(fresh))
    utils.tree_map(lambda a, b: None if a.shape == b.shape and a.dtype == b.dtype
                   else pytest.fail(f"{a.shape} {a.dtype} != {b.shape} {b.dtype}"),
                   tp, fresh)
    layer = tp["stack"][0]
    assert ("head" in tp["embed"]) != tcfg.tie_embeddings
    assert ("bias" in layer["norm1"]) == (tcfg.norm == "layernorm")
    assert ("bq" in layer["mixer"]) == tcfg.attn_bias
    assert ("gate_w" in layer.get("ffn", {})) == (tcfg.period[0].ffn.kind == "moe")
    assert set(layer["mixer"]) == set(fresh["stack"][0]["mixer"])


@pytest.mark.parametrize("ffn", ["fff", "native"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_fn_matches_jax(arch, ffn):
    """Loss, every metric (moe_aux for the MoE) and every parameter
    gradient."""
    m = model(arch, ffn)
    (loss, metrics), grads = optim.value_and_grad(
        lambda p, b: lm.loss_fn(p, m["tcfg"], b))(m["tp"], m["batch"])
    close(loss, m["loss"])
    assert set(metrics) == set(m["metrics"])
    for k in metrics:
        close(metrics[k], m["metrics"][k])
    if (arch, ffn) == ("olmoe-1b-7b", "native"):
        assert float(metrics["moe_aux"]) > 0
    want = weights.from_jax(m["grads"], m["tcfg"], device="cpu")
    assert len(utils.tree_leaves(grads)) == len(utils.tree_leaves(want))
    utils.tree_map(lambda g, w: close(g, w.numpy()), grads, want)


@pytest.mark.parametrize("resolution", ["auto", "kernels"])
@pytest.mark.parametrize("ffn", ["fff", "native"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch, ffn, resolution, monkeypatch):
    m = model(arch, ffn)
    tcfg = m["tcfg"]
    ran = []
    for key, fn in list(api._REGISTRY.items()):
        monkeypatch.setitem(api._REGISTRY, key,
                            lambda *a, _fn=fn, _n=key[1]: (ran.append(_n), _fn(*a))[1])
    if resolution == "kernels":
        monkeypatch.setattr(api, "_kernels_native", lambda device: True)
    caches = lm.init_caches(tcfg, B, S + STEPS + 1, device="cpu")
    with torch.inference_mode():
        logits, caches = lm.prefill(m["tp"], tcfg,
                                    {"tokens": torch.from_numpy(m["prompt"])}, caches)
        close(logits, m["logits"][0])
        for i in range(STEPS):
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            np.testing.assert_array_equal(tok[:, 0].numpy(), m["logits"][i].argmax(-1))
            logits, caches = lm.decode_step(m["tp"], tcfg, tok, caches, S + i)
            close(logits, m["logits"][i + 1])
    has_fff = any(b.ffn.kind == "fff" for b in tcfg.period)
    want = (set() if not has_fff else
            {"cuda", "cuda_decode"} if resolution == "kernels" else {"reference"})
    assert set(ran) == want, set(ran)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ffn", ["fff", "native"])
def test_drivers_serve_and_train_olmoe(ffn, capsys):
    """The train driver defaults to olmoe-1b-7b, as the JAX driver does;
    --ffn native trains the MoE (its balancing loss in the step's loss)
    and serves it through the fixed-batch loop and the engine."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    assert train_mod.build_parser().get_default("arch") == "olmoe-1b-7b"
    res = train_mod.main(["--reduced", "--ffn", ffn, "--steps", "2", "--batch", "2",
                          "--seq", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("olmoe-1b-7b: ")
    assert lines[-1] == "done at step 2 (restarts=0)"
    assert all(np.isfinite(res.losses))
    ffn_params = res.params["stack"][0]["ffn"]
    assert ("expert_w1" in ffn_params) == (ffn == "native")
    assert (res.metrics[0]["moe_aux"] > 0) == (ffn == "native")
    for engine in ("off", "continuous"):
        serve_mod.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--ffn", ffn,
                        "--engine", engine, "--batch", "2", "--prompt-len", "8",
                        "--gen", "3", "--spec-k", "2"])
        out = capsys.readouterr().out
        assert out.startswith("olmoe-1b-7b: ") and "kernel launches:" in out


@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_refuses_recurrent_mixers(arch):
    """Both packages' engines refuse a model with a recurrent mixer: padded
    prefill is length-masked, recurrent state is not."""
    from repro.serving import engine as jengine
    from repro_torch.serving import engine
    tcfg = registry.get_config(arch).reduced()
    with pytest.raises(ValueError, match="requires attention mixers") as got:
        engine.ContinuousBatchingEngine(None, tcfg, engine.EngineConfig(device="cpu"))
    with pytest.raises(ValueError, match="requires attention mixers") as want:
        jengine.ContinuousBatchingEngine(None, jregistry.get_config(arch).reduced(),
                                         jengine.EngineConfig())
    assert str(got.value) == str(want.value)


def test_cache_helpers_and_recurrent_state():
    """set_cache_lengths moves only the attention layer's length (the
    Mamba layers' state is left as it is); cache_admit refuses."""
    tcfg = registry.get_config("jamba-1.5-large-398b").reduced()
    caches = lm.init_caches(tcfg, B, 16, device="cpu")
    assert [list(c) for c in caches] == [["mamba"]] * 7 + [["kv"]]
    moved = lm.set_cache_lengths(caches, torch.tensor([3, 5]))
    assert moved[7]["kv"].length.tolist() == [3, 5]
    assert all(moved[i]["mamba"] is caches[i]["mamba"] for i in range(7))
    with pytest.raises(ValueError, match="attention KV caches"):
        lm.cache_admit(caches, torch.tensor([True, False]))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b"] + list(RECURRENT))
def test_drivers_take_slice11_archs(arch, capsys):
    """--arch takes the new ids in both drivers: the train driver trains
    the reduced model; the fixed-batch loop serves it, and the engine's
    refusal of a recurrent model surfaces from the serve driver."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    res = train_mod.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"{arch}: ")
    assert lines[-1] == "done at step 2 (restarts=0)"
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    argv = ["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "8",
            "--gen", "3"]
    serve_mod.main(argv + ["--engine", "off"])
    out = capsys.readouterr().out
    assert out.startswith(f"{arch}: ") and "kernel launches:" in out
    if arch in RECURRENT:
        with pytest.raises(ValueError, match="requires attention mixers"):
            serve_mod.main(argv)


def test_initializers_slice_above_the_threshold(monkeypatch):
    """Tensors above SLICED_INIT_ABOVE elements (kimi-k2's 7.5e9-element
    leaf weights) are drawn one slice of the first axis at a time, each
    slice the draw its own shape would get; smaller ones keep one draw."""
    monkeypatch.setattr(utils, "SLICED_INIT_ABOVE", 100)
    for draw, args in ((utils.truncated_init, (0.5,)), (utils.he_normal, ()),
                       (utils.lecun_normal, ())):
        whole = draw(torch.Generator().manual_seed(0), (3, 8, 8), *args, torch.bfloat16)
        gen = torch.Generator().manual_seed(0)
        slices = [draw(gen, (8, 8), *args, torch.bfloat16) for _ in range(3)]
        assert whole.dtype == torch.bfloat16 and whole.shape == (3, 8, 8)
        assert torch.equal(whole, torch.stack(slices))
        small = draw(torch.Generator().manual_seed(0), (1, 8, 8), *args)
        gen = torch.Generator().manual_seed(0)
        assert torch.equal(small[0], draw(gen, (8, 8), *args))
