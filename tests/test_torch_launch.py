"""``launch/{specs,roofline,dryrun}`` of the port against the JAX package,
on the CPU, with no memory: every tensor here lives on the meta device.

* ``lm.init(cfg, device="meta")`` has the parameter count of JAX's
  ``jax.eval_shape(lm.init)`` for every registry arch;
* ``roofline.model_flops``, ``param_counts`` and ``attention_model_flops``
  equal JAX's for every registry arch (FFF and native) x ``SHAPES`` cell,
  exactly (the same formulas over the same counts);
* ``specs.input_specs`` and ``decode_specs`` have the shapes and dtypes of
  JAX's ``jax.eval_shape`` structs (the caches layer by layer: JAX stacks
  each period position over a leading ``n_periods`` axis);
* ``dryrun.lower_cell`` once per mode (train, prefill, decode), on the
  multi-pod layout, a skipped cell and a cell with an encoder, and the
  CLI's exit code 1 on an error cell.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import utils as jutils
from repro.configs import SHAPES as JSHAPES, shape_applicable as jshape_applicable
from repro.configs import registry as jregistry
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro_torch import utils
from repro_torch.configs import SHAPES, registry, shape_applicable
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.models import lm

torch.set_num_threads(2)

ARCHS = registry.ARCH_IDS


def dtype_name(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) else jnp.dtype(d).name


def same_struct(got, want, what):
    assert tuple(got.shape) == tuple(want.shape), what
    assert got.device.type == "meta", what
    assert dtype_name(got.dtype) == dtype_name(want.dtype), what


@pytest.fixture(scope="module")
def counts():
    """Per arch: (total, embedding) parameter counts of the port's meta
    init, each held against JAX's eval_shape of its init (FFF configs)."""
    out = {}
    for arch in ARCHS:
        for ffn in ("fff", "native"):
            p = lm.init(registry.get_config(arch, ffn), device="meta")
            out[arch, ffn] = (utils.tree_size(p), utils.tree_size(p["embed"]))
        jp = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0),
                                             jregistry.get_config(arch)))
        assert out[arch, "fff"] == (jutils.tree_size(jp), jutils.tree_size(jp["embed"])), arch
    return out


@pytest.mark.parametrize("ffn", ["fff", "native"])
def test_roofline_formulas_match_jax(counts, ffn):
    for arch in ARCHS:
        tc, jc = registry.get_config(arch, ffn), jregistry.get_config(arch, ffn)
        total, embed = counts[arch, ffn]
        for mode in ("train", "prefill", "decode"):
            assert roofline.param_counts(tc, total, mode) == \
                jroofline.param_counts(jc, total, mode), (arch, mode)
        for name, shape in SHAPES.items():
            jshape = JSHAPES[name]
            assert roofline.attention_model_flops(tc, shape) == \
                jroofline.attention_model_flops(jc, jshape), (arch, name)
            assert roofline.model_flops(tc, shape, total, embed) == \
                jroofline.model_flops(jc, jshape, total, embed), (arch, name)


def test_roofline_terms_rebased_to_the_h100():
    """The same term arithmetic on the H100 data-sheet peaks."""
    c = roofline.CollectiveStats("all-reduce", 1000, 4, crosses_node=False, count=2)
    j = jroofline.CollectiveStats("all-reduce", 1000, 4, crosses_pod=False, count=2)
    assert c.bytes_moved == j.bytes_moved == 1500
    ib = roofline.CollectiveStats("all-gather", 800, 16, crosses_node=True)
    t = roofline.analyze_terms(2e12, 1.34e10, [(c, 3), (ib, 1)], 256, 1e14)
    assert t.bytes_nvlink == 9000 and t.bytes_ib == 750
    assert t.t_compute == 2e12 / 989e12 and t.t_memory == 1.34e10 / 3.35e12
    assert t.t_collective == 9000 / 900e9 + 750 / 50e9
    assert t.dominant == "memory"
    assert t.roofline_fraction == 1e14 / (256 * 989e12 * t.t_memory)
    assert t.useful_ratio == 1e14 / (2e12 * 256)


def test_input_specs_match_jax():
    for arch in ARCHS:
        tc, jc = registry.get_config(arch), jregistry.get_config(arch)
        for name in ("train_4k", "prefill_32k"):
            got = specs.input_specs(tc, SHAPES[name])
            want = jspecs.input_specs(jc, JSHAPES[name])
            assert set(got) == set(want), (arch, name)
            for k in want:
                same_struct(got[k], want[k], (arch, name, k))
        with pytest.raises(ValueError, match="decode shapes use decode_specs"):
            specs.input_specs(tc, SHAPES["decode_32k"])


@pytest.mark.parametrize("name", ["decode_32k", "long_500k"])
def test_decode_specs_match_jax(name):
    for arch in ARCHS:
        tc, jc = registry.get_config(arch), jregistry.get_config(arch)
        if not shape_applicable(tc, SHAPES[name])[0]:
            assert not jshape_applicable(jc, JSHAPES[name])[0]
            continue
        token, caches, pos = specs.decode_specs(tc, SHAPES[name])
        jtoken, jcaches, jpos = jspecs.decode_specs(jc, JSHAPES[name])
        same_struct(token, jtoken, (arch, "token"))
        same_struct(pos, jpos, (arch, "pos"))
        assert len(caches) == tc.n_layers and len(jcaches) == len(jc.period)
        for i, c in enumerate(caches):
            jcache = jcaches[i % len(jc.period)]
            assert set(c) == set(jcache), (arch, i)
            for key, jv in jcache.items():
                jfields = jv._asdict() if hasattr(jv, "_asdict") else {"": jv}
                fields = c[key]._asdict() if hasattr(c[key], "_asdict") else {"": c[key]}
                for f, want in jfields.items():
                    assert want.shape[0] == jc.n_periods, (arch, i, key, f)
                    same_struct(fields[f], jax.ShapeDtypeStruct(want.shape[1:], want.dtype),
                                (arch, i, key, f))


def test_lower_cell_per_mode():
    """A train, a prefill and a decode cell of internlm2-20b on (16, 16):
    the record's fields; a rank computes its whole batch through the whole
    model (gathered before each layer), so the counted FLOPs of all ranks
    are about the model axis (16) times the useful model FLOPs."""
    cfg = registry.get_config("internlm2-20b")
    for name, B in (("train_4k", 256 // cfg.grad_accum // 16), ("prefill_32k", 2),
                    ("decode_32k", 8)):
        rec = dryrun.lower_cell("internlm2-20b", name, multi_pod=False)
        assert rec["status"] == "ok" and rec["mesh"] == "16x16", rec
        assert rec["rank_batch"] == B and rec["fits_h100_80g"]
        assert 0.8 < rec["useful_ratio"] * 16 < 1.05, rec["useful_ratio"]
        assert rec["total_params"] == 19865575536
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["bytes_per_rank"] >= rec["param_bytes_per_rank"] > 0
        assert rec["ib_bytes_per_rank"] > 0 and rec["n_collectives"] > 0
        if name == "train_4k":
            assert "ffn_analytic" not in rec           # FORWARD_T counted
            assert rec["opt_bytes_per_rank"] > 0
        else:
            assert rec["ffn_analytic"] == ["fff"] and rec["cache_bytes_per_rank"] > 0


def test_lower_cell_layouts_and_skips():
    rec = dryrun.lower_cell("internlm2-20b", "long_500k", multi_pod=True)
    assert rec["status"] == "skipped" and rec["mesh"] == "2x16x16"
    assert rec["reason"] == jshape_applicable(jregistry.get_config("internlm2-20b"),
                                              JSHAPES["long_500k"])[1]
    rec = dryrun.lower_cell("whisper-small", "prefill_32k", multi_pod=True)
    assert rec["status"] == "ok" and rec["rank_batch"] == 1   # 32 over 32 data ranks
    one = dryrun.lower_cell("whisper-small", "prefill_32k", multi_pod=False)
    assert one["rank_batch"] == 2 and one["flops_per_rank"] > rec["flops_per_rank"]
    rec = dryrun.lower_cell("xlstm-1.3b", "long_500k", multi_pod=False)
    assert rec["status"] == "ok" and rec["rank_batch"] == 1   # batch 1: replicated
    assert rec["recurrent_scaled_from"] == 1


def test_dryrun_cli_exits_1_on_an_error_cell(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no such layout")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmoe-1b-7b", "--shape", "train_4k",
                     "--multi-pod", "single"])
    assert e.value.code == 1
    assert "0 ok, 0 skipped, 1 errors / 1 cells" in capsys.readouterr().out
