"""The ported examples (``examples/*_torch.py``), each through its ``main``
at its smallest size on the CPU, where every kernel wrapper runs its plain
version: the quickstart, the kernel-path serving check (whose own
assertion holds the ``cuda`` backend to the reference), the LM trainer
with checkpoint and restart, and the paper's Table-3 ViT.  Each defaults
to the card and refuses to run without one."""
import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart_torch", "serve_fff_kernels_torch", "train_lm_fff_torch",
            "vit_cifar_fff_torch")


def example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    out = example("quickstart_torch").main(["--steps", "3", "--device", "cpu"])
    # the example's leaves carry biases: auto serves them exactly
    assert out["backend"] == "reference" and out["max_abs_err"] == 0.0
    assert out["routing_agreement"] == 1.0 and sum(out["leaf_histogram"]) == 1024
    assert 0.0 <= out["accuracy"] <= 1.0 and out["bf16_agreement"] > 0.9
    assert "hard-inference accuracy" in capsys.readouterr().out


def test_serve_fff_kernels():
    out = example("serve_fff_kernels_torch").main(["--device", "cpu"])
    assert out["routing_agreement"] > 0.99 and out["max_abs_err"] < 1e-4
    assert out["decode_max_abs_err"] < 1e-4 and out["skew"] >= 1.0


def test_train_lm_checkpoints_and_resumes(tmp_path, capsys):
    mod = example("train_lm_fff_torch")
    argv = ["--small", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    res = mod.main(argv + ["--steps", "2"])
    assert (res.step, res.restarts) == (2, 0)
    again = mod.main(argv + ["--steps", "3"])
    assert again.step == 3
    out = capsys.readouterr().out
    assert out.count("finished at step") == 2 and "step    0  ce" in out
    assert out.count("greedy sample:") == 2


def test_vit_table3_rows(capsys):
    rows = example("vit_cifar_fff_torch").main(["--steps", "1", "--leaves", "1",
                                                "--device", "cpu"])
    assert [(r["model"], r["leaf"], r["depth"], r["inf_width"], r["train_size"])
            for r in rows] == [("ff", 0, 0, 128, 128), ("fff", 1, 7, 1, 255)]
    assert all(0.0 <= r["ga"] <= 1.0 for r in rows) and rows[1]["speedup"] > 0
    assert "ffn speedup" in capsys.readouterr().out


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_card(name):
    """Without --device the examples run on the card; on a host without
    one they refuse instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    argv = {"train_lm_fff_torch": ["--small", "--steps", "1"],
            "vit_cifar_fff_torch": ["--steps", "1", "--leaves", "1"]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main(argv)
