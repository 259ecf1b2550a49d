"""The port stands alone: ``src/repro_torch/`` and ``chip_smoke.py`` import
neither JAX, ``ml_dtypes`` nor anything of the JAX package, entry points
never fall back to the CPU behind the caller's back, and every kernel
names the Pallas kernel it replaces."""
import ast
import os
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import registry
from repro_torch.kernels import common
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch import weights

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tools" / "kernel_ab.py"]
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch."))
#: the training slice's modules, which the walk above must find
TRAINING_MODULES = ("repro_torch.optim", "repro_torch.optim.accum",
                    "repro_torch.optim.adamw", "repro_torch.optim.common",
                    "repro_torch.optim.schedules", "repro_torch.optim.sgd",
                    "repro_torch.launch.train")
#: the checkpoint/restart slice's modules and the dense baseline's
CHECKPOINT_MODULES = ("repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
                      "repro_torch.checkpoint.manager",
                      "repro_torch.checkpoint.elastic",
                      "repro_torch.distributed.fault",
                      "repro_torch.distributed.straggler",
                      "repro_torch.core.ff", "repro_torch.core.regions",
                      "repro_torch.data.synthetic", "repro_torch.data.pipeline")


def test_every_module_imports_without_jax():
    """Each module imports in a fresh interpreter where ``jax``,
    ``ml_dtypes`` and ``repro`` cannot be imported at all."""
    code = ("import sys\n"
            "for m in ('jax', 'ml_dtypes', 'repro'): sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "print('ok', len(sys.modules))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert set(TRAINING_MODULES) <= set(MODULES)
    assert set(CHECKPOINT_MODULES) <= set(MODULES)
    assert len(MODULES) >= 67


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro", "flax")]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_default_to_the_card():
    """Without device=, an entry point asks for CUDA and raises here rather
    than quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = registry.get_config("internlm2-20b").reduced(n_layers=1)
    for call in (lambda: lm.init(cfg),
                 lambda: lm.init_caches(cfg, 1, 8),
                 lambda: serve_mod.serve(cfg, batch=1, prompt_len=4, gen=1),
                 lambda: train_mod.train(cfg, steps=1, batch=1, seq=4),
                 lambda: weights.tensor(np.ones(1, np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common._nvcc()


def test_every_kernel_names_the_pallas_kernel_it_replaces():
    import repro_torch.core.api  # noqa: F401  (registers every kernel)
    assert set(common.KERNELS) == {"tree_router", "grouped_matmul",
                                   "grouped_matmul_dual", "fused_forest_decode",
                                   "gathered_matmul", "gathered_matmul_dual"}
    for k in common.KERNELS.values():
        src = common.CSRC / k.source
        assert src.is_file() and f"extern \"C\" int {k.symbol}(" in src.read_text()
        assert "Replaces repro/kernels/" in src.read_text()
        # the ctypes signature matches the C one, pointer for pointer: a
        # mismatch would only show on the card
        text = src.read_text()
        start = text.index(f'extern "C" int {k.symbol}(') + len(k.symbol) + 16
        params = [p.strip() for p in text[start:text.index(")", start)].split(",")]
        assert [("*" in p) for p in params] == [
            t is common.P for t in k.argtypes], (k.name, params)
        path, line = k.replaces.rsplit(":", 1)
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert "pallas_call" in text, (k.name, text)
