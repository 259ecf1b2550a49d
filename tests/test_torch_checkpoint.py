"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

* A tree of float32, bfloat16, float8, int32 and Python-int leaves in
  nested dicts and lists with an ``AdamWState``, and an ``fff.init`` tree,
  written by either package restore in the other bit for bit, one shard or
  one shard a leaf; both packages write the same manifest for the same
  tree.  A JAX LM tree (stacked over periods) does not restore into the
  port's (one dict a layer): nothing is reshaped.
* The manager: keep-k retention, atomic commits (a stale ``step_N.tmp`` is
  never listed or restored), an asynchronous save is a snapshot of the
  state when ``save`` returned (the tree is mutated in place while the
  write waits), and the writer thread's error surfaces at ``wait`` and at
  the next ``save``.
* ``reshard_restore`` without a mesh, and its refusal of one.
"""
import json
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.core import fff as jfff
from repro.models import lm as jlm
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch import checkpoint, optim, utils, weights
from repro_torch.checkpoint import ckpt, manager as manager_mod
from repro_torch.configs import registry
from repro_torch.core import fff
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWState

torch.set_num_threads(2)

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
                 "float8_e5m2": torch.float8_e5m2}


def rng(seed):
    return np.random.default_rng(seed)


def mixed_np(seed):
    """The test tree as numpy: float32, int32, and raw bits (uint16/uint8)
    for the bfloat16 and float8 leaves, so both packages hold the same bits."""
    r = rng(seed)
    return {
        "params": {
            "w": r.normal(size=(3, 4)).astype(np.float32),
            "b": ("bfloat16", r.integers(0, 2 ** 16, (4,), dtype=np.uint16)),
            "layers": [{"k": r.integers(-9, 9, (2,), dtype=np.int32),
                        "s": ("float8_e4m3fn", r.integers(0, 256, (5,), dtype=np.uint8))},
                       {"k": r.integers(-9, 9, (2,), dtype=np.int32),
                        "s": ("float8_e5m2", r.integers(0, 256, (5,), dtype=np.uint8))}],
        },
        "opt": ("adamw", 7, {"w": r.normal(size=(3, 4)).astype(np.float32)},
                {"w": r.random((3, 4)).astype(np.float32)}),
    }


def as_jax(node):
    if isinstance(node, dict):
        return {k: as_jax(v) for k, v in node.items()}
    if isinstance(node, list):
        return [as_jax(v) for v in node]
    if isinstance(node, tuple) and node[0] == "adamw":
        return JAdamWState(jnp.asarray(node[1], jnp.int32), as_jax(node[2]),
                                 as_jax(node[3]))
    if isinstance(node, tuple):
        return jnp.asarray(node[1].view(getattr(ml_dtypes, node[0])))
    return jnp.asarray(node)


def as_torch(node):
    if isinstance(node, dict):
        return {k: as_torch(v) for k, v in node.items()}
    if isinstance(node, list):
        return [as_torch(v) for v in node]
    if isinstance(node, tuple) and node[0] == "adamw":
        return AdamWState(node[1], as_torch(node[2]), as_torch(node[3]))
    if isinstance(node, tuple):
        return torch.from_numpy(node[1].copy()).view(_TORCH_DTYPES[node[0]])
    return torch.from_numpy(node.copy())


def jax_bits(leaf) -> np.ndarray:
    a = np.asarray(leaf)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8) \
        if a.dtype.name in _TORCH_DTYPES else a


def torch_bits(leaf) -> np.ndarray:
    if isinstance(leaf, int):                 # the AdamW step: saved as int32
        return np.asarray(leaf, np.int32)
    if leaf.dtype in _TORCH_DTYPES.values():
        return leaf.view(torch.uint16 if leaf.element_size() == 2 else torch.uint8).numpy()
    return leaf.numpy()


def assert_same_bits(port_tree, jax_tree):
    got = list(ckpt.flatten_with_paths(port_tree))
    want = [(k, leaf) for k, leaf in ckpt.flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jax_tree))]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        gb, wb = torch_bits(g), jax_bits(w)
        assert gb.shape == wb.shape and gb.tobytes() == wb.tobytes(), key


def fff_trees(seed):
    jcfg = jfff.FFFConfig(dim_in=8, dim_out=8, depth=2, leaf_width=4,
                          activation="swiglu", trees=2, param_dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jfff.init(jax.random.PRNGKey(0), jcfg))
    r = rng(seed)
    jp = jax.tree_util.tree_map(
        lambda s: jnp.asarray(r.normal(size=s.shape), s.dtype), shapes)
    tcfg = fff.FFFConfig(dim_in=8, dim_out=8, depth=2, leaf_width=4,
                         activation="swiglu", trees=2, param_dtype=torch.bfloat16)
    like = fff.init(torch.Generator().manual_seed(0), tcfg)
    return jp, like


TREES = {
    "mixed": lambda: (as_jax(mixed_np(1)), as_torch(mixed_np(2))),
    "fff": lambda: fff_trees(3),
}


@pytest.mark.parametrize("max_shard_mb", [512, 0])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_jax_checkpoint_restores_in_the_port(tmp_path, tree, max_shard_mb):
    """JAX save_tree -> port restore_tree into a tree of other values:
    every leaf bit-identical, the AdamW step a Python int again."""
    jtree, like = TREES[tree]()
    jckpt.save_tree(str(tmp_path), jtree, step=5, meta={"tag": tree},
                    max_shard_mb=max_shard_mb)
    got, step, meta = checkpoint.restore_tree(str(tmp_path), like)
    assert step == 5 and meta == {"tag": tree}
    assert_same_bits(got, jtree)
    if tree == "mixed":
        assert isinstance(got["opt"], AdamWState) and got["opt"].step == 7
        assert type(got["opt"].step) is int
        assert got["params"]["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("max_shard_mb", [512, 0])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_port_checkpoint_restores_in_jax(tmp_path, tree, max_shard_mb):
    """Port save_tree -> JAX restore_tree: every leaf bit-identical, and
    the port writes the manifest JAX writes for the same tree."""
    jtree, _ = TREES[tree]()
    port_tree = (as_torch(mixed_np(1)) if tree == "mixed" else
                 weights.tree(jax.tree_util.tree_map(np.asarray, jtree), device="cpu"))
    checkpoint.save_tree(str(tmp_path / "port"), port_tree, step=5,
                         meta={"tag": tree}, max_shard_mb=max_shard_mb)
    jckpt.save_tree(str(tmp_path / "jax"), jtree, step=5, meta={"tag": tree},
                    max_shard_mb=max_shard_mb)
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    got, step, meta = jckpt.restore_tree(str(tmp_path / "port"), like)
    assert step == 5 and meta == {"tag": tree}
    assert_same_bits(port_tree, got)


def test_int_leaves_and_restore_types(tmp_path):
    """A Python int is a 0-d int32 (int64 past its range) and comes back an
    int; a leaf comes back in its counterpart's dtype."""
    tree = {"small": 3, "big": 2 ** 40, "t": torch.arange(4, dtype=torch.float32),
            "n": np.arange(3, dtype=np.int64)}
    checkpoint.save_tree(str(tmp_path), tree)
    leaves = {l["key"]: l["dtype"] for l in json.loads(
        (tmp_path / "manifest.json").read_text())["leaves"]}
    assert leaves == {"big": "int64", "n": "int64", "small": "int32", "t": "float32"}
    like = {"small": 0, "big": 0, "t": torch.zeros(4, dtype=torch.bfloat16),
            "n": torch.zeros(3, dtype=torch.int32)}
    got, _, _ = checkpoint.restore_tree(str(tmp_path), like)
    assert got["small"] == 3 and got["big"] == 2 ** 40 and type(got["big"]) is int
    assert got["t"].dtype == torch.bfloat16 and got["t"].tolist() == [0, 1, 2, 3]
    assert got["n"].dtype == torch.int32 and got["n"].tolist() == [0, 1, 2]


def test_restore_refuses_missing_keys_and_other_shapes(tmp_path):
    checkpoint.save_tree(str(tmp_path), {"w": torch.zeros(2, 3)})
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        checkpoint.restore_tree(str(tmp_path), {"w": torch.zeros(2, 3), "v": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch for w"):
        checkpoint.restore_tree(str(tmp_path), {"w": torch.zeros(3, 2)})


def test_jax_lm_tree_is_not_the_ports(tmp_path):
    """The JAX LM stacks each period position over n_periods; the port keeps
    one dict a layer.  A JAX LM checkpoint does not restore into a port LM
    tree (shape mismatch), and is never reshaped into one."""
    jcfg = jregistry.get_config("internlm2-20b").reduced(n_layers=2)
    tcfg = registry.get_config("internlm2-20b").reduced(n_layers=2)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    jp = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    jckpt.save_tree(str(tmp_path), jp)
    with pytest.raises(ValueError, match="shape mismatch for stack/0/"):
        checkpoint.restore_tree(str(tmp_path), lm.init(tcfg, device="cpu"))


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def state(v=0.0):
    return {"params": {"w": torch.arange(12.0).reshape(3, 4) + v,
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "step": 0}


def test_manager_keeps_k_and_ignores_uncommitted(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, state(step))
    mgr.wait()
    assert mgr.steps() == [3, 4]
    # a save cut off mid-write, and a directory without a manifest
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "arrays-0.npz").write_bytes(b"torn")
    (tmp_path / "step_8").mkdir()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    got, step, _ = mgr.restore(state())
    assert step == 4 and torch.equal(got["params"]["w"], state(4)["params"]["w"])
    assert set(mgr.timings) == {"snapshot_s", "write_s", "restore_s"}
    # a later save of that step replaces the stale tmp and commits
    mgr.save(9, state(9), block=True)
    assert mgr.steps() == [4, 9] and not (tmp_path / "step_9.tmp").exists()


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """The tree is changed in place (an AdamW update of its moments, an
    in-place add on a parameter) after save() returns and before the writer
    thread serializes: the checkpoint holds the values save() saw."""
    go = threading.Event()
    save_tree = ckpt.save_tree

    def held(*a, **kw):
        assert go.wait(30)
        return save_tree(*a, **kw)

    monkeypatch.setattr(manager_mod.ckpt, "save_tree", held)
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    opt = optim.adamw(1e-2)
    opt_state = opt.init(params)
    _, opt_state = opt.update({"w": torch.ones(2, 3)}, opt_state, params)
    tree = {"params": params, "opt": opt_state}
    before = utils.tree_map(torch.clone, {"params": params, "opt": opt_state[1:]})
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, tree)
    _, opt_state = opt.update({"w": torch.full((2, 3), 5.0)}, opt_state, params)
    params["w"].add_(100.0)
    go.set()
    mgr.wait()
    assert not torch.equal(opt_state.mu["w"], before["opt"][0]["w"])   # it moved
    got, step, _ = mgr.restore(tree)
    assert step == 1 and got["opt"].step == 1
    assert torch.equal(got["params"]["w"], before["params"]["w"])
    assert torch.equal(got["opt"].mu["w"], before["opt"][0]["w"])
    assert torch.equal(got["opt"].nu["w"], before["opt"][1]["w"])


def test_writer_error_surfaces_at_wait_and_save(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(manager_mod.ckpt, "save_tree", broken)
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, state())
    with pytest.raises(RuntimeError, match="background checkpoint save failed") as e:
        mgr.wait()
    assert isinstance(e.value.__cause__, OSError)
    mgr.wait()                                    # raised once
    mgr.save(2, state())
    with pytest.raises(RuntimeError, match="background checkpoint save failed"):
        mgr.save(3, state())
    assert mgr.steps() == []


def test_snapshot_copies_host_tensors():
    t = torch.zeros(3)
    snap = ckpt.snapshot({"a": [t, 4], "b": None})
    t.add_(1.0)
    assert snap["a"][0].tolist() == [0.0, 0.0, 0.0] and snap["a"][1] == 4
    assert snap["b"] is None


def test_reshard_restore_without_a_mesh(tmp_path):
    checkpoint.save_tree(str(tmp_path), state(2), step=7, meta={"tag": "t"})
    got, step, meta = checkpoint.reshard_restore(str(tmp_path), state())
    assert step == 7 and meta == {"tag": "t"}
    assert torch.equal(got["params"]["w"], state(2)["params"]["w"])
    assert got["params"]["b"].device == torch.device("cpu")
    # onto a layout of one rank: every slice is the whole tensor
    from repro_torch.launch import mesh
    got, step, _ = checkpoint.reshard_restore(
        str(tmp_path), state(), layout=mesh.make_mesh((1, 1), ("data", "model")))
    assert step == 7 and torch.equal(got["params"]["w"], state(2)["params"]["w"])
