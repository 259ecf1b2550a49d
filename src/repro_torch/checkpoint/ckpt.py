"""Checkpoint serialization (port of ``repro/checkpoint/ckpt.py``): a tree
-> a directory of ``.npz`` shards and a manifest, in the JAX package's
format, so a checkpoint either package writes restores in the other.

Format:
  <dir>/manifest.json   {"step", "meta", "shards", "leaves": [{"key",
                         "shape", "dtype", "shard"}]}
  <dir>/arrays-<k>.npz  flat leaf arrays keyed by their path strings, at
                         most ``max_shard_mb`` of them a shard

A leaf's key is its path joined by ``/``: a dict key as ``str(key)``, a
list or tuple index as the index, a NamedTuple field (``AdamWState.step``,
``.mu``, ``.nu``) as its name; dict keys are walked sorted, as
``jax.tree_util`` flattens them, and None is no leaf.  bfloat16 and the two
float8 dtypes go to disk as their raw bits in a same-width unsigned integer
view, the manifest naming the real dtype.  A Python int leaf (the port's
AdamW step) is saved as a 0-d int32 array (int64 past its range) and
restored as a Python int.

``snapshot`` copies a tree's tensors to host memory, which is what the
checkpoint manager does on the caller's thread before a background write.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterator, Optional

import numpy as np
import torch

PyTree = Any

_SEP = "/"

# numpy has no bf16/fp8: store the raw bits, restore through the manifest's dtype
_BITCAST = {
    "bfloat16": (torch.bfloat16, torch.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8),
}
_TORCH_NAMES = {v[0]: k for k, v in _BITCAST.items()}


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(tree) -> Optional[list]:
    """(path component, child) pairs of an inner node, None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree: PyTree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util.tree_flatten_with_path`` order."""
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            yield prefix, tree
        return
    for name, child in kids:
        yield from flatten_with_paths(child, f"{prefix}{_SEP}{name}" if prefix else name)


def _map_with_paths(fn, tree: PyTree, prefix: str = "") -> PyTree:
    """``fn(key, leaf)`` over the leaves, keeping the structure."""
    if tree is None:
        return None
    key = lambda name: f"{prefix}{_SEP}{name}" if prefix else name
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, key(str(k))) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_paths(fn, v, key(f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, key(str(i)))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf                       # Python scalars are immutable


def snapshot(tree: PyTree) -> PyTree:
    """The tree with every tensor copied to host memory (a new tensor even
    for one already there): what a later in-place update of ``tree``
    cannot reach."""
    return _map_with_paths(lambda _, leaf: _host_copy(leaf), tree)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array to write, manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _TORCH_NAMES:
            name = _TORCH_NAMES[t.dtype]
            return t.contiguous().view(_BITCAST[name][1]).numpy(), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, int):
        fits = np.iinfo(np.int32).min <= leaf <= np.iinfo(np.int32).max
        arr = np.asarray(leaf, np.int32 if fits else np.int64)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_tree(directory: str, tree: PyTree, step: int = 0,
              meta: Optional[dict] = None, max_shard_mb: int = 512) -> None:
    """Write ``tree`` (tensors on any device, Python ints, numpy arrays) to
    ``directory``."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"step": int(step), "meta": meta or {}, "shards": [],
                "leaves": []}
    shard: dict[str, np.ndarray] = {}
    shard_bytes = 0

    def flush():
        nonlocal shard, shard_bytes
        if not shard:
            return
        fname = f"arrays-{len(manifest['shards'])}.npz"
        np.savez(os.path.join(directory, fname), **shard)
        manifest["shards"].append(fname)
        shard, shard_bytes = {}, 0

    for key, leaf in flatten_with_paths(tree):
        arr, dtype_name = _to_numpy(leaf)
        manifest["leaves"].append({"key": key, "shape": list(arr.shape),
                                   "dtype": dtype_name,
                                   "shard": len(manifest["shards"])})
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= max_shard_mb * 1024 * 1024:
            flush()
    flush()
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _place(key: str, arr: np.ndarray, dtype_name: str, like):
    """One stored array as ``like``: an int, or a tensor of its shape on its
    device in its dtype."""
    want = () if isinstance(like, int) else tuple(like.shape)
    if tuple(arr.shape) != want:
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                         f"vs model {want}")
    if isinstance(like, int):
        return int(arr.item())
    t = torch.from_numpy(arr)
    if dtype_name in _BITCAST:
        t = t.view(_BITCAST[dtype_name][0])
    return t.to(device=like.device, dtype=like.dtype)


def restore_tree(directory: str, like: PyTree) -> tuple[PyTree, int, dict]:
    """Restore into the structure of ``like`` (tensors and Python ints);
    returns (tree, step, meta).  Each leaf comes back as its counterpart in
    ``like``: a tensor on that tensor's device in its dtype, an int.
    Raises on a key the checkpoint lacks or a shape that differs (nothing
    is reshaped: a JAX LM tree, stacked over periods, is not the port's)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = {l["key"]: l["dtype"] for l in manifest["leaves"]}
    files = [np.load(os.path.join(directory, fname)) for fname in manifest["shards"]]
    try:
        where = {k: z for z in files for k in z.files}

        def load(key, leaf):
            if key not in where:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            return _place(key, where[key][key], dtypes.get(key, ""), leaf)

        tree = _map_with_paths(load, like)
    finally:
        for z in files:
            z.close()
    return tree, manifest["step"], manifest.get("meta", {})
