"""Elastic restore (port of ``repro/checkpoint/elastic.py``): load a
checkpoint onto another layout than the one it was saved from.

``ckpt.py`` writes whole arrays (a save under ranks gathers them first,
``CheckpointManager(placements=)``), so restoring onto a layout is a
slicing decision: every rank reads the whole arrays and keeps the slices
the new layout's specs give it.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import utils
from repro_torch.checkpoint import ckpt
from repro_torch.distributed import sharding

PyTree = Any


def reshard_restore(directory: str, like: PyTree, layout: Optional[Any] = None,
                    spec_fn: Optional[Callable] = None
                    ) -> tuple[PyTree, int, dict]:
    """Restore and place; returns (tree, step, meta).

    The whole arrays are restored into the structure, whole shapes, dtypes
    and devices of ``like``.  With a ``layout`` (``distributed/layout``)
    and ``spec_fn(path, leaf) -> spec`` (e.g. ``sharding.spec_for_path``
    on the new layout), each rank keeps the slice of every tensor that its
    spec names on ``layout`` (``sharding.slice_for``, contiguous); without
    ``spec_fn`` every leaf stays whole, as the JAX package places it."""
    tree, step, meta = ckpt.restore_tree(directory, like)
    if layout is None or spec_fn is None:
        return tree, step, meta

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return sharding.slice_for(leaf, tuple(spec_fn(path, leaf)),
                                  layout).contiguous()

    return utils.tree_map_with_paths(place, tree), step, meta
