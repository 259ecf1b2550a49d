"""Elastic restore (port of ``repro/checkpoint/elastic.py``): load a
checkpoint onto other devices than the ones it was saved from.

``ckpt.py`` writes host-gathered whole arrays, so restoring is a placement
decision: ``mesh=None`` places every leaf on the device of its counterpart
in ``like``.  Restoring onto a sharded layout waits for sharded leaf
weights (ROADMAP.md, queue 1, item 2); until then a mesh raises rather
than placing everything on one device.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.checkpoint import ckpt

PyTree = Any


def reshard_restore(directory: str, like: PyTree, mesh: Optional[Any] = None
                    ) -> tuple[PyTree, int, dict]:
    """Restore and place; returns (tree, step, meta)."""
    if mesh is not None:
        raise NotImplementedError(
            "restoring onto a mesh needs sharded leaf weights, which are not "
            "ported yet (ROADMAP.md, queue 1, item 2: distributed/sharding "
            "with --mesh)")
    return ckpt.restore_tree(directory, like)
