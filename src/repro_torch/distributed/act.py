"""The process groups the expert-parallel dispatch runs over (port of the
part of ``repro/distributed/act.py`` that the FFF backends read).

The launch layer installs a model-axis process group (and optionally a
data-axis one) for the dynamic extent of a ``with use_groups(...)`` block;
``core/api`` resolves ``auto`` to ``grouped_ep`` when a model group of more
than one rank is installed, and ``core/routing`` exchanges tokens over it.
With nothing installed every count is 1 and the backends run on one
process.

JAX's activation layout constraints (``shard`` and the activation kinds it
takes) tell the SPMD partitioner how to lay out a traced program; eager
PyTorch has no such program, so they are not ported.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch.distributed as dist

_state = threading.local()


def _groups() -> Optional[tuple]:
    return getattr(_state, "groups", None)


@contextlib.contextmanager
def use_groups(model, data=None):
    """Install ``model`` (the ranks that own the leaves between them) and
    optionally ``data`` (ranks holding other tokens of the same leaves) for
    this thread.  Each is a ``torch.distributed`` process group, e.g.
    ``dist.group.WORLD`` or one made by ``dist.new_group``.  Contexts nest."""
    prev = _groups()
    _state.groups = (model, data)
    try:
        yield
    finally:
        _state.groups = prev


@contextlib.contextmanager
def groups_installed(groups: Optional[tuple]):
    """Install exactly ``groups`` (a ``(model, data)`` pair, or None for
    none) for this thread: how a state read with ``current_groups`` in one
    thread is carried into another.  Contexts nest."""
    prev = _groups()
    _state.groups = groups
    try:
        yield
    finally:
        _state.groups = prev


def mesh_installed() -> bool:
    """Whether process groups are installed in this thread (the JAX
    package's "a mesh is installed")."""
    return _groups() is not None


def current_groups() -> tuple:
    """(model group, data group or None); (None, None) when nothing is
    installed."""
    return _groups() or (None, None)


def model_shard_count() -> int:
    """Ranks in the installed model group (1 when none is installed)."""
    g = _groups()
    return 1 if g is None else dist.get_world_size(g[0])


def data_shard_count() -> int:
    """Ranks in the installed data group (1 when none is installed).
    Capacity-bounded dispatch blocks the token axis by this count, so
    capacity is per (data shard, leaf) as under the JAX package's mesh."""
    g = _groups()
    return 1 if g is None or g[1] is None else dist.get_world_size(g[1])
