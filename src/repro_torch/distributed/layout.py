"""A named shape over the ranks of a ``torch.distributed`` world: the
port's counterpart of a JAX device mesh (``launch/mesh`` builds the ones
the drivers use).

Ranks are laid out row-major, the first axis outermost (pod before data,
data before model), as ``jax.make_mesh`` lays out devices.  The rank
arithmetic (a rank's coordinates, the ranks that share an axis with it) is
a pure function of the shape and a rank, so a layout needs no processes
until ``groups()`` makes one ``torch.distributed`` group per axis.  The
sharding rules (``distributed/sharding``) read only ``axis_names`` and
``shape`` (an axis -> size mapping), as the JAX package's read a mesh.

The backend is gloo: it runs on the host and takes CUDA tensors, so several
ranks can share one card (NCCL refuses two ranks of one communicator on
one device).
"""
from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

import torch.distributed as dist

#: seconds a collective may wait for its peers before it fails the run (a
#: rank that took another branch then raises instead of hanging)
COLLECTIVE_TIMEOUT_S = 300.0


def timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)


def world_size() -> int:
    """Ranks in the default group, 1 when none is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default group, 0 when none is initialized."""
    return dist.get_rank() if dist.is_initialized() else 0


class Layout:
    """A named shape over ``prod(sizes)`` ranks.

    ``shape`` maps each axis name to its size (ordered as ``axis_names``);
    ``coords``, ``rank_of``, ``axis_index`` and ``axis_ranks`` are the rank
    arithmetic; ``groups`` the process groups."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"shape {sizes} does not name each of its axes "
                             f"once: {axis_names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"axis sizes must be positive, got {sizes}")
        self.sizes, self.axis_names = sizes, axis_names
        self._groups: Optional[dict] = None

    def __repr__(self) -> str:
        return f"Layout({dict(self.shape)})"

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> tuple[int, ...]:
        """``rank``'s index along each axis (row-major, first axis outermost)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a layout of {self.size}")
        out = []
        for s in reversed(self.sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for c, s in zip(coords, self.sizes):
            r = r * s + c
        return r

    def axis_index(self, axis: str, rank: int) -> int:
        return self.coords(rank)[self.axis_names.index(axis)]

    def axis_ranks(self, axis: str, rank: int) -> list[int]:
        """The ranks that share every coordinate of ``rank`` but ``axis``'s,
        in that axis's order."""
        i = self.axis_names.index(axis)
        c = list(self.coords(rank))
        out = []
        for j in range(self.sizes[i]):
            c[i] = j
            out.append(self.rank_of(c))
        return out

    def groups(self) -> dict:
        """One gloo process group per axis of more than one rank, this
        rank's (None for an axis of one rank), made once.  Every rank of
        the world takes part in every ``new_group`` call, in one order."""
        if self._groups is None:
            if world_size() != self.size:
                raise ValueError(f"layout {dict(self.shape)} needs {self.size} "
                                 f"ranks, the world has {world_size()}")
            me = world_rank()
            out = {}
            for axis, n in zip(self.axis_names, self.sizes):
                out[axis] = None
                if n == 1:
                    continue
                seen = set()
                for r in range(self.size):
                    ranks = tuple(self.axis_ranks(axis, r))
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    g = dist.new_group(list(ranks), backend="gloo",
                                       timeout=timeout())
                    if me in ranks:
                        out[axis] = g
            self._groups = out
        return self._groups


def data_axes(layout: Layout) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in layout.axis_names)


def data_index(layout: Layout, rank: int) -> tuple[int, int]:
    """(``rank``'s index over the data axes taken together, their rank
    count): which share of a batch the rank takes in data parallelism."""
    idx, n = 0, 1
    for a in data_axes(layout):
        idx = idx * layout.shape[a] + layout.axis_index(a, rank)
        n *= layout.shape[a]
    return idx, n
