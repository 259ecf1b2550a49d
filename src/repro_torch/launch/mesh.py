"""Process-group layouts (port of ``repro/launch/mesh.py``).

The layouts the drivers use, as ``distributed/layout.Layout``s (a named
shape over the ranks of a ``torch.distributed`` world, the port's
counterpart of a JAX device mesh):

  host:        (world,)       on ("data",)
  serving(M):  (world/M, M)   on ("data", "model")
  production:  (16, 16)       on ("data", "model")         = 256 ranks
               (2, 16, 16)    on ("pod", "data", "model")  = 512 ranks

The backend is gloo (``distributed/layout``).  ``init_ranks`` joins the
world that ``python -m torch.distributed.run`` describes in the
environment; ``spawn_ranks`` starts a world of local processes from one
(tests, the card's smoke run)::

  python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.serve --model-parallel 2 --device cpu
"""
from __future__ import annotations

import contextlib
import math
import os
import pickle
import socket
import time
from typing import Callable, Optional, Sequence

import torch.distributed as dist

from repro_torch.distributed import act
# data_axes, data_index and world_rank are read here by the drivers
from repro_torch.distributed.layout import (Layout, data_axes, data_index,  # noqa: F401
                                            timeout, world_rank, world_size)


def _current_world(world: Optional[int]) -> int:
    return world_size() if world is None else int(world)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Layout:
    """An arbitrary layout (tests, elastic restore)."""
    return Layout(shape, axes)


def make_host_mesh(world: Optional[int] = None) -> Layout:
    """Every rank of the world (or ``world`` ranks) on one data axis."""
    return Layout((_current_world(world),), ("data",))


def make_serving_mesh(model_parallel: int = 1,
                      world: Optional[int] = None) -> Layout:
    """The world as a (data, model) layout for expert-parallel serving:
    ``grouped_ep`` exchanges tokens over the model axis.  ``model_parallel``
    must divide the world."""
    n = _current_world(world)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} must divide {n} devices")
    return Layout((n // model_parallel, model_parallel), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         world: Optional[int] = None) -> Layout:
    """(16, 16) on (data, model), or (2, 16, 16) on (pod, data, model);
    the world must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _current_world(world)
    if n != math.prod(shape):
        raise ValueError(f"the production layout {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {n}")
    return Layout(shape, axes)


def serving_context(model_parallel: int = 1, world: Optional[int] = None):
    """The serving topology as an installable pair ``(layout, ctx)``:
    ``ctx()`` is a zero-argument context-manager factory that installs the
    layout's model and data groups (``distributed/act.use_groups``), which
    both serving paths wrap every call in.  ``model_parallel <= 1`` returns
    ``(None, contextlib.nullcontext)``, so callers need no branching."""
    if model_parallel <= 1:
        return None, contextlib.nullcontext
    layout = make_serving_mesh(model_parallel, world)
    g = layout.groups()

    def ctx():
        return act.use_groups(g["model"], g["data"])

    return layout, ctx


def num_chips(layout: Layout) -> int:
    """Ranks in the layout (several may share one card)."""
    return layout.size


def init_ranks() -> tuple[int, int]:
    """Join the world (rank, world size): the group already initialized, or
    the one ``torch.distributed.run`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), over gloo; with neither, one
    process and no group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return 0, 1
    dist.init_process_group("gloo", init_method="env://", timeout=timeout())
    return dist.get_rank(), dist.get_world_size()


def free_port() -> int:
    """A port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, world: int, port: int, args: tuple,
                results) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, timeout=timeout())
    try:
        # by value: a tensor sent through the queue as it is would be
        # shared memory that dies with this process
        results.put((rank, pickle.dumps(fn(rank, world, *args))))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: tuple = (),
                timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in a gloo world on localhost; returns each rank's (picklable) result,
    by rank.  Raises if a rank fails or the ranks take over ``timeout_s``
    (then every rank is killed).  ``fn`` must be importable by name in a
    fresh interpreter (a module-level function)."""
    import torch.multiprocessing as mp
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank_entry,
                             args=(fn, world, free_port(), args, results),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    out = {}

    def drain():
        # a rank's put blocks until it is read: read while waiting
        while not results.empty():
            r, v = results.get()
            out[r] = pickle.loads(v)

    try:
        while not ctx.join(timeout=0.5):
            drain()
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks took over {timeout_s} s")
        drain()
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
