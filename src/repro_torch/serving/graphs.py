"""Per-shape CUDA graphs of the serving dispatches: the port's counterpart of
the JAX engine's ``jax.jit`` per shape (the port's own module).

A ``DispatchCache`` holds one entry per key: the dispatch's name, its slab
shape, whether sampling is on, and the ``api`` context it runs under
(overrides and the routing tap are read when the graph is captured, so
they are part of the key).  An entry

* stages its inputs: one pinned host buffer and one static device buffer
  hold every input, and one non-blocking upload moves them (numpy inputs
  and CPU tensors, such as a cluster handoff's bfloat16 rows; a tensor on
  the entry's device is copied there);
* on its first call runs the dispatch eagerly on a side stream: that call
  is the step itself, and it does every first-call piece of work outside
  any capture (kernel builds, ``cudaFuncSetAttribute``, workspace and
  cuBLAS allocations).  Then it captures the dispatch into a
  ``torch.cuda.CUDAGraph`` with its own memory pool, which keeps every
  address the graph baked in (a kernel's tensor maps) fixed;
* replays the graph on every later call, and credits the kernels' launch
  counters with the launches the capture recorded (``kernels/common.py``):
  a replay runs no Python.

The dispatch returns every output the host reads, on the device; the
caller copies them off in one transfer (``to_host``, into a pinned
buffer): the dispatch's one synchronization.

A dispatch function reads the engine's canonical cache tensors and copies
every leaf it rebinds (lengths, tables, recurrent state) back into them
with ``settle``, inside the capture, so a replay reads and writes fixed
addresses.  Eager dispatches settle their results the same way.  A sampled
draft's ``torch.Generator`` is registered with the graph
(``CUDAGraph.register_generator_state``), so each replay draws anew.

The capture rule (``eager_reason``): a dispatch is captured only when it
cannot synchronize with the host.  Every FFF site must resolve, on the card
and under the dispatch's context, to a backend whose shapes the token count
alone fixes: ``cuda`` at any token count (the gathered kernels up to
``api.PALLAS_DECODE_MAX_TOKENS`` tokens, the grouped GEMMs above, whose
overflow pass is sized by the shape), ``cuda_decode``, or ``grouped`` and
``grouped_ep`` with no process group installed (their repair, too, runs at
a shape fixed by the token count).  A MoE site qualifies at any token
count (``core/moe.forward_sparse`` runs the grouped GEMMs the same way),
and so do learned positions (the step's offset is a staged 0-dim input).
An installed process group keeps a dispatch eager, with its reason (its
gloo collectives stage through host memory); so does the ``reference``
backend, which evaluates leaf by leaf on host counts, and every dispatch
the caller runs outside the cache (the loop's single prefill).  On the
card a capture that fails raises: it never falls back to eager.

On the CPU the same staging runs and only capture and replay are skipped:
the dispatch function runs on the static buffers at every call, so the
CPU tests drive the code the card runs.  ``disabled()`` is the
counterpart of ``jax.disable_jit``: inside it every dispatch runs op by
op, with its inputs uploaded as they are, and no entry is made.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.distributed import act as dist_act
from repro_torch.kernels import common
from repro_torch.nn import mlp as mlp_lib

Inputs = Dict[str, object]          # name -> np.ndarray, torch.Tensor or None
Outputs = Dict[str, torch.Tensor]   # name -> a tensor the host reads

_ALIGN = 16                          # bytes between staged inputs
#: the FFF backends whose dispatch reads nothing on the host at any token
#: count (the grouped ones with no process group installed; the fused
#: decode kernel on a tree with a node to descend)
_STATIC_BACKENDS = ("cuda", "cuda_decode", "grouped", "grouped_ep")
_disabled = 0


@contextlib.contextmanager
def disabled():
    """Run every dispatch eagerly, op by op, for the dynamic extent of the
    block (``jax.disable_jit``'s counterpart): nothing is staged, captured
    or replayed, and graphs captured before stay cached for later."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def is_disabled() -> bool:
    return _disabled > 0


def settle(canonical, new):
    """Copy every tensor leaf of ``new`` that is not ``canonical``'s own
    tensor into it, in place, and return ``canonical``.  The trees are
    nested dicts, lists and tuples (named tuples included) of tensors and
    constants; their structure, shapes and dtypes must agree."""
    if isinstance(canonical, torch.Tensor):
        if new is not canonical:
            if (not isinstance(new, torch.Tensor) or new.shape != canonical.shape
                    or new.dtype != canonical.dtype):
                raise ValueError(f"settle: cannot copy {_describe(new)} into "
                                 f"{_describe(canonical)}")
            canonical.copy_(new)
    elif isinstance(canonical, dict):
        if not isinstance(new, dict) or canonical.keys() != new.keys():
            raise ValueError(f"settle: keys {sorted(canonical)} against "
                             f"{sorted(new) if isinstance(new, dict) else new!r}")
        for k in canonical:
            settle(canonical[k], new[k])
    elif isinstance(canonical, (list, tuple)):
        if type(new) is not type(canonical) or len(new) != len(canonical):
            raise ValueError(f"settle: {type(canonical).__name__} of "
                             f"{len(canonical)} against {_describe(new)}")
        for c, n in zip(canonical, new):
            settle(c, n)
    elif new != canonical:
        raise ValueError(f"settle: constant {canonical!r} against {new!r}")
    return canonical


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a {x.dtype} tensor of shape {tuple(x.shape)}"
    return type(x).__name__


# ---------------------------------------------------------------------------
# the capture rule
# ---------------------------------------------------------------------------

def eager_reason(params: dict, cfg, rows: int, seq: int) -> Optional[str]:
    """Why a ``(rows, seq)`` token slab through this model may not be
    captured, or None when it may (the module docstring's rule).  Read
    under the caller's ``api`` context, for a slab on the card."""
    if dist_act.mesh_installed():
        return ("a process group is installed: its collectives stage "
                "through host memory")
    cuda = torch.device("cuda")
    for i, layer in enumerate(params["stack"]):
        spec = cfg.period[i % len(cfg.period)].ffn
        if spec.kind != "fff":
            continue
        fc = mlp_lib.make_fff_config(spec, cfg.d_model,
                                     param_dtype=cfg.param_dtype,
                                     accum_dtype=cfg.accum_dtype)
        backend = api.resolve_backend(layer["ffn"], fc, "infer",
                                      x_shape=(rows, seq, cfg.d_model),
                                      x_device=cuda)
        if backend in _STATIC_BACKENDS and (backend != "cuda_decode"
                                            or fc.depth > 0):
            continue
        return (f"layer {i}'s FFF site resolves to {backend!r} at "
                f"{rows * seq} tokens, which evaluates leaf by leaf on "
                f"counts read on the host")
    return None


# ---------------------------------------------------------------------------
# moving outputs to the host
# ---------------------------------------------------------------------------

_PINNED: Dict[torch.device, torch.Tensor] = {}


def to_host(parts: Outputs) -> Dict[str, np.ndarray]:
    """Copy a dispatch's outputs to the host in one transfer, its one
    synchronization: every part goes as float32 (token ids and leaf counts
    stay exact below 2**24), through one pinned buffer per card, and comes
    back in its own shape."""
    flat = torch.cat([p.reshape(-1).float() for p in parts.values()])
    if flat.is_cuda:
        buf = _PINNED.get(flat.device)
        if buf is None or buf.numel() < flat.numel():
            with torch.inference_mode(False):      # written outside it too
                buf = _PINNED[flat.device] = torch.empty(
                    flat.numel(), dtype=torch.float32, pin_memory=True)
        buf[:flat.numel()].copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        flat = buf[:flat.numel()].numpy().copy()
    else:
        flat = flat.numpy()
    out, o = {}, 0
    for k, p in parts.items():
        out[k] = flat[o:o + p.numel()].reshape(tuple(p.shape))
        o += p.numel()
    return out


def upload(v, device: torch.device):
    """An input as an eager dispatch takes it: a numpy array copied to the
    device as it is (pageable), a tensor moved there, None kept."""
    if v is None or isinstance(v, torch.Tensor):
        return None if v is None else v.to(device)
    a = np.asarray(v)          # a 0-dim input stays 0-dim
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape)).to(device)


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------

class CudaGraphRecorder:
    """Captures a function into a ``torch.cuda.CUDAGraph`` (its own memory
    pool; ``generators`` registered, so their draws advance at each
    replay) and replays it."""

    def __init__(self, generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)

    def capture(self, run: Callable[[], object], stream):
        # no garbage collection while capturing: a collected engine's graph
        # would be destroyed inside this capture, which invalidates it;
        # thread-local: a thread that does not serve (a checkpoint writer)
        # may touch the card meanwhile
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                return run()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


_SIDE: Dict[int, torch.cuda.Stream] = {}


def _side_stream(device: torch.device):
    """The stream every first call and capture runs on (one per card), so
    its cuBLAS workspace is set up by the warm-up, outside the capture."""
    i = torch.cuda.current_device() if device.index is None else device.index
    if i not in _SIDE:
        _SIDE[i] = torch.cuda.Stream(device=i)
    return _SIDE[i]


def _dtype(v) -> torch.dtype:
    return (v.dtype if isinstance(v, torch.Tensor) else
            torch.from_numpy(np.asarray(v).reshape(-1)[:0]).dtype)


class _Entry:
    """One key's staged inputs, captured graph and outputs."""

    def __init__(self, name: str, fn: Callable[[Inputs], Outputs],
                 inputs: Inputs, device: torch.device, recorder):
        self.name, self.fn, self.device = name, fn, device
        self.cuda = device.type == "cuda"
        self.layout, offset = {}, 0
        for k, v in sorted(inputs.items()):
            if v is None:
                self.layout[k] = None
                continue
            dtype = _dtype(v)
            nbytes = int(np.prod(v.shape, dtype=np.int64)) * dtype.itemsize
            self.layout[k] = (offset, dtype, tuple(v.shape), nbytes)
            offset += -(-nbytes // _ALIGN) * _ALIGN
        size = max(offset, _ALIGN)
        # normal tensors, not inference ones: staged into in or out of
        # inference mode, whichever the entry was made in
        with torch.inference_mode(False):
            self.host_buf = torch.empty(size, dtype=torch.uint8,
                                        pin_memory=self.cuda)
            self.dev_buf = torch.empty(size, dtype=torch.uint8, device=device)

        def views(buf, k):
            off, dtype, shape, nbytes = self.layout[k]
            return buf[off:off + nbytes].view(dtype).view(shape)
        self.static = {k: None if spec is None else views(self.dev_buf, k)
                       for k, spec in self.layout.items()}
        self.staging = {k: views(self.host_buf, k)
                        for k, spec in self.layout.items()
                        if spec is not None and self._on_host(inputs[k])}
        self.uploaded = torch.cuda.Event() if self.cuda else None
        self.recorder = recorder
        self.captured = False
        self.out: Outputs = {}
        self.credit: dict = {}

    def _stage(self, inputs: Inputs) -> None:
        if inputs.keys() != self.layout.keys():
            raise ValueError(f"{self.name}: inputs {sorted(inputs)} against "
                             f"the entry's {sorted(self.layout)}")
        for k, v in inputs.items():
            if not self._matches(k, v):
                raise ValueError(f"{self.name}: input {k!r} does not match "
                                 f"the entry's key")
        if self.staging:
            if self.uploaded is not None:
                self.uploaded.synchronize()    # the last upload left the host
            for k, a in self.staging.items():
                v = inputs[k]
                if isinstance(v, torch.Tensor):
                    a.copy_(v)
                else:
                    a.numpy()[...] = v
            self.dev_buf.copy_(self.host_buf, non_blocking=self.cuda)
            if self.uploaded is not None:
                self.uploaded.record()
        for k, v in inputs.items():
            if v is not None and k not in self.staging:
                self.static[k].copy_(v)

    def _on_host(self, v) -> bool:
        """Whether input ``v`` goes through the pinned buffer: numpy, or a
        CPU tensor for an entry on the card."""
        return not isinstance(v, torch.Tensor) or (self.cuda and
                                                   v.device.type == "cpu")

    def _matches(self, k: str, v) -> bool:
        """Whether input ``v`` has the None-ness, kind (staged from the host
        or copied on the device), shape and dtype that entry ``k`` was
        made for."""
        spec = self.layout[k]
        if v is None or spec is None:
            return v is None and spec is None
        return (self._on_host(v) == (k in self.staging) and _dtype(v) == spec[1]
                and tuple(np.shape(v)) == spec[2])

    def _run(self) -> Outputs:
        return {k: v for k, v in self.fn(self.static).items() if v is not None}

    def _first(self):
        """The first call: the dispatch runs eagerly (on the card, on the
        side stream): those are the step's own results.  Then the recorder
        captures it, which executes nothing."""
        side = None
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            side = _side_stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self._run()
            cur.wait_stream(side)
            for t in out.values():
                t.record_stream(cur)
        else:
            out = self._run()
        before = common.count_state()
        try:
            self.out = self.recorder.capture(self._run, side)
        except Exception as e:
            raise RuntimeError(
                f"capturing the {self.name} dispatch failed ({e}); a "
                f"dispatch that syncs with the host must run eagerly "
                f"(graphs.eager_reason, or graphs.disabled())") from e
        # a replay runs no Python: the launches the capture counted are
        # taken back here and credited again at every replay
        self.credit = common.counts_since(before)
        common.credit(self.credit, -1)
        self.captured = True
        return out

    def __call__(self, inputs: Inputs) -> Outputs:
        self._stage(inputs)
        if self.recorder is None:
            return self._run()
        if not self.captured:
            return self._first()
        self.recorder.replay()
        common.credit(self.credit)
        return self.out


class DispatchCache:
    """One engine's (or one serve loop's) dispatch entries, by key.

    ``recorder(generators)`` makes the object that captures and replays an
    entry's dispatch; the default is a ``CudaGraphRecorder`` on the card
    and none on the CPU (no capture: the staged dispatch runs every
    call)."""

    def __init__(self, device, recorder: Optional[Callable] = None):
        self.device = torch.device(device)
        if recorder is None and self.device.type == "cuda":
            recorder = CudaGraphRecorder
        self.recorder = recorder
        self.entries: Dict[tuple, _Entry] = {}

    def run(self, name: str, key: tuple, fn: Callable[[Inputs], Outputs],
            inputs: Inputs, *, eager: Optional[str] = None,
            generators: Sequence[torch.Generator] = ()) -> Outputs:
        """Run ``fn`` on ``inputs`` and return its outputs, None ones left
        out: on the device, where a replayed entry's next call overwrites
        them.  ``fn`` takes the inputs on the device, by name; an entry
        keeps the ``fn`` of its first call.  ``eager``, a reason from
        ``eager_reason``, runs it op by op, as ``disabled()`` does;
        otherwise the ``(name, key)`` entry stages, captures and replays
        it.  ``key`` must fix every input's shape, dtype and None-ness."""
        if eager is not None or is_disabled():
            out = fn({k: upload(v, self.device) for k, v in inputs.items()})
            return {k: v for k, v in out.items() if v is not None}
        entry = self.entries.get((name, key))
        if entry is None:
            rec = (self.recorder(tuple(generators))
                   if self.recorder is not None else None)
            entry = self.entries[(name, key)] = _Entry(
                name, fn, inputs, self.device, rec)
        return entry(inputs)

    def counts(self) -> Dict[str, int]:
        """Entries per dispatch name: captured graphs on the card, staged
        dispatches on the CPU."""
        out: Dict[str, int] = {}
        for name, _ in self.entries:
            out[name] = out.get(name, 0) + 1
        return out


def context_key() -> tuple:
    """The ``api`` thread context a dispatch would be captured under
    (overrides and the routing tap), as a hashable key part; the
    dispatch's own context comes on top of it."""
    fields = api.thread_context()[0]
    return tuple(sorted((k, v) for k, v in fields.items() if v is not None))
