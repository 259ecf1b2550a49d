"""Host data loader with background prefetch (port of ``repro/data/
pipeline.py``).

``shard_batch`` places a host batch on one device: without a process group
there is no mesh to shard it over, the JAX loader's ``mesh=None`` branch.
``Prefetcher`` makes numpy batches on a background thread; for a card it
pins them and copies them on a side stream, and the consumer's stream
waits on the copy's event, so the copy overlaps the consumer's work.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import utils


def shard_batch(batch: dict, device="cuda") -> dict:
    """A host batch (numpy arrays) -> tensors on ``device``."""
    dev = utils.resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of host batches (overlap data and
    compute).  ``make_batch(step)`` returns a dict of numpy arrays; the
    consumer gets the same dict as tensors on ``device``, in step order.  A
    producer error is raised at the consumer's next ``next``."""

    def __init__(self, make_batch: Callable[[int], dict], depth: int = 2,
                 device="cuda"):
        self.make_batch = make_batch
        self.device = utils.resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _copy(self, batch: dict):
        host = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _run(self):
        step = 0
        while not self._stop.is_set():
            try:
                item = self._copy(self.make_batch(step))
            except Exception as e:      # noqa: BLE001  (raised in __next__)
                self._put(e)
                return
            self._put(item)
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in batch.values():      # the allocator may not reuse them early
                t.record_stream(consumer)
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)


def epoch_batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int
                  ) -> Iterator[dict]:
    """Shuffled epoch iterator over an in-memory dataset."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    for i in range(0, len(x) - batch_size + 1, batch_size):
        sel = idx[i:i + batch_size]
        yield {"x": x[sel], "y": y[sel]}
