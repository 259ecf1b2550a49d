"""Rolling checkpoint manager (port of ``repro/checkpoint/manager.py``):
atomic commits, keep-k retention, one background save at a time.

Durability contract: a checkpoint directory is visible under its final name
only after a complete write (``step_N.tmp``, then ``rename``), so a crash
mid-save never corrupts the newest restorable state; the supervisor
(``distributed/fault.py``) restarts from the newest committed step, and a
stale ``.tmp`` is never listed.

The port's optimizer writes its moments in place, so an asynchronous save
first copies every leaf to host memory on the caller's thread
(``ckpt.snapshot``): the checkpoint holds the state at the moment ``save``
was called whatever the caller does next.  The background thread only
serializes, commits and collects old checkpoints; it never touches a
device tensor.  Its error is raised at the next ``wait`` or ``save``.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Any, Optional

from repro_torch.checkpoint import ckpt

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    """``timings`` holds the newest save's ``snapshot_s`` (the caller's
    thread) and ``write_s`` (serialize and commit), and the newest
    restore's ``restore_s``, in host-clock seconds."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self.timings: dict[str, float] = {}
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: PyTree, meta: Optional[dict] = None,
             block: bool = False) -> None:
        self.wait()                      # one in-flight save at a time
        t0 = time.perf_counter()
        host = ckpt.snapshot(tree)
        self.timings["snapshot_s"] = time.perf_counter() - t0
        if self.async_save and not block:
            self._worker = threading.Thread(
                target=self._save_thread, args=(step, host, meta), daemon=True)
            self._worker.start()
        else:
            self._save_impl(step, host, meta)

    def _save_thread(self, step: int, host: PyTree, meta: Optional[dict]):
        try:
            self._save_impl(step, host, meta)
        except Exception as e:           # noqa: BLE001  (re-raised by wait())
            self._error = e

    def _save_impl(self, step: int, tree: PyTree, meta: Optional[dict]):
        t0 = time.perf_counter()
        final = os.path.join(self.root, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        ckpt.save_tree(tmp, tree, step=step, meta=meta)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic commit
        self._gc()
        self.timings["write_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        """Join the save in flight; re-raise its error if it failed."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err

    # -- read ----------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: PyTree, step: Optional[int] = None
                ) -> tuple[PyTree, int, dict]:
        """Restore ``step`` (default the newest committed) into the
        structure, dtypes and devices of ``like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.root}")
        t0 = time.perf_counter()
        out = ckpt.restore_tree(os.path.join(self.root, f"step_{step}"), like)
        self.timings["restore_s"] = time.perf_counter() - t0
        return out

    # -- retention -----------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)
