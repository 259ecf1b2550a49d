"""Shared kernel plumbing (port of ``repro/kernels/common.py``): tiling
helper, the nvcc build of ``csrc/*.cu`` into shared libraries with a plain C
interface loaded through ``ctypes``, and a launch count per kernel (the
counterpart of ``count_pallas_calls``: each wrapper adds one where it
launches its kernel, so a run can show which kernels its path went
through; a replayed CUDA graph credits the launches it holds, ``credit``).

Nothing is compiled at import: a library is built from the repository's
sources at the first launch of one of its kernels (or by ``build_all``),
into ``kernels/build/``, keyed by a hash of its sources and flags.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: dtype codes the C entry points take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: activation codes the C entry points take
ACT_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3, "swiglu": 4}
#: SMs of an H100 SXM, what the launch plans assume without a card
H100_SMS = 132


def pick_tile(n: int, preferred: int, align: int = 8) -> int:
    """Largest tile <= preferred that divides n, preferring ``align``
    multiples; ``n <= preferred`` returns ``n``; ``n <= 0`` raises."""
    if n <= 0:
        raise ValueError(f"pick_tile needs a positive axis size, got n={n}")
    if align <= 0:
        raise ValueError(f"pick_tile needs a positive alignment, got {align}")
    if n <= preferred:
        return n
    preferred = max(1, preferred)
    best = 1
    for t in range(preferred, 0, -1):
        if n % t == 0:
            if t % align == 0:
                return t
            best = max(best, t)
    return best


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    path = str(cand) if cand.is_file() else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from kernels/csrc/ at first use")
    return path


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: the name
    carries a hash of every csrc file and the flags, so an edit rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(sources: Optional[Sequence[str]] = None) -> dict[str, float]:
    """Compile every ``csrc/*.cu`` not yet built, one nvcc per source, all
    started together.  Returns seconds per source built (empty when all
    were cached); raises with nvcc's output if any build fails."""
    sources = sources or sorted(f.name for f in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    took, failed = {}, []
    for src, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {src} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


_LIBS: dict[str, ctypes.CDLL] = {}


def load_library(source: str) -> ctypes.CDLL:
    if source not in _LIBS:
        path = library_path(source)
        if not path.exists():
            build_all([source])
        _LIBS[source] = ctypes.CDLL(str(path))
    return _LIBS[source]


# ---------------------------------------------------------------------------
# kernels and their launch counts
# ---------------------------------------------------------------------------

class Kernel:
    """One hand-written CUDA kernel: the library it is built into, its C
    entry point (returning ``cudaGetLastError()`` after the launch), and
    ``launches``, the number of successful launches since the last reset;
    a wrapper whose kernel has more than one path counts each launch in
    ``paths`` too, by path name."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name, self.source, self.symbol = name, source, symbol
        self.argtypes, self.replaces = argtypes, replaces
        self.launches = 0
        self.paths: dict[str, int] = {}
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._fn, self._lib = fn, lib
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} "
                               f"({self._lib.error_string(err).decode()})")
        self.launches += 1


KERNELS: dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def path_counts() -> dict[str, dict[str, int]]:
    """Launches by path of each kernel that counts them."""
    return {name: dict(k.paths) for name, k in KERNELS.items() if k.paths}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.paths.clear()


def count_state() -> dict:
    """Every kernel's launches and launches by path, for ``counts_since``."""
    return {name: (k.launches, dict(k.paths)) for name, k in KERNELS.items()}


def counts_since(state: dict) -> dict:
    """The launches (and launches by path) each kernel counted since
    ``count_state()`` gave ``state``; kernels that counted none left out."""
    out = {}
    for name, k in KERNELS.items():
        n0, p0 = state.get(name, (0, {}))
        paths = {p: c - p0.get(p, 0) for p, c in k.paths.items()
                 if c != p0.get(p, 0)}
        if k.launches != n0 or paths:
            out[name] = (k.launches - n0, paths)
    return out


def credit(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (from ``counts_since``) to the counts.  A
    CUDA graph's replay launches its kernels with no Python: the graph takes
    back the launches its capture counted (``times=-1``; a capture executes
    nothing) and credits them again at every replay
    (``serving/graphs.py``)."""
    for name, (n, paths) in delta.items():
        k = KERNELS[name]
        k.launches += times * n
        for p, c in paths.items():
            v = k.paths.get(p, 0) + times * c
            if v:
                k.paths[p] = v
            else:
                k.paths.pop(p, None)


def check(t: torch.Tensor, name: str, *, like: Optional[torch.Tensor] = None,
          dtype=None, shape=None) -> None:
    """What every kernel wrapper requires of a tensor it hands to C: on a
    CUDA device (``like``'s device when given), of ``dtype`` (default
    ``like``'s), of ``shape``, contiguous."""
    if like is not None:
        if t.device != like.device:
            raise ValueError(f"{name}: on {t.device}, expected {like.device}")
        dtype = dtype or like.dtype
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def forward_only(name: str, *tensors) -> None:
    """Every kernel is forward-only (the JAX package has no backward for its
    Pallas kernels either): raise when grad mode is on and an input requires
    grad, on either device, so a kernel's output never stands in an autograd
    graph with its inputs' gradients silently missing.  ``tensors`` may hold
    None and tuples of tensors."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, (tuple, list)):
            forward_only(name, *t)
        elif t is not None and t.requires_grad:
            raise RuntimeError(
                f"{name}: the kernel is forward-only and an input requires "
                f"grad; run it under torch.no_grad() or inference_mode, and "
                f"train through the einsum backends (mode='train')")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def stream_of(t: torch.Tensor) -> tuple[int, int]:
    """(device ordinal, current stream) of a CUDA tensor: every C entry
    point selects that device first, since the libraries' CUDA runtime
    keeps a current device of its own."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """SMs of CUDA device ``device`` (``tensor.get_device()``); a CPU
    tensor (-1) only reaches a launch plan in tests, and gets H100_SMS."""
    if device < 0:
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


P, I = ctypes.c_void_p, ctypes.c_int
