"""The single FFF entry point: ``apply()`` + the execution-backend registry
(port of ``repro/core/api.py``).

    y, out = api.apply(params, cfg, x, api.ExecutionSpec(mode="infer"))

Backends in this slice (inference only):

* ``reference``   — hard descent + exact per-token leaf evaluation;
* ``cuda``        — the CUDA kernel path for token batches: tree_router,
  then per-token gathered leaf matmuls for slabs of at most
  ``PALLAS_DECODE_MAX_TOKENS`` tokens and the grouped SwiGLU/MLP GEMMs
  above (counterpart of JAX ``pallas``);
* ``cuda_decode`` — the one-launch fused decode kernel for seq-len-1
  batches (counterpart of JAX ``pallas_decode``).

``backend="auto"`` resolves from the input tensor: CUDA tensors take the
kernel backends, CPU tensors the reference.  ``overrides(backend=...)``
steers every auto call site in its dynamic extent.  The grouped and
expert-parallel backends and the training backends are queued in
ROADMAP.md.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional

import torch

from repro_torch import utils
from repro_torch.core import fff as fff_lib
from repro_torch.kernels.fused_decode import ops as fd_ops
from repro_torch.kernels.fused_fff import ops as fused_ops
from repro_torch.kernels.leaf_gemm import ops as gemm_ops

MODES = ("train", "infer")

#: serving capacity factor of the capacity-bounded kernel path
DEFAULT_CAPACITY_INFER = 2.0

#: token count at or below which the cuda backend takes the per-token
#: gathered kernels instead of the sorted-dispatch grouped GEMMs (the JAX
#: package's value for its pallas backend)
PALLAS_DECODE_MAX_TOKENS = 32


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How to execute one FFF layer application.

    mode:            "train" | "infer" (only "infer" has backends so far)
    backend:         registered backend name, or "auto"
    capacity_factor: per-leaf capacity multiplier of the grouped kernel
                     path (None = 2.0); outputs are exact regardless
    dense_levels:    tree levels routed from dense logits before per-token
                     gathers take over
    valid:           optional boolean per-token validity mask (broadcastable
                     to x's leading shape); the kernel backends report
                     invalid rows at the sentinel leaf so they stay out of routing
                     telemetry.  Outputs are per-token exact regardless.
    """
    mode: str = "infer"
    backend: str = "auto"
    capacity_factor: Optional[float] = None
    dense_levels: int = 8
    valid: Optional[torch.Tensor] = None

    def validate(self) -> "ExecutionSpec":
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        return self


@dataclasses.dataclass(frozen=True)
class FFFOutput:
    """Structured aux returned by every backend; fields a backend cannot
    produce are None.  (The training slice adds FORWARD_T's node_probs,
    mixture and entropy.)

    leaf_idx:          (..., trees) int32 — routed leaf per (token, tree)
    overflow_fraction: scalar — fraction of slots dropped by a capacity
                       bound (0 for exact paths)
    """
    leaf_idx: Optional[torch.Tensor] = None
    overflow_fraction: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class RoutingStats:
    """Per-call routing telemetry for serving observability.

    leaf_counts: (B, E) float32 — routed (token, tree) slots per leading
                 batch row per leaf (sentinel-leaf slots are not counted)
    overflow:    scalar — the call's overflow_fraction
    slots:       scalar — total routed slots
    """
    leaf_counts: torch.Tensor
    overflow: torch.Tensor
    slots: torch.Tensor


_thread_state = threading.local()


@contextlib.contextmanager
def collect_routing(enable: bool = True):
    """Ask FFF call sites to surface ``RoutingStats`` in their aux outputs
    for the dynamic extent of the context."""
    prev = getattr(_thread_state, "routing", False)
    _thread_state.routing = bool(enable)
    try:
        yield
    finally:
        _thread_state.routing = prev


def routing_enabled() -> bool:
    return bool(getattr(_thread_state, "routing", False))


def routing_stats_from(out: FFFOutput, cfg: fff_lib.FFFConfig
                       ) -> Optional[RoutingStats]:
    """Reduce ``leaf_idx`` (B, ..., trees) to a per-batch-row leaf
    histogram (B, E); None when the backend reported no leaf indices."""
    if out.leaf_idx is None:
        return None
    idx = out.leaf_idx
    if idx.dim() == 1:
        idx = idx[:, None]
    flat = idx.reshape(idx.shape[0], -1).long().clamp(max=cfg.num_leaves)
    E = cfg.num_leaves
    counts = torch.zeros((flat.shape[0], E + 1), dtype=torch.float32,
                         device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    counts = counts[:, :E]                         # the sentinel id drops out
    ovf = (out.overflow_fraction if out.overflow_fraction is not None
           else torch.zeros((), dtype=torch.float32, device=flat.device))
    return RoutingStats(leaf_counts=counts, overflow=ovf, slots=counts.sum())


BackendFn = Callable[[dict, fff_lib.FFFConfig, torch.Tensor, ExecutionSpec],
                     tuple[torch.Tensor, FFFOutput]]
SupportsFn = Callable[[dict, fff_lib.FFFConfig], bool]

_REGISTRY: dict[tuple[str, str], BackendFn] = {}
_SUPPORTS: dict[tuple[str, str], SupportsFn] = {}


def register_backend(mode: str, name: str, fn: BackendFn,
                     supports: Optional[SupportsFn] = None) -> None:
    """Register ``fn(params, cfg, x, spec) -> (y, FFFOutput)`` as backend
    ``name`` for ``mode``; ``supports(params, cfg)`` is the eligibility
    predicate auto resolution and overrides honour."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if name == "auto":
        raise ValueError('"auto" is the resolver, not a registrable backend')
    _REGISTRY[(mode, name)] = fn
    if supports is not None:
        _SUPPORTS[(mode, name)] = supports
    else:
        _SUPPORTS.pop((mode, name), None)


def _backend_supported(mode: str, name: str, params: dict,
                       cfg: fff_lib.FFFConfig) -> bool:
    pred = _SUPPORTS.get((mode, name))
    return pred is None or pred(params, cfg)


def get_backend(mode: str, name: str) -> BackendFn:
    try:
        return _REGISTRY[(mode, name)]
    except KeyError:
        raise KeyError(
            f"no backend {name!r} registered for mode {mode!r}; available: "
            f"{list_backends(mode)}") from None


def list_backends(mode: Optional[str] = None) -> list[str]:
    if mode is None:
        return sorted({n for _, n in _REGISTRY})
    return sorted(n for m, n in _REGISTRY if m == mode)


def overrides(*, backend: Optional[str] = None, mode: Optional[str] = None):
    """Steer every ``backend="auto"`` apply() in this thread to ``backend``
    for the dynamic extent of the context (restricted to ``mode`` when
    given).  Ineligible sites fall through to the auto heuristics; a name
    registered for no mode raises up front.  Contexts nest."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode is not None and backend is None:
        raise ValueError("mode= only restricts a backend override; pass "
                         "backend= as well")
    if backend is not None and not any(n == backend for _, n in _REGISTRY):
        raise KeyError(f"no backend {backend!r} registered for any mode; "
                       f"available: {list_backends()}")

    @contextlib.contextmanager
    def _installed():
        prev = getattr(_thread_state, "override", None)
        if backend is not None:
            _thread_state.override = (backend, mode)
        try:
            yield
        finally:
            _thread_state.override = prev

    return _installed()


def _kernel_supported(params: dict, cfg: fff_lib.FFFConfig) -> bool:
    """The kernel path collapses the node net to one hyperplane and needs
    the zero-row padding invariant of bias-free leaves."""
    return (cfg.node_width == 1 and "leaf_b1" not in params
            and "leaf_b2" not in params)


def _kernels_native(x_device: Optional[torch.device]) -> bool:
    """Whether the input lies where the CUDA kernels run (counterpart of
    the JAX ``_kernels_native``).  Tests monkeypatch it to drive the
    kernel branches of the resolver with CPU tensors, whose kernel wrappers
    run the plain versions."""
    return x_device is not None and torch.device(x_device).type == "cuda"


def _resolve_auto(params: dict, cfg: fff_lib.FFFConfig, mode: str,
                  x_shape: Optional[tuple] = None,
                  x_device: Optional[torch.device] = None) -> str:
    """Backend choice for ``backend="auto"``: an override when eligible;
    for inference on a CUDA tensor the fused decode kernel for seq-len-1
    shapes and the kernel path otherwise; the exact reference for CPU
    tensors and depth-0 sites.  (JAX picks its ``grouped`` backend for wide
    sites off the TPU; that backend is not ported yet, so such sites run the
    reference here.)"""
    override = getattr(_thread_state, "override", None)
    if override is not None:
        o_name, o_mode = override
        if ((o_mode in (None, mode)) and (mode, o_name) in _REGISTRY
                and _backend_supported(mode, o_name, params, cfg)):
            return o_name
    if mode == "train":
        return "grouped" if (cfg.st_training and cfg.depth > 0) else "reference"
    if cfg.depth == 0:
        return "reference"
    on_cuda = _kernels_native(x_device)
    if (on_cuda and x_shape is not None and len(x_shape) >= 3
            and x_shape[-2] == 1
            and _backend_supported("infer", "cuda_decode", params, cfg)):
        return "cuda_decode"
    if on_cuda and _backend_supported("infer", "cuda", params, cfg):
        return "cuda"
    return "reference"


def resolve_backend(params: dict, cfg: fff_lib.FFFConfig, mode: str = "infer",
                    x_shape: Optional[tuple] = None,
                    x_device: Optional[torch.device] = None) -> str:
    """The backend ``apply(backend="auto")`` would run under the current
    override context, for an input of this shape on this device."""
    return _resolve_auto(params, cfg, mode, x_shape=x_shape, x_device=x_device)


def apply(params: dict, cfg: fff_lib.FFFConfig, x: torch.Tensor,
          spec: ExecutionSpec = ExecutionSpec()
          ) -> tuple[torch.Tensor, FFFOutput]:
    """Apply one FFF layer: x (..., dim_in) -> (..., dim_out), FFFOutput.

    The master-leaf term is added here, after backend dispatch, for every
    backend except the fused decode kernel, which computes it in its single
    launch."""
    spec.validate()
    name = spec.backend
    if name == "auto":
        name = _resolve_auto(params, cfg, spec.mode, x_shape=tuple(x.shape),
                             x_device=x.device)
    y, out = get_backend(spec.mode, name)(params, cfg, x, spec)
    if cfg.master_leaf and not (name == "cuda_decode" and cfg.depth > 0):
        y = y + fff_lib.master_apply(params, cfg, x).to(y.dtype)
    return y, out


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _infer_reference(params, cfg, x, spec):
    """FORWARD_I: hard descent + exact per-token leaf evaluation."""
    y, aux = fff_lib._forward_hard_gather(params, cfg, x,
                                          dense_levels=spec.dense_levels)
    return y, FFFOutput(leaf_idx=aux["leaf_idx"], overflow_fraction=_zero(x))


def _infer_cuda(params, cfg, x, spec):
    """FORWARD_I on the CUDA kernels (counterpart of JAX ``pallas``):
    tree_router descent, then per-token gathered leaf matmuls for slabs of
    at most ``PALLAS_DECODE_MAX_TOKENS`` flattened tokens (phantom rows
    included, so the branch depends on the shape alone) and the grouped
    leaf GEMMs above.  Exact: tokens over a leaf's capacity are repaired
    densely, so overflow_fraction is 0.  ``spec.valid`` only masks the
    reported ``leaf_idx``, as in ``_infer_cuda_decode``."""
    xf, lead = utils.flatten_leading(x)
    if xf.shape[0] <= PALLAS_DECODE_MAX_TOKENS:
        y, leaf_idx = fused_ops.fff_decode(xf, params, cfg,
                                           dense_levels=spec.dense_levels,
                                           return_leaf_idx=True)
    else:
        cf = (spec.capacity_factor if spec.capacity_factor is not None
              else DEFAULT_CAPACITY_INFER)
        y, leaf_idx = gemm_ops.fff_infer(xf, params, cfg, capacity_factor=cf,
                                         dense_levels=spec.dense_levels,
                                         return_leaf_idx=True)
    return _kernel_output(cfg, x, y, leaf_idx, lead, spec.valid)


def _infer_cuda_decode(params, cfg, x, spec):
    """FORWARD_I on the one-launch fused decode kernel (counterpart of JAX
    ``pallas_decode``).  Exact for any batch; ``spec.valid`` only masks
    the reported ``leaf_idx`` to the sentinel leaf so phantom rows stay out
    of routing telemetry."""
    if cfg.depth == 0:
        return _infer_reference(params, cfg, x, spec)
    xf, lead = utils.flatten_leading(x)
    y, leaf_idx = fd_ops.fused_decode(xf, params, cfg, return_leaf_idx=True)
    return _kernel_output(cfg, x, y, leaf_idx, lead, spec.valid)


def _kernel_output(cfg, x, y, leaf_idx, lead, valid):
    """A kernel backend's (y, FFFOutput): ``valid`` masks phantom rows'
    ``leaf_idx`` to the sentinel leaf so they stay out of routing
    telemetry; outputs are per-token exact regardless."""
    if valid is not None:
        vf = torch.broadcast_to(valid.to(x.device),
                                tuple(x.shape[:-1])).reshape(-1)
        leaf_idx = torch.where(vf[:, None], leaf_idx,
                               torch.full_like(leaf_idx, cfg.num_leaves))
    return (utils.unflatten_leading(y, lead),
            FFFOutput(leaf_idx=utils.unflatten_leading(leaf_idx, lead),
                      overflow_fraction=_zero(x)))


register_backend("infer", "reference", _infer_reference)
register_backend("infer", "cuda", _infer_cuda, supports=_kernel_supported)
register_backend(
    "infer", "cuda_decode", _infer_cuda_decode,
    # the fused kernel's routing phase needs a tree to descend
    supports=lambda params, cfg: cfg.depth > 0 and _kernel_supported(params, cfg))
