"""The single FFF entry point: ``apply()`` + the execution-backend registry
(port of ``repro/core/api.py``).

    y, out = api.apply(params, cfg, x, api.ExecutionSpec(mode="infer"))

Training backends (``mode="train"``, plain PyTorch under autograd):

* ``reference``   — FORWARD_T, the paper's soft mixture over every leaf;
* ``grouped``     — the straight-through top-1 estimator over
  capacity-bounded grouped dispatch, with the differentiable einsums (the
  forward-only kernels never run in a graph).

Inference backends:

* ``reference``   — hard descent + exact per-token leaf evaluation;
* ``grouped``     — capacity-bounded grouped dispatch: per-leaf buffers of
  ``max(8, round_up(cf * tokens / leaves, 8))`` slots, the leaves run by the
  CUDA grouped GEMMs on the card; over-capacity tokens take the spec's
  overflow policy (default "drop");
* ``grouped_ep``  — expert-parallel: tokens travel over the model process
  group (``distributed/act``) to the rank owning their leaf and back;
  exact by default ("exact_dense"); one process runs it as local grouped
  dispatch plus the same repair;
* ``cuda``        — the CUDA kernel path for token batches: tree_router,
  then per-token gathered leaf matmuls for slabs of at most
  ``PALLAS_DECODE_MAX_TOKENS`` tokens and the grouped SwiGLU/MLP GEMMs
  above (counterpart of JAX ``pallas``);
* ``cuda_decode`` — the one-call fused decode kernels for seq-len-1
  batches (counterpart of JAX ``pallas_decode``).

``backend="auto"`` resolves in the JAX package's order: ``grouped_ep``
when a model group of more than one rank is installed, the kernel backends
for CUDA tensors, ``grouped`` for wide sites (``AUTO_GROUPED_MIN_WIDTH``),
else the reference.  ``overrides(backend=, capacity_factor=,
overflow_policy=)`` steers every call in its dynamic extent and nests
(inner wins per field); ``use_backend``, ``use_capacity_factor`` and
``use_overflow_policy`` are its deprecated single-field aliases.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Callable, Optional

import torch

from repro_torch import utils
from repro_torch.core import fff as fff_lib
from repro_torch.distributed import act as dist_act
from repro_torch.distributed import sharding
from repro_torch.kernels.fused_decode import ops as fd_ops
from repro_torch.kernels.fused_fff import ops as fused_ops
from repro_torch.kernels.leaf_gemm import ops as gemm_ops

MODES = ("train", "infer")

#: capacity defaults per backend (ExecutionSpec.capacity_factor=None means
#: "the backend's own default")
DEFAULT_CAPACITY_TRAIN_ST = 1.5
DEFAULT_CAPACITY_INFER = 2.0
#: grouped_ep runs Switch-style tight capacity: every slot crosses the
#: exchange twice, and exactness comes from the overflow repair
DEFAULT_CAPACITY_EP = 1.25

#: token count at or below which the cuda backend takes the per-token
#: gathered kernels instead of the sorted-dispatch grouped GEMMs (the JAX
#: package's value for its pallas backend)
PALLAS_DECODE_MAX_TOKENS = 32

#: what a capacity-bounded backend does with the tokens it drops:
#: "exact_dense" repairs them with their exact leaf output (all_gather
#: traffic under EP), "master_leaf" lets the always-on master-leaf term
#: stand in (approximate, no repair traffic, needs cfg.master_leaf), "drop"
#: leaves them at zero output
OVERFLOW_POLICIES = ("exact_dense", "master_leaf", "drop")

#: leaves x leaf width at which "auto" inference off the card switches from
#: the exact per-token evaluation to capacity-bounded grouped dispatch
AUTO_GROUPED_MIN_WIDTH = 4096


def default_capacity_factor(backend: str, mode: str = "infer") -> float:
    """The capacity factor a capacity-bounded backend runs with when
    ``ExecutionSpec.capacity_factor`` is None; consumers that predict
    dispatch behaviour (the scheduler's overflow proxy) read it here."""
    if mode == "train":
        return DEFAULT_CAPACITY_TRAIN_ST
    return DEFAULT_CAPACITY_EP if backend == "grouped_ep" \
        else DEFAULT_CAPACITY_INFER


def default_overflow_policy(backend: str) -> str:
    """The overflow policy a capacity-bounded backend runs with when
    ``ExecutionSpec.overflow_policy`` is None: grouped_ep repairs exactly,
    grouped drops."""
    return "exact_dense" if backend == "grouped_ep" else "drop"


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How to execute one FFF layer application.

    mode:            "train" (FORWARD_T semantics) | "infer" (FORWARD_I)
    backend:         registered backend name, or "auto"
    capacity_factor: per-leaf capacity multiplier of the capacity-bounded
                     backends (grouped, grouped_ep, and the cuda backend's
                     grouped GEMMs, which are exact regardless); None = the
                     backend's default (``default_capacity_factor``: 1.5
                     for the straight-through estimator, 2.0 for serving)
    overflow_policy: what a capacity-bounded backend does with the tokens
                     it drops, one of ``OVERFLOW_POLICIES``; None = the
                     backend's default (``default_overflow_policy``).
                     "master_leaf" needs ``cfg.master_leaf``.  Exact
                     backends ignore it.
    dense_levels:    tree levels routed from dense logits before per-token
                     gathers take over
    valid:           optional boolean per-token validity mask (broadcastable
                     to x's leading shape).  The capacity-bounded backends
                     route invalid tokens to the sentinel leaf, so they use
                     no capacity and count in no overflow; the kernel
                     backends only report them at the sentinel leaf.  Exact
                     backends' outputs are per-token exact regardless.
    rng:             ``torch.Generator`` for the stochastic training
                     feature (child transposition,
                     ``cfg.transposition_prob``) on x's device; unused by
                     inference backends
    """
    mode: str = "infer"
    backend: str = "auto"
    capacity_factor: Optional[float] = None
    overflow_policy: Optional[str] = None
    dense_levels: int = 8
    valid: Optional[torch.Tensor] = None
    rng: Optional[torch.Generator] = None

    def validate(self) -> "ExecutionSpec":
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if (self.overflow_policy is not None
                and self.overflow_policy not in OVERFLOW_POLICIES):
            raise ValueError(
                f"overflow_policy must be one of {OVERFLOW_POLICIES} or None, "
                f"got {self.overflow_policy!r}")
        return self


@dataclasses.dataclass(frozen=True)
class FFFOutput:
    """Structured aux returned by every backend; fields a backend cannot
    produce are None (hard inference has no node probabilities, FORWARD_T
    no leaf indices).

    leaf_idx:          (..., trees) int32 — routed leaf per (token, tree)
    node_probs:        (B, trees, num_nodes) — sigmoid node outputs
    mixture:           (B, trees, num_leaves) — FORWARD_T leaf weights
    entropy:           scalar — mean Bernoulli entropy of node decisions
    overflow_fraction: scalar — fraction of slots dropped by a capacity
                       bound (0 for exact paths)
    """
    leaf_idx: Optional[torch.Tensor] = None
    node_probs: Optional[torch.Tensor] = None
    mixture: Optional[torch.Tensor] = None
    entropy: Optional[torch.Tensor] = None
    overflow_fraction: Optional[torch.Tensor] = None

    def as_dict(self) -> dict:
        """The aux-dict view of the fields the backend produced (the
        tensors themselves, no copies)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


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


def overrides(*, backend: Optional[str] = None, mode: Optional[str] = None,
              capacity_factor: Optional[float] = None,
              overflow_policy: Optional[str] = None):
    """One composable override context for ``apply()`` in this thread.

    ``backend`` steers every ``backend="auto"`` apply() to the named
    backend (restricted to ``mode`` when given); explicit specs are
    unaffected, and sites where the backend is missing or fails its
    ``supports`` predicate fall through to the auto heuristics.  A name
    registered for no mode raises up front.  ``capacity_factor`` and
    ``overflow_policy`` fill in every spec that leaves its own unset;
    explicit per-spec values win (the engine's verify slab scales its
    capacity this way).

    Contexts nest: each saves and restores exactly the fields it sets, so
    an inner context wins per field and unrelated fields compose.
    Validation is eager: bad arguments raise at the call."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode is not None and backend is None:
        raise ValueError("mode= only restricts a backend override; pass "
                         "backend= as well")
    if backend is not None and not any(n == backend for _, n in _REGISTRY):
        raise KeyError(f"no backend {backend!r} registered for any mode; "
                       f"available: {list_backends()}")
    if capacity_factor is not None:
        capacity_factor = float(capacity_factor)
        if capacity_factor <= 0:
            raise ValueError(
                f"capacity factor must be positive, got {capacity_factor}")
    if overflow_policy is not None and overflow_policy not in OVERFLOW_POLICIES:
        raise ValueError(f"overflow_policy must be one of {OVERFLOW_POLICIES},"
                         f" got {overflow_policy!r}")
    sets = []
    if backend is not None:
        sets.append(("override", (backend, mode)))
    if capacity_factor is not None:
        sets.append(("capacity_override", capacity_factor))
    if overflow_policy is not None:
        sets.append(("overflow_override", overflow_policy))

    @contextlib.contextmanager
    def _installed():
        prev = [(a, getattr(_thread_state, a, None)) for a, _ in sets]
        for a, v in sets:
            setattr(_thread_state, a, v)
        try:
            yield
        finally:
            for a, v in prev:
                setattr(_thread_state, a, v)

    return _installed()


_CONTEXT_FIELDS = ("override", "capacity_override", "overflow_override",
                   "routing")


def thread_context() -> tuple:
    """This thread's overrides, routing tap, installed process groups and
    parameter placements, for ``context_installed`` to reinstate in
    another thread: autograd runs a CUDA backward, and with it the
    recompute of a checkpointed layer, in a thread of its own, where these
    thread-local settings are unset."""
    return ({f: getattr(_thread_state, f, None) for f in _CONTEXT_FIELDS},
            dist_act.current_groups() if dist_act.mesh_installed() else None,
            sharding.current_placements())


@contextlib.contextmanager
def context_installed(ctx: tuple):
    """Install a ``thread_context()`` for the dynamic extent of the block."""
    fields, groups, placements = ctx
    prev = {f: getattr(_thread_state, f, None) for f in _CONTEXT_FIELDS}
    for f, v in fields.items():
        setattr(_thread_state, f, v)
    try:
        with dist_act.groups_installed(groups), \
                sharding.use_placements(placements):
            yield
    finally:
        for f, v in prev.items():
            setattr(_thread_state, f, v)


def _deprecated_alias(old: str, new: str) -> None:
    warnings.warn(f"api.{old} is deprecated; use api.{new}",
                  DeprecationWarning, stacklevel=3)


def use_backend(name: str, mode: Optional[str] = None):
    """Deprecated alias for ``overrides(backend=name, mode=mode)``."""
    _deprecated_alias("use_backend(name)", "overrides(backend=name)")
    return overrides(backend=name, mode=mode)


def use_capacity_factor(cf: float):
    """Deprecated alias for ``overrides(capacity_factor=cf)``."""
    _deprecated_alias("use_capacity_factor(cf)", "overrides(capacity_factor=cf)")
    return overrides(capacity_factor=cf)


def use_overflow_policy(policy: str):
    """Deprecated alias for ``overrides(overflow_policy=policy)``."""
    _deprecated_alias("use_overflow_policy(policy)",
                      "overrides(overflow_policy=policy)")
    return overrides(overflow_policy=policy)


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
    """Backend choice for ``backend="auto"``, in the JAX package's order:
    an eligible override; for inference, ``grouped_ep`` when a model group
    of more than one rank is installed and the leaves divide over it; on a
    CUDA tensor the fused decode kernel for seq-len-1 shapes and the kernel
    path otherwise (neither under an installed group); ``grouped`` for wide
    sites (``num_leaves * leaf_width >= AUTO_GROUPED_MIN_WIDTH``); the exact
    reference for the rest and for depth-0 sites."""
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
    if (dist_act.model_shard_count() > 1
            and _backend_supported("infer", "grouped_ep", params, cfg)):
        return "grouped_ep"
    on_cuda = _kernels_native(x_device)
    if (on_cuda and x_shape is not None and len(x_shape) >= 3
            and x_shape[-2] == 1
            and _backend_supported("infer", "cuda_decode", params, cfg)):
        return "cuda_decode"
    if on_cuda and _backend_supported("infer", "cuda", params, cfg):
        return "cuda"
    if cfg.num_leaves * cfg.leaf_width >= AUTO_GROUPED_MIN_WIDTH:
        return "grouped"
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

    Installed capacity and overflow overrides fill in the spec's unset
    fields.  The master-leaf term is added here, after backend dispatch,
    for every backend except the fused decode kernel, which computes it in
    its single launch."""
    cf = getattr(_thread_state, "capacity_override", None)
    if cf is not None and spec.capacity_factor is None:
        spec = dataclasses.replace(spec, capacity_factor=cf)
    op = getattr(_thread_state, "overflow_override", None)
    if op is not None and spec.overflow_policy is None:
        spec = dataclasses.replace(spec, overflow_policy=op)
    spec.validate()
    if spec.overflow_policy == "master_leaf" and not cfg.master_leaf:
        raise ValueError(
            'overflow_policy="master_leaf" requires cfg.master_leaf=True: '
            "without the always-on master term, dropped tokens would "
            'silently degrade to zeros (use "drop" to ask for that)')
    name = spec.backend
    if name == "auto":
        name = _resolve_auto(params, cfg, spec.mode, x_shape=tuple(x.shape),
                             x_device=x.device)
    if name != "grouped_ep":
        # leaves stored sharded over the model axis are whole for the rest
        params = sharding.whole_leaves(params, cfg.num_leaves)
    y, out = get_backend(spec.mode, name)(params, cfg, x, spec)
    if cfg.master_leaf and not (name == "cuda_decode" and cfg.depth > 0):
        y = y + fff_lib.master_apply(params, cfg, x).to(y.dtype)
    return y, out


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _train_reference(params, cfg, x, spec):
    """FORWARD_T: the soft mixture over all leaves (paper Algorithm 1)."""
    y, aux = fff_lib._forward_soft_mixture(params, cfg, x, gen=spec.rng)
    return y, FFFOutput(node_probs=aux["node_probs"], mixture=aux["mixture"],
                        entropy=aux["entropy"])


def _train_grouped(params, cfg, x, spec):
    """Straight-through top-1 training over capacity-bounded grouped
    dispatch (O(l) leaf cost per token), on the differentiable einsums."""
    cf = (spec.capacity_factor if spec.capacity_factor is not None
          else DEFAULT_CAPACITY_TRAIN_ST)
    y, aux = fff_lib._forward_st_grouped(params, cfg, x, gen=spec.rng,
                                         capacity_factor=cf)
    return y, FFFOutput(leaf_idx=aux["leaf_idx"],
                        node_probs=aux["node_probs"], mixture=aux["mixture"],
                        entropy=aux["entropy"],
                        overflow_fraction=aux["overflow_fraction"])


def _infer_reference(params, cfg, x, spec):
    """FORWARD_I: hard descent + exact per-token leaf evaluation."""
    y, aux = fff_lib._forward_hard_gather(params, cfg, x,
                                          dense_levels=spec.dense_levels)
    return y, FFFOutput(leaf_idx=aux["leaf_idx"], overflow_fraction=_zero(x))


def _infer_grouped(params, cfg, x, spec):
    """FORWARD_I via capacity-bounded grouped dispatch;
    ``spec.overflow_policy`` governs dropped tokens (default "drop")."""
    cf = (spec.capacity_factor if spec.capacity_factor is not None
          else default_capacity_factor("grouped"))
    policy = (spec.overflow_policy if spec.overflow_policy is not None
              else default_overflow_policy("grouped"))
    y, aux = fff_lib._forward_hard_grouped(
        params, cfg, x, capacity_factor=cf, dense_levels=spec.dense_levels,
        valid=spec.valid, overflow_policy=policy)
    return y, FFFOutput(leaf_idx=aux["leaf_idx"],
                        overflow_fraction=aux["overflow_fraction"])


def _infer_grouped_ep(params, cfg, x, spec):
    """FORWARD_I via expert-parallel all_to_all dispatch over the installed
    model group.  Exact under the default "exact_dense"; "master_leaf" and
    "drop" skip the repair round.  One process (no group installed) runs
    local grouped dispatch with the same policy."""
    cf = (spec.capacity_factor if spec.capacity_factor is not None
          else default_capacity_factor("grouped_ep"))
    policy = (spec.overflow_policy if spec.overflow_policy is not None
              else default_overflow_policy("grouped_ep"))
    y, aux = fff_lib._forward_hard_ep(
        params, cfg, x, capacity_factor=cf, dense_levels=spec.dense_levels,
        valid=spec.valid, overflow_policy=policy)
    return y, FFFOutput(leaf_idx=aux["leaf_idx"],
                        overflow_fraction=aux["overflow_fraction"])


def _infer_cuda(params, cfg, x, spec):
    """FORWARD_I on the CUDA kernels (counterpart of JAX ``pallas``):
    tree_router descent, then per-token gathered leaf matmuls for slabs of
    at most ``PALLAS_DECODE_MAX_TOKENS`` flattened tokens (phantom rows
    included, so the branch depends on the shape alone) and the grouped
    leaf GEMMs above.  Exact: tokens over a leaf's capacity take an
    overflow pass on the same grouped GEMMs, sized by the token count
    alone, so overflow_fraction is 0 and neither branch reads a value on
    the host (the dispatch can be captured as a CUDA graph).
    ``spec.valid`` masks the reported ``leaf_idx``, as in
    ``_infer_cuda_decode``, and in the grouped branch lets phantom rows
    take only the capacity the valid rows leave, so a valid row's output
    never depends on a phantom row's content."""
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
                                         return_leaf_idx=True,
                                         valid=_flat_valid(x, spec.valid))
    return _kernel_output(cfg, x, y, leaf_idx, lead, spec.valid)


def _infer_cuda_decode(params, cfg, x, spec):
    """FORWARD_I on the one-call fused decode kernels (counterpart of JAX
    ``pallas_decode``).  Exact for any batch; ``spec.valid`` only masks
    the reported ``leaf_idx`` to the sentinel leaf so phantom rows stay out
    of routing telemetry."""
    if cfg.depth == 0:
        return _infer_reference(params, cfg, x, spec)
    xf, lead = utils.flatten_leading(x)
    y, leaf_idx = fd_ops.fused_decode(xf, params, cfg, return_leaf_idx=True)
    return _kernel_output(cfg, x, y, leaf_idx, lead, spec.valid)


def _flat_valid(x: torch.Tensor, valid: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
    """``spec.valid`` broadcast over x's leading dims, flattened (or None)."""
    if valid is None:
        return None
    return torch.broadcast_to(valid.to(x.device), tuple(x.shape[:-1])).reshape(-1)


def _kernel_output(cfg, x, y, leaf_idx, lead, valid):
    """A kernel backend's (y, FFFOutput): ``valid`` masks phantom rows'
    ``leaf_idx`` to the sentinel leaf so they stay out of routing
    telemetry; outputs are per-token exact regardless."""
    if valid is not None:
        vf = _flat_valid(x, valid)
        leaf_idx = torch.where(vf[:, None], leaf_idx,
                               torch.full_like(leaf_idx, cfg.num_leaves))
    return (utils.unflatten_leading(y, lead),
            FFFOutput(leaf_idx=utils.unflatten_leading(leaf_idx, lead),
                      overflow_fraction=_zero(x)))


register_backend("train", "reference", _train_reference)
register_backend("train", "grouped", _train_grouped)
register_backend("infer", "reference", _infer_reference)
register_backend("infer", "grouped", _infer_grouped)
register_backend(
    "infer", "grouped_ep", _infer_grouped_ep,
    # auto and overrides: a model group to exchange over and leaves that
    # divide across it (an explicit spec still runs, on one process)
    supports=lambda params, cfg: (
        cfg.depth > 0 and dist_act.model_shard_count() > 1
        and cfg.num_leaves % dist_act.model_shard_count() == 0))
# the kernel backends are single-device: never under an installed group
register_backend("infer", "cuda", _infer_cuda,
                 supports=lambda params, cfg: (_kernel_supported(params, cfg)
                                               and not dist_act.mesh_installed()))
register_backend(
    "infer", "cuda_decode", _infer_cuda_decode,
    # the fused kernel's routing phase needs a tree to descend
    supports=lambda params, cfg: (cfg.depth > 0 and _kernel_supported(params, cfg)
                                  and not dist_act.mesh_installed()))
