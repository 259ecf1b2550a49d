"""Parameter and cache sharding rules (port of
``repro/distributed/sharding.py``), and the per-rank storage they give.

Rules are (regex over the parameter path) -> axis assignment, evaluated in
order; the first match wins.  Axis placeholders:

  MODEL  -> the "model" axis (TP / EP)
  FSDP   -> the compound batch axes ("pod", "data"): ZeRO-3 parameter
            sharding, gathered per layer
  None   -> replicated

A spec is a tuple with one entry per dimension: None, an axis name, or a
tuple of axis names (a dimension split over several axes, the first
outermost).  Conventions of the parameter tree (the JAX package's, less
its leading ``n_periods`` axis, which the port's one-dict-per-layer stack
does not have and JAX never shards):

  fff leaf weights (T, L, D, l)       -> L on MODEL (EP), D FSDP
  moe expert weights (E, D, H)        -> E on MODEL (EP), D FSDP
  attention wq/wk/wv (D, H, hd)       -> H on MODEL (TP), D FSDP
  mamba/mlstm in/up projections (D, E)  -> E on MODEL (column)
  mamba/mlstm out/down projections (E, D) -> E on MODEL (row)
  embeddings (V, D)                   -> V on MODEL

Storage.  Training (``launch/train``): ``Placements.of`` places every
tensor of a parameter tree by the rules and ``shard_params`` keeps each
rank's slices.  The forward path gathers a layer's sharded tensors just
before the layer runs (``gathered``: ``nn/transformer.stack_forward`` per
layer, ``models/lm`` for the embedding, the head and the frontends), under
``use_placements`` of that tree, and drops the whole tensors after it.
The gather is an autograd function: its backward sums the gradient over
the data axes (those ranks saw other tokens) and keeps this rank's slice
over the model axis (those ranks saw the same tokens).  So the model axis
replicates the compute of the JAX package's tensor-parallel heads and
columns, with the same numbers.  Serving (``serve --model-parallel``):
``shard_leaves`` cuts only the FFF leaves that divide over the model axis,
which ``grouped_ep`` reads as each rank's own; every other tensor stays
whole on each rank, so a serving pass gathers nothing.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import utils
from repro_torch.distributed import act as dist_act
from repro_torch.distributed import collectives
from repro_torch.distributed.layout import data_axes, world_rank

PyTree = Any

MODEL = "__model__"
FSDP = "__fsdp__"

# (path regex, LIST of candidate per-dimension assignments aligned to the
# LAST len(spec) dims; the first candidate whose sharded dims all divide is
# used).  Unmatched leading dims are replicated.  Expert/leaf weights fall
# back to tensor parallelism over the hidden width when the expert count
# doesn't divide the model axis (e.g. olmoe's 8 leaves a tree on a 16-way
# axis).
PARAM_RULES: list[tuple[str, tuple]] = [
    # --- FFF ---
    (r".*leaf_w[gu1]$", ((MODEL, FSDP, None),          # (T,L,D,l): L on model
                         (None, FSDP, MODEL))),        # fallback: l column-TP
    (r".*leaf_w[d2]$", ((MODEL, None, FSDP),           # (T,L,l,O): L on model
                        (None, MODEL, FSDP))),         # fallback: l row-TP
    (r".*leaf_b[12]$", ((MODEL, None),)),              # (T,L,l)
    (r".*node_w1$", ((None, FSDP, None),)),            # (T,N,D,n)
    (r".*node_(b1|w2|b2)$", ((None, None),)),
    # master leaf: one small always-on MLP, no tree/leaf axis; every token
    # needs it, so it stays off the model axis (FSDP only)
    (r".*master_w[gu1]$", ((FSDP, None),)),            # (D,mw)
    (r".*master_w[d2]$", ((None, FSDP),)),             # (mw,O)
    # --- MoE ---
    (r".*expert_w1$", ((MODEL, FSDP, None),            # (E,D,H)
                       (None, FSDP, MODEL))),
    (r".*expert_w2$", ((MODEL, None, FSDP),            # (E,H,O)
                       (None, MODEL, FSDP))),
    (r".*expert_b[12]$", ((MODEL, None),)),
    (r".*(gate_w|noise_w)$", ((FSDP, None),)),
    # --- dense FF (megatron column/row) ---
    (r".*ffn/w(g|u|1)$", ((FSDP, MODEL),)),            # (D,H)
    (r".*ffn/w(d|2)$", ((MODEL, FSDP),)),              # (H,D)
    (r".*ffn/b1$", ((MODEL,),)),
    (r".*ffn/b2$", ((None,),)),
    # --- attention ---
    (r".*(mixer|cross)/w[qkv]$", ((FSDP, MODEL, None),  # (D,H,hd) heads model
                                  (FSDP, None, MODEL))),  # fallback: hd TP
    (r".*(mixer|cross)/wo$", ((MODEL, None, FSDP),      # (H,hd,D)
                              (None, MODEL, FSDP))),
    (r".*(mixer|cross)/b[qkv]$", ((MODEL, None),)),
    (r".*(mixer|cross)/bo$", ((None,),)),
    # --- mamba ---
    (r".*mixer/in_proj$", ((FSDP, MODEL),)),
    (r".*mixer/out_proj$", ((MODEL, FSDP),)),
    (r".*mixer/(conv_w|conv_b|dt_bias|A_log|D_skip)$", ((None, MODEL),)),
    (r".*mixer/x_proj$", ((MODEL, None),)),
    (r".*mixer/dt_proj$", ((None, MODEL),)),
    # --- xlstm ---
    (r".*mixer/up_proj$", ((FSDP, MODEL),)),
    (r".*mixer/down_proj$", ((MODEL, FSDP),)),
    (r".*mixer/w[qkv]$", ((MODEL, None, None),)),       # (DI,H,hd)->DI model
    (r".*mixer/w_if$", ((MODEL, None),)),
    (r".*mixer/w_h$", ((None, None, None),)),
    (r".*mixer/(b_if|b|gn_scale)$", ((None,),)),
    (r".*mixer/w_x$", ((FSDP, MODEL),)),
    # --- embeddings / head / frontends ---
    (r".*embed/tok$", ((MODEL, FSDP),)),                # (V,D) vocab-sharded
    (r".*embed/head$", ((FSDP, MODEL),)),
    (r".*pos/pos$", ((None, None),)),
    (r".*frontend/proj$", ((None, MODEL),)),
    (r".*frontend/bias$", ((MODEL,),)),
    # --- norms & fallback ---
    (r".*(norm|scale|bias).*", ()),
    (r".*", ()),
]

#: the leaf tensors ``grouped_ep`` reads sharded (leaf axis 1 on the model axis)
_EP_LEAF = re.compile(r".*ffn/leaf_")


def _batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _try_resolve(assign: tuple, ndim: int, mesh, shape: tuple
                 ) -> tuple[tuple, bool]:
    """Align the rule to the trailing dims; replicate leading dims.
    Returns (spec, complete): complete is False if a requested sharding
    had to be dropped for divisibility (a fallback candidate should be
    tried).  ``mesh`` needs only ``axis_names`` and ``shape`` (axis ->
    size)."""
    batch_axes = _batch_axes(mesh)
    fsdp_size = math.prod(mesh.shape[a] for a in batch_axes) if batch_axes else 1
    model_size = mesh.shape.get("model", 1)
    out: list = [None] * ndim
    complete = True
    k = ndim - len(assign)
    for i, a in enumerate(assign):
        if k + i < 0:
            continue
        dim = shape[k + i]
        if a == MODEL:
            if "model" in mesh.axis_names and dim % model_size == 0 \
                    and dim >= model_size:
                out[k + i] = "model"
            elif "model" in mesh.axis_names:
                complete = False
        elif a == FSDP:
            if batch_axes and dim % fsdp_size == 0 and dim >= fsdp_size:
                out[k + i] = batch_axes if len(batch_axes) > 1 \
                    else batch_axes[0]
            elif batch_axes:
                complete = False
    return tuple(out), complete


def spec_for_path(path: str, ndim: int, mesh, shape: tuple,
                  fsdp: bool = True) -> tuple:
    for pattern, candidates in PARAM_RULES:
        if re.match(pattern, path):
            if not candidates:
                return (None,) * ndim
            best = (None,) * ndim
            for assign in candidates:
                if not fsdp:
                    assign = tuple(None if a == FSDP else a for a in assign)
                spec, complete = _try_resolve(assign, ndim, mesh, shape)
                if complete:
                    return spec
                if best.count(None) == len(best):
                    best = spec
            return best
    return (None,) * ndim


def path_of(key_path) -> str:
    """A path (a sequence of dict keys and list indices) as ``a/0/b``."""
    return "/".join(str(p) for p in key_path)


def param_specs(params: PyTree, mesh, fsdp: bool = True) -> PyTree:
    """The spec tree matching ``params`` (leaves: anything with a
    ``shape``, e.g. tensors or numpy arrays).

    fsdp=True  -> ZeRO-3 layout (params sharded over the batch axes too)
    fsdp=False -> ZeRO-1 layout (params model-sharded, data-replicated)"""
    return utils.tree_map_with_paths(
        lambda p, t: spec_for_path(p, len(t.shape), mesh, tuple(t.shape),
                                   fsdp=fsdp), params)


# ---------------------------------------------------------------------------
# cache specs for serving
# ---------------------------------------------------------------------------

def cache_specs(caches: PyTree, mesh, batch: int, *,
                seq_shard_below_batch: bool = True) -> PyTree:
    """The layout of the serving caches (``lm.init_caches``' per-layer
    list): batch on the data axes when divisible; for tiny batches
    (long-context decode) the sequence dim instead.

    A paged KV pool (num_pages + 1, page, K, hd) is laid out by its
    ``num_pages`` real pages: the page axis plays the batch axis's part
    (pages are independent), sharded over the data axes when the page count
    divides them (the contiguous layout's pool is one page a row,
    num_pages == B).  The model axis carries the KV heads when they divide
    it, else the within-page sequence dim (context parallelism).  The sink
    page stays on every rank.  Per-row state (lengths, tables, recurrent
    state) is batch-sharded when divisible.  The specs are the JAX
    package's less its leading n_periods axis."""
    batch_axes = _batch_axes(mesh)
    fsdp_size = math.prod(mesh.shape[a] for a in batch_axes) if batch_axes else 1
    dp = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes
                                                 else None)
    model_size = mesh.shape.get("model", 1)

    def kv_spec(shape):
        # shape: (num_pages, page, K, hd), the real pages
        m_k = m_s = None
        if "model" in mesh.axis_names:
            if shape[2] % model_size == 0 and shape[2] >= model_size:
                m_k = "model"
            elif shape[1] % model_size == 0 and shape[1] >= model_size:
                m_s = "model"
        if shape[0] % fsdp_size == 0 and shape[0] >= fsdp_size:
            return (dp, m_s, m_k, None)
        if seq_shard_below_batch and shape[1] % fsdp_size == 0 \
                and shape[1] >= fsdp_size:
            dp_s = (dp if isinstance(dp, tuple) else (dp,)) + \
                ((m_s,) if m_s else ())
            return (None, dp_s, m_k, None)
        return (None, m_s, m_k, None)

    def spec(path, leaf):
        if not hasattr(leaf, "shape"):
            return leaf                  # a KVCache's ``paged`` flag
        shape = tuple(leaf.shape)
        nd = len(shape)
        is_kv = path.endswith(("/k", "/v")) or "cross_" in path
        if is_kv and nd == 4:
            if "cross_" not in path and _paged(caches, path):
                shape = (shape[0] - 1,) + shape[1:]
            return kv_spec(shape)
        if nd >= 1 and shape[0] == batch and batch % fsdp_size == 0 \
                and batch >= fsdp_size:
            return (dp,) + (None,) * (nd - 1)
        return (None,) * nd

    return utils.tree_map_with_paths(spec, caches)


def _paged(caches, path: str) -> bool:
    """Whether the KV cache holding ``path`` (``i/kv/k``) is a paged pool."""
    node = caches
    for part in path.split("/")[:-1]:
        node = node[int(part)] if isinstance(node, list) else node[part]
    return bool(getattr(node, "paged", False))


# ---------------------------------------------------------------------------
# per-rank storage
# ---------------------------------------------------------------------------

class Placement(NamedTuple):
    """Where one tensor's slices lie: its spec and its whole shape."""
    spec: tuple
    shape: tuple

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.spec)


def _axes(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def local_shape(pl: Placement, mesh) -> tuple:
    return tuple(d // math.prod(mesh.shape[a] for a in _axes(e))
                 for d, e in zip(pl.shape, pl.spec))


def slice_for(t: torch.Tensor, spec: tuple, layout,
              rank: Optional[int] = None) -> torch.Tensor:
    """This rank's slice of a whole tensor under ``spec`` (a view)."""
    rank = world_rank() if rank is None else rank
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = math.prod(layout.shape[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * layout.shape[a] + layout.axis_index(a, rank)
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t


def _cut(t: torch.Tensor, spec: tuple, layout, rank) -> torch.Tensor:
    return slice_for(t, spec, layout, rank).clone(
        memory_format=torch.contiguous_format)


class Placements:
    """Where the tensors of one parameter tree lie over ``layout``: each
    tensor's ``Placement`` by its path in the tree.  Made from the whole
    tree (``of``); it cuts the tree into a rank's slices (``shard``) and
    rebuilds whole tensors from them (``gather``; per layer, ``gathered``
    under ``use_placements``).  It belongs to that tree alone: another
    tree (a draft model's) has placements of its own or none."""

    def __init__(self, layout, by_path: dict):
        self.layout, self.by_path = layout, by_path

    @classmethod
    def of(cls, params: PyTree, layout, fsdp: bool = True) -> "Placements":
        """The rules' placements of ``params`` (whole tensors) on ``layout``
        (``fsdp``: ZeRO-3, see ``param_specs``)."""
        return cls(layout, {
            path: Placement(spec_for_path(path, t.ndim, layout, tuple(t.shape),
                                          fsdp=fsdp), tuple(t.shape))
            for path, t in utils.tree_leaves_with_paths(params)})

    def find(self, path: str) -> Optional[Placement]:
        """The placement of ``path`` or, failing that, of its longest
        suffix with one (an optimizer moment ``opt/mu/<param path>`` or a
        checkpoint's ``params/<param path>`` finds its parameter's)."""
        parts = path.split("/")
        for i in range(len(parts)):
            pl = self.by_path.get("/".join(parts[i:]))
            if pl is not None:
                return pl
        return None

    def is_slice(self, path: str, t) -> bool:
        """Whether ``t`` at ``path`` is this rank's slice of a sharded
        tensor (not the whole tensor)."""
        pl = self.find(path)
        return (pl is not None and pl.sharded and isinstance(t, torch.Tensor)
                and tuple(t.shape) == local_shape(pl, self.layout))

    def shard(self, tree: PyTree, rank: Optional[int] = None) -> PyTree:
        """Each whole sharded tensor of ``tree`` cut to ``rank``'s slice
        (default this process's), contiguous, on its device; the rest as
        it is."""
        rank = world_rank() if rank is None else rank

        def one(path, t):
            pl = self.find(path)
            if (pl is None or not pl.sharded or not isinstance(t, torch.Tensor)
                    or tuple(t.shape) != pl.shape):
                return t
            return _cut(t, pl.spec, self.layout, rank)

        return utils.tree_map_with_paths(one, tree)

    def gather(self, tree: PyTree) -> PyTree:
        """The whole tensors of a tree of this rank's slices (parameters,
        or a tree holding them such as ``{"params", "opt"}``), no gradient.
        Every rank of the layout must call it."""
        def one(path, t):
            if not self.is_slice(path, t):
                return t
            with torch.no_grad():
                return gather_tensor(t, self.find(path), self.layout)
        return utils.tree_map_with_paths(one, tree)

    def spec_fn(self, path: str, leaf) -> tuple:
        """``path``'s spec (replicated without a placement), as
        ``checkpoint/elastic.reshard_restore`` takes it."""
        pl = self.find(path)
        return pl.spec if pl is not None else (None,) * leaf.ndim

    def whole_like(self, tree: PyTree) -> PyTree:
        """Stand-ins of the whole tensors of a tree of this rank's slices:
        host tensors of the whole shape, in each leaf's dtype, that own no
        memory (what a restore reads into)."""
        def one(path, t):
            if not isinstance(t, torch.Tensor):
                return t
            shape = self.find(path).shape if self.is_slice(path, t) else t.shape
            return torch.empty((), dtype=t.dtype).expand(tuple(shape))
        return utils.tree_map_with_paths(one, tree)


def shard_params(params: PyTree, layout, fsdp: bool = True,
                 rank: Optional[int] = None) -> PyTree:
    """Each rank's slice of every tensor of ``params`` (whole tensors, e.g.
    ``lm.init``'s, the same on every rank), contiguous, on the tensors'
    device; replicated tensors are returned as they are.
    ``Placements.of(params, layout, fsdp)`` says where each slice lies."""
    return Placements.of(params, layout, fsdp).shard(params, rank)


def gather_params(tree: PyTree, placements: Placements) -> PyTree:
    """``placements.gather(tree)``: the whole tensors of a rank's slices."""
    return placements.gather(tree)


def _step(layout, dim: int, axis: str) -> tuple:
    """One all_gather of a tensor's rebuild: (dim, the axis's group, this
    rank's index on it, its rank count, whether it is a data axis)."""
    return (dim, layout.groups()[axis], layout.axis_index(axis, world_rank()),
            layout.shape[axis], axis in data_axes(layout))


def _steps(pl: Placement, layout) -> tuple:
    """The all_gathers that rebuild a tensor, minor axis of a compound dim
    first."""
    return tuple(_step(layout, dim, a) for dim, entry in enumerate(pl.spec)
                 for a in reversed(_axes(entry)))


class _Gather(torch.autograd.Function):
    """This rank's slice -> the whole tensor; backward: sum over the data
    axes, then this rank's slice."""

    @staticmethod
    def forward(ctx, t, steps):
        ctx.steps = steps
        for dim, group, _, _, _ in steps:
            t = collectives.all_gather_cat(t, group, dim)
        return t

    @staticmethod
    def backward(ctx, g):
        for dim, group, idx, n, over_data in reversed(ctx.steps):
            if over_data:
                g = collectives.all_reduce(g, group)
            size = g.shape[dim] // n
            g = g.narrow(dim, idx * size, size)
        return g.contiguous(), None


def gather_tensor(t: torch.Tensor, pl: Placement, layout) -> torch.Tensor:
    return _Gather.apply(t, _steps(pl, layout))


_state = threading.local()


def current_placements() -> Optional[Placements]:
    """The placements installed in this thread (None when none are)."""
    return getattr(_state, "placements", None)


@contextlib.contextmanager
def use_placements(placements: Optional[Placements]):
    """Install the placements of the parameter tree the block runs on
    (``gathered`` reads them) for this thread.  None installs nothing.
    Contexts nest."""
    prev = current_placements()
    _state.placements = placements
    try:
        yield
    finally:
        _state.placements = prev


def gathered(tree: PyTree, prefix: str) -> PyTree:
    """``tree`` (the subtree of the installed placements' parameters at
    ``prefix``) with every tensor this rank holds a slice of replaced by
    the whole tensor (``_Gather``: differentiable); the tree itself when no
    placements are installed."""
    pls = current_placements()
    if pls is None:
        return tree

    def one(path, t):
        return (gather_tensor(t, pls.find(path), pls.layout)
                if pls.is_slice(path, t) else t)

    return utils.tree_map_with_paths(one, tree, prefix)


# ---------------------------------------------------------------------------
# expert-parallel serving storage
# ---------------------------------------------------------------------------

#: an FFF site's leaf tensors, (T, L, ...): ``grouped_ep`` reads them
#: sharded on the leaf axis L
_EP_LEAF = re.compile(r".*ffn/leaf_")


def shard_leaves(params: PyTree, layout, rank: Optional[int] = None) -> PyTree:
    """The serving storage of ``params`` (whole) on ``layout``: each FFF
    site's leaf tensors cut on the leaf axis over the model axis, as the
    rules place them (without ``fsdp``), where the leaves divide over it;
    every other tensor whole.  ``grouped_ep`` reads those leaves as they
    are; ``whole_leaves`` rebuilds them for any other backend."""
    rank = world_rank() if rank is None else rank

    def one(path, t):
        if not _EP_LEAF.match(path):
            return t
        spec = spec_for_path(path, t.ndim, layout, tuple(t.shape), fsdp=False)
        if (len(spec) < 2 or spec[1] != "model"
                or any(a is not None for i, a in enumerate(spec) if i != 1)):
            return t
        return _cut(t, spec, layout, rank)

    return utils.tree_map_with_paths(one, params)


def whole_leaves(params: dict, num_leaves: int) -> dict:
    """One FFF site's parameters with leaf tensors that hold fewer than
    ``num_leaves`` leaves (``shard_leaves``' storage) gathered whole over
    the installed model group (``distributed/act``), for a backend other
    than ``grouped_ep``."""
    held = {v.shape[1] for k, v in params.items() if k.startswith("leaf_")}
    if held <= {num_leaves}:
        return params
    model = dist_act.current_groups()[0]
    if model is None:
        raise ValueError(f"leaf tensors hold {sorted(held)} of {num_leaves} "
                         f"leaves, and no model group is installed")
    return {k: (collectives.all_gather_cat(v, model, dim=1)
                if k.startswith("leaf_") and v.shape[1] != num_leaves else v)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# data-parallel gradients
# ---------------------------------------------------------------------------

def _covered(pl: Optional[Placement]) -> set:
    return set() if pl is None else {a for e in pl.spec for a in _axes(e)}


def reduce_gradients(grads: PyTree, placements: Placements) -> PyTree:
    """Each rank's gradients (of its slices, summed over the data axes its
    tensor is sharded on by the gather's backward) -> the mean over every
    data rank's tokens: summed over the data axes the gather did not cover,
    divided by the data ranks."""
    layout = placements.layout
    g = layout.groups()
    data = data_axes(layout)
    n = math.prod(layout.shape[a] for a in data)

    def one(path, t):
        rest = [a for a in data if a not in _covered(placements.find(path))]
        for a in rest:
            t = collectives.all_reduce(t, g[a])
        return t / n

    return utils.tree_map_with_paths(one, grads)


def data_mean(values: dict, layout) -> dict:
    """Each tensor of ``values`` (per-rank scalars such as losses) averaged
    over the data ranks."""
    g = layout.groups()
    data = data_axes(layout)
    n = math.prod(layout.shape[a] for a in data)

    def one(t):
        for a in data:
            t = collectives.all_reduce(t, g[a])
        return t / n

    return {k: one(v) for k, v in values.items()}


def global_norm(grads: PyTree, placements: Placements) -> torch.Tensor:
    """The L2 norm of the whole gradient from each rank's slices: a
    tensor's squared sum is summed over the axes it is sharded on and
    counted once over the rest (float32)."""
    layout = placements.layout
    g = layout.groups()
    buckets: dict = {}
    for path, t in utils.tree_leaves_with_paths(grads):
        key = tuple(a for a in layout.axis_names
                    if a in _covered(placements.find(path)))
        sq = t.float().square().sum()
        buckets[key] = sq if key not in buckets else buckets[key] + sq
    total = None
    for key in sorted(buckets):
        s = buckets[key]
        for a in key:
            s = collectives.all_reduce(s, g[a])
        total = s if total is None else total + s
    return total.sqrt()
