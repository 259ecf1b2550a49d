"""Small shared utilities (port of ``repro/utils.py``): shape helpers, the
activation table, initializers on an explicit ``torch.Generator``, the
pytree helpers the optimizers walk parameter trees with, the config and
size-formatting helpers, and the device check every entry point runs."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 2 ** math.ceil(math.log2(x))


def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def flatten_leading(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Collapse all leading dims of (..., D) into one batch dim."""
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


def unflatten_leading(x: torch.Tensor, lead: tuple[int, ...]) -> torch.Tensor:
    return x.reshape(*lead, x.shape[-1])


def einsum_as(eq: str, *operands: torch.Tensor, out_dtype) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=out_dtype)``: the product is
    taken in the widest of the operand and output types, then cast."""
    ct = out_dtype
    for o in operands:
        ct = torch.promote_types(ct, o.dtype)
    return torch.einsum(eq, *(o.to(ct) for o in operands)).to(out_dtype)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` without ``preferred_element_type``: the product in
    the operands' promoted dtype (``torch.einsum`` refuses mixed dtypes)."""
    ct = operands[0].dtype
    for o in operands[1:]:
        ct = torch.promote_types(ct, o.dtype)
    return torch.einsum(eq, *(o.to(ct) for o in operands))


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple, in a fixed order (dicts in
    insertion order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest`` trees,
    keeping the structure (``jax.tree_util.tree_map`` for dicts, lists and
    tuples; a None leaf stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_map_with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves, keeping the structure; a leaf's
    path is its dict keys, list indices and NamedTuple field names joined
    by ``/`` (``stack/0/mixer/wq``); a None leaf stays None."""
    if tree is None:
        return None
    key = lambda name: f"{prefix}/{name}" if prefix else str(name)
    if isinstance(tree, dict):
        return {k: tree_map_with_paths(fn, v, key(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_paths(fn, v, key(f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_paths(fn, v, key(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_leaves_with_paths(tree) -> list:
    """(path, leaf) pairs of ``tree_map_with_paths``' leaves, in its order."""
    out = []
    tree_map_with_paths(lambda p, t: out.append((p, t)), tree)
    return out


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tree_size(tree) -> int:
    """Total number of scalar elements of the tensors in a tree (meta
    tensors count too: nothing is read; other leaves, such as a cache's
    ``paged`` flag, count nothing)."""
    return sum(t.numel() for t in _tensors(tree))


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def tree_cast(tree, dtype):
    return tree_map(lambda t: t.to(dtype), tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_finite(tree) -> torch.Tensor:
    """True (a 0-d bool tensor) iff every leaf is finite everywhere."""
    leaves = [torch.isfinite(t).all() for t in tree_leaves(tree)]
    return torch.stack(leaves).all()


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in leaves))


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point allocates on.  CUDA is the default and is
    never swapped for the CPU behind the caller's back: without a card this
    raises, and only an explicit ``device="cpu"`` runs on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the host")
    return dev


# ---------------------------------------------------------------------------
# initializers: the JAX package's distributions, drawn from a torch.Generator
# (same distributions, different numbers).  Each tensor is drawn in float32
# on the generator's device and cast once, so a bf16 model never exists in
# float32 as a whole.
# ---------------------------------------------------------------------------

class MetaGenerator(torch.Generator):
    """A host generator that reports the meta device: the initializers
    given it allocate meta tensors (shapes and dtypes, no storage) and
    their draws do no work, so ``lm.init(cfg, device="meta")`` lays out a
    full-size model without memory."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device, seed: int = 0) -> torch.Generator:
    """A generator seeded with ``seed`` whose draws land on ``device`` (a
    ``MetaGenerator`` for the meta device)."""
    dev = torch.device(device)
    gen = MetaGenerator() if dev.type == "meta" else torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


#: tensors with more elements are drawn one slice of the first axis at a
#: time, so only a slice exists in float32 (kimi-k2's forest: 7.5e9
#: elements a weight, 30 GB in float32 beside its 15 GB in bf16); smaller
#: ones keep their single draw
SLICED_INIT_ABOVE = 2 ** 31


def _by_slices(gen: torch.Generator, shape: tuple, dtype, draw):
    """``draw(slice_shape)`` for each slice of the first axis, into one
    tensor of ``dtype``; None when ``shape`` is drawn whole."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    if math.prod(shape) <= SLICED_INIT_ABOVE or len(shape) < 2:
        return None
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


def lecun_normal(gen: torch.Generator, shape, dtype=torch.float32,
                 fan_in_axis: int = -2) -> torch.Tensor:
    shape = tuple(shape)
    std = 1.0 / math.sqrt(shape[fan_in_axis])
    out = _by_slices(gen, shape, dtype, lambda s: _normal(gen, s).mul_(std))
    return out if out is not None else _normal(gen, shape).mul_(std).to(dtype)


def he_normal(gen: torch.Generator, shape, dtype=torch.float32,
              fan_in_axis: int = -2) -> torch.Tensor:
    shape = tuple(shape)
    std = math.sqrt(2.0 / shape[fan_in_axis])
    out = _by_slices(gen, shape, dtype, lambda s: _normal(gen, s).mul_(std))
    return out if out is not None else _normal(gen, shape).mul_(std).to(dtype)


def truncated_init(gen: torch.Generator, shape, std: float,
                   dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``std`` (``jax.random.
    truncated_normal(key, -2, 2) * std``)."""
    shape = tuple(shape)
    out = _by_slices(gen, shape, dtype,
                     lambda s: truncated_init(gen, s, std, torch.float32))
    if out is not None:
        return out
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


ACTIVATIONS: Mapping[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; have {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# dataclass config plumbing and size formatting
# ---------------------------------------------------------------------------

def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def asdict_shallow(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


def human_flops(n: float) -> str:
    for unit in ("F", "KF", "MF", "GF", "TF"):
        if abs(n) < 1e3:
            return f"{n:.2f}{unit}"
        n /= 1e3
    return f"{n:.2f}PF"
