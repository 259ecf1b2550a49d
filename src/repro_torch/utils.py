"""Small shared utilities (port of ``repro/utils.py``): shape helpers, the
activation table, initializers on an explicit ``torch.Generator``, the
pytree helpers the optimizers walk parameter trees with, and the device
check every entry point runs."""
from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F


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

def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def lecun_normal(gen: torch.Generator, shape, dtype=torch.float32,
                 fan_in_axis: int = -2) -> torch.Tensor:
    std = 1.0 / math.sqrt(shape[fan_in_axis])
    return _normal(gen, shape).mul_(std).to(dtype)


def he_normal(gen: torch.Generator, shape, dtype=torch.float32,
              fan_in_axis: int = -2) -> torch.Tensor:
    std = math.sqrt(2.0 / shape[fan_in_axis])
    return _normal(gen, shape).mul_(std).to(dtype)


def truncated_init(gen: torch.Generator, shape, std: float,
                   dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``std`` (``jax.random.
    truncated_normal(key, -2, 2) * std``)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
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
