"""Weight bridge from the JAX package: numpy parameter trees in, the port's
parameters out, so both packages compute the same function in the tests.

The caller converts the JAX tree to numpy (``jax.tree_util.tree_map(
np.asarray, params)``); this module never imports JAX.  bfloat16 arrays
arrive as ``ml_dtypes.bfloat16`` numpy, which goes through float32
(exact) and back to ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import utils
from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def tensor(a, device="cuda") -> torch.Tensor:
    """One numpy array (float32, bfloat16, int or bool) -> a tensor of the
    same dtype on ``device``."""
    a = np.asarray(a)
    name = str(a.dtype)
    if name not in _DTYPES:
        raise TypeError(f"no bridge for dtype {name}")
    host = a.astype(np.float32) if name == "bfloat16" else a
    dev = utils.resolve_device(device)
    return torch.tensor(host).to(dev, _DTYPES[name])


def tree(params, device="cuda"):
    """A nested dict/list/tuple of numpy arrays -> the same tree of tensors
    (e.g. an ``fff.init`` parameter dict)."""
    if isinstance(params, dict):
        return {k: tree(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(tree(v, device) for v in params)
    return tensor(params, device)


def from_jax(params_np: dict, cfg: ModelConfig, device="cuda") -> dict:
    """``repro.models.lm.init``'s tree (as numpy) -> the port's LM params.

    JAX keeps the stack as one entry per period position whose leaves carry
    a leading ``n_periods`` axis; the port keeps one dict per layer, layer
    ``i`` being period ``i // len(period)``, position ``i % len(period)``.
    Any tree of that layout maps the same way: the tests carry JAX
    gradients and optimizer moments over with it to compare them with the
    port's leaf by leaf."""
    n_pos = len(cfg.period)

    def layer(i):
        pos_tree = params_np["stack"][i % n_pos]
        take = lambda t: ({k: take(v) for k, v in t.items()}
                          if isinstance(t, dict) else np.asarray(t)[i // n_pos])
        return tree(take(pos_tree), device)

    return {"embed": tree(params_np["embed"], device),
            "stack": [layer(i) for i in range(cfg.n_layers)],
            "final_norm": tree(params_np["final_norm"], device)}
