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


def state(state_np, cls, device="cuda"):
    """A recurrent mixer's state as numpy (a ``MambaState``, ``MLSTMState``
    or ``SLSTMState`` of the JAX package, field by field) -> the port's
    NamedTuple ``cls`` of tensors."""
    return cls(*(tensor(a, device) for a in state_np))


def from_jax(params_np: dict, cfg: ModelConfig, device="cuda") -> dict:
    """``repro.models.lm.init``'s tree (as numpy) -> the port's LM params.

    JAX keeps the stack as one entry per period position whose leaves carry
    a leading ``n_periods`` axis; the port keeps one dict per layer, layer
    ``i`` being period ``i // len(period)``, position ``i % len(period)``;
    an encoder's stack (``enc_stack``) maps the same way over the
    encoder's period.  The other entries (``pos``, ``frontend``,
    ``enc_frontend``, ``enc_norm``) carry over as they are.  Any tree of
    that layout maps the same way: the tests carry JAX gradients and
    optimizer moments over with it to compare them with the port's leaf
    by leaf."""
    def layers(stack, n_pos, n_layers):
        def layer(i):
            take = lambda t: ({k: take(v) for k, v in t.items()}
                              if isinstance(t, dict) else np.asarray(t)[i // n_pos])
            return tree(take(stack[i % n_pos]), device)
        return [layer(i) for i in range(n_layers)]

    out = {}
    for k, v in params_np.items():
        if k == "stack":
            out[k] = layers(v, len(cfg.period), cfg.n_layers)
        elif k == "enc_stack":
            out[k] = layers(v, len(cfg.encoder.period), cfg.encoder.n_layers)
        else:
            out[k] = tree(v, device)
    return out
