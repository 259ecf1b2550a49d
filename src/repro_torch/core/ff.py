"""Vanilla feedforward baseline (port of ``repro/core/ff.py``): the ``FF``
peer the paper compares FFF against, and the dense SwiGLU of a
transformer's native FFN site.

One hidden layer of ``width`` neurons: ``w1`` (dim_in, width) and ``w2``
(width, dim_out) with optional biases ``b1``, ``b2`` under relu, gelu or
silu; or SwiGLU's ``wg``, ``wu`` (dim_in, width) and ``wd`` (width,
dim_out).  The products are plain PyTorch, accumulated in
``accum_dtype`` (the JAX package's einsums run no Pallas kernel either).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import utils
from repro_torch.core import fff

Params = dict


@dataclasses.dataclass(frozen=True)
class FFConfig:
    dim_in: int
    dim_out: int
    width: int
    activation: str = "gelu"       # relu|gelu|silu|swiglu
    bias: bool = True
    param_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32

    @property
    def training_width(self) -> int:   # symmetry with FFFConfig
        return self.width

    @property
    def inference_width(self) -> int:
        return self.width


def init(gen: torch.Generator, cfg: FFConfig) -> Params:
    """The JAX package's distributions drawn from ``gen`` on its device."""
    D, H, O = cfg.dim_in, cfg.width, cfg.dim_out
    pd = cfg.param_dtype
    if cfg.activation == "swiglu":
        return {
            "wg": utils.truncated_init(gen, (D, H), 1.0 / math.sqrt(D), pd),
            "wu": utils.truncated_init(gen, (D, H), 1.0 / math.sqrt(D), pd),
            "wd": utils.truncated_init(gen, (H, O), 1.0 / math.sqrt(H), pd),
        }
    p: Params = {
        "w1": utils.he_normal(gen, (D, H), pd),
        "w2": utils.lecun_normal(gen, (H, O), pd),
    }
    if cfg.bias:
        p["b1"] = torch.zeros((H,), dtype=pd, device=gen.device)
        p["b2"] = torch.zeros((O,), dtype=pd, device=gen.device)
    return p


def forward(params: Params, cfg: FFConfig, x: torch.Tensor) -> torch.Tensor:
    """x (..., dim_in) -> (..., dim_out) in ``accum_dtype``."""
    xf, lead = utils.flatten_leading(x)
    y = fff.leaf_mlp(params, xf.to(cfg.accum_dtype), cfg.activation,
                     cfg.accum_dtype, prefix="")
    return utils.unflatten_leading(y, lead)
