"""Wrapper of the CUDA tree_router kernel (``csrc/tree_router.cu``), which
replaces the Pallas TPU kernel ``repro/kernels/tree_router/kernel.py::
tree_router``: every collapsed node logit for a token batch, f32
accumulation, then the hard descent.  One thread-block cluster per 64-token
tile splits D over its blocks and sums their partial logits through
distributed shared memory; one launch per call, and a launch the card
refuses (a cluster or tensor map it cannot take) raises here.  CPU tensors
run the plain version in ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.tree_router import ref as R

P, I = common.P, common.I

KERNEL = common.register(common.Kernel(
    "tree_router", "tree_router.cu", "tree_router",
    [P, P, P, P, I, I, I, I, I, P],
    replaces="src/repro/kernels/tree_router/kernel.py:55"))


def tree_router(x: torch.Tensor, node_w: torch.Tensor, node_b: torch.Tensor,
                *, depth: int) -> torch.Tensor:
    """x (B, D), node_w (N, D), node_b (N,) with N = 2^depth - 1, one dtype
    (float32 or bfloat16) -> (B,) int32 leaf indices.  Unlike the Pallas
    kernel, B need not be a multiple of a tile: the kernel masks its ragged
    last tile itself."""
    if x.device.type == "cpu":
        return R.tree_router_ref(x, node_w, node_b, depth=depth)
    return _launch(x, node_w, node_b, depth)


def _launch(x, node_w, node_b, depth):
    """The CUDA branch: operand checks, output allocation, the launch."""
    B, D = x.shape
    N = 2 ** depth - 1
    if not 1 <= depth <= 8:
        raise ValueError(f"tree_router kernel takes 1 <= depth <= 8, got {depth}")
    common.check(x, "x")
    common.check(node_w, "node_w", like=x, shape=(N, D))
    common.check(node_b, "node_b", like=x, shape=(N,))
    out = torch.empty(B, dtype=torch.int32, device=x.device)
    if B == 0:
        return out
    KERNEL.launch(x.data_ptr(), node_w.data_ptr(), node_b.data_ptr(),
                  out.data_ptr(), B, D, depth, common.dtype_code(x),
                  *common.stream_of(x))
    return out
