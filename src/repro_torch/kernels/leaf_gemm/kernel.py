"""Wrappers of the CUDA grouped leaf GEMMs (``csrc/leaf_gemm.cu``), which
replace the Pallas TPU kernels ``repro/kernels/leaf_gemm/kernel.py::
grouped_matmul`` and ``::grouped_matmul_dual``: a ragged grouped GEMM over
capacity-padded per-leaf token buffers whose empty token tiles are skipped.
CPU tensors run the plain versions in ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.leaf_gemm import ref as R

P, I = common.P, common.I

GMM = common.register(common.Kernel(
    "grouped_matmul", "leaf_gemm.cu", "grouped_matmul",
    [P, P, P, P, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/leaf_gemm/kernel.py:80"))
GMM_DUAL = common.register(common.Kernel(
    "grouped_matmul_dual", "leaf_gemm.cu", "grouped_matmul_dual",
    [P, P, P, P, P, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/leaf_gemm/kernel.py:144"))


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor, *, act: str = "none"
                   ) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, H) -> act(.) (E, C, H), skipping token tiles
    at or past ``group_sizes`` (E,) int32; act in none/relu/gelu/silu."""
    common.forward_only("grouped_matmul", x, w)
    if act not in R.ACTS:
        raise ValueError(f"unknown act {act!r}; have {sorted(R.ACTS)}")
    if x.device.type == "cpu":
        return R.grouped_matmul_ref(x, w, group_sizes, act=act)
    return _launch(GMM, x, (w,), group_sizes, (common.ACT_CODES[act],))


def grouped_matmul_dual(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """SwiGLU up: silu(x @ wg) * (x @ wu), grouped per leaf: -> (E, C, H)."""
    common.forward_only("grouped_matmul_dual", x, wg, wu)
    if x.device.type == "cpu":
        return R.grouped_matmul_dual_ref(x, wg, wu, group_sizes)
    return _launch(GMM_DUAL, x, (wg, wu), group_sizes, ())


def _launch(kernel, x, ws, group_sizes, act_code):
    """The CUDA branch: operand checks, output allocation, the launch."""
    E, C, D = x.shape
    H = ws[0].shape[2]
    common.check(x, "x")
    for i, w in enumerate(ws):
        common.check(w, f"w{i}", like=x, shape=(E, D, H))
    common.check(group_sizes, "group_sizes", like=x, dtype=torch.int32,
                 shape=(E,))
    y = torch.empty((E, C, H), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    kernel.launch(x.data_ptr(), *(w.data_ptr() for w in ws),
                  group_sizes.data_ptr(), y.data_ptr(), E, C, D, H, *act_code,
                  common.dtype_code(x), *common.stream_of(x))
    return y
