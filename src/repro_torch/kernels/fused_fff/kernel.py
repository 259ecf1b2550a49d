"""Wrappers of the CUDA gathered leaf matmuls (``csrc/fused_fff.cu``), which
replace the Pallas TPU kernels ``repro/kernels/fused_fff/kernel.py::
gathered_matmul`` and ``::gathered_matmul_dual``: a per-token product with
the token's own leaf, whose routed index is the offset of the weight loads.
CPU tensors run the plain versions in ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.fused_fff import ref as R
from repro_torch.kernels.leaf_gemm.ref import ACTS

P, I = common.P, common.I

GATHERED = common.register(common.Kernel(
    "gathered_matmul", "fused_fff.cu", "gathered_matmul",
    [P, P, P, P, I, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/fused_fff/kernel.py:67"))
GATHERED_DUAL = common.register(common.Kernel(
    "gathered_matmul_dual", "fused_fff.cu", "gathered_matmul_dual",
    [P, P, P, P, P, I, I, I, I, I, I, P],
    replaces="src/repro/kernels/fused_fff/kernel.py:123"))


def gathered_matmul(x: torch.Tensor, w: torch.Tensor, leaf_idx: torch.Tensor,
                    *, act: str = "none") -> torch.Tensor:
    """y[i] = act(x[i] @ w[leaf_idx[i]]): x (B, D), w (E, D, H), leaf_idx
    (B,) int32 -> (B, H) in x's dtype; act in none/relu/gelu/silu.  Unlike
    the Pallas kernel, D and H need no tiles that divide them: the kernel
    masks its ragged edges."""
    common.forward_only("gathered_matmul", x, w)
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; have {sorted(ACTS)}")
    if x.device.type == "cpu":
        return R.gathered_matmul_ref(x, w, leaf_idx, act=act)
    return _launch(GATHERED, x, (w,), leaf_idx, (common.ACT_CODES[act],))


def gathered_matmul_dual(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                         leaf_idx: torch.Tensor) -> torch.Tensor:
    """SwiGLU up with per-token leaves: silu(x @ wg[i]) * (x @ wu[i]) ->
    (B, H)."""
    common.forward_only("gathered_matmul_dual", x, wg, wu)
    if x.device.type == "cpu":
        return R.gathered_matmul_dual_ref(x, wg, wu, leaf_idx)
    return _launch(GATHERED_DUAL, x, (wg, wu), leaf_idx, ())


def _launch(kernel, x, ws, leaf_idx, act_code):
    """The CUDA branch: operand checks, output allocation, the launch."""
    B, D = x.shape
    E, _, H = ws[0].shape
    common.check(x, "x")
    for i, w in enumerate(ws):
        common.check(w, f"w{i}", like=x, shape=(E, D, H))
    common.check(leaf_idx, "leaf_idx", like=x, dtype=torch.int32, shape=(B,))
    y = torch.empty((B, H), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    kernel.launch(x.data_ptr(), *(w.data_ptr() for w in ws),
                  leaf_idx.data_ptr(), y.data_ptr(), B, D, H, E, *act_code,
                  common.dtype_code(x), *common.stream_of(x))
    return y
