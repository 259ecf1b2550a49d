"""Plain PyTorch versions of the grouped leaf GEMM kernels (port of
``repro/kernels/leaf_gemm/ref.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import utils

#: the kernels' activations ("none" is the down-projection's)
ACTS = {"none": utils.ACTIVATIONS["identity"],
        **{k: utils.ACTIVATIONS[k] for k in ("relu", "gelu", "silu")}}


def _row_mask(x: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    C = x.shape[1]
    return (torch.arange(C, device=x.device)[None, :]
            < group_sizes[:, None].to(x.device))[..., None]


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor, *, act: str = "none"
                       ) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, H) -> (E, C, H); rows at or past each group's
    size are zeros (exactly, where the kernel skips whole token tiles)."""
    y = ACTS[act](torch.bmm(x.float(), w.float()))
    return (y * _row_mask(x, group_sizes)).to(x.dtype)


def grouped_matmul_dual_ref(x: torch.Tensor, wg: torch.Tensor,
                            wu: torch.Tensor, group_sizes: torch.Tensor
                            ) -> torch.Tensor:
    xf = x.float()
    y = F.silu(torch.bmm(xf, wg.float())) * torch.bmm(xf, wu.float())
    return (y * _row_mask(x, group_sizes)).to(x.dtype)
