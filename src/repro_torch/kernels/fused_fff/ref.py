"""Plain PyTorch versions of the gathered leaf matmul kernels (port of
``repro/kernels/fused_fff/ref.py``): every product in float32, the result
cast to x's dtype; gelu is the tanh form (``utils.ACTIVATIONS``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.leaf_gemm.ref import ACTS


def _gathered(x: torch.Tensor, w: torch.Tensor, leaf_idx: torch.Tensor
              ) -> torch.Tensor:
    """(B, D) x w[leaf_idx] (B, D, H) -> (B, H) float32.  A row whose
    index lies outside [0, E) reads no weights and yields zeros, as the
    kernel's guard does (the router never produces one)."""
    idx = leaf_idx.long()
    ok = (idx >= 0) & (idx < w.shape[0])
    wg = w[idx.clamp(0, w.shape[0] - 1)].float()
    y = torch.einsum("bd,bdh->bh", x.float(), wg)
    return y * ok[:, None]


def gathered_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                        leaf_idx: torch.Tensor, *, act: str = "none"
                        ) -> torch.Tensor:
    """y[i] = act(x[i] @ w[leaf_idx[i]]): x (B, D), w (E, D, H) -> (B, H)."""
    return ACTS[act](_gathered(x, w, leaf_idx)).to(x.dtype)


def gathered_matmul_dual_ref(x: torch.Tensor, wg: torch.Tensor,
                             wu: torch.Tensor, leaf_idx: torch.Tensor
                             ) -> torch.Tensor:
    """SwiGLU up with per-token leaves: silu(x @ wg[i]) * (x @ wu[i]).  Both
    products stay in float32 up to the final cast, as in the Pallas kernel
    (the JAX oracle rounds each product to x's dtype first, a difference
    inside the bfloat16 tolerance)."""
    g = _gathered(x, wg, leaf_idx)
    u = _gathered(x, wu, leaf_idx)
    return (F.silu(g) * u).to(x.dtype)
