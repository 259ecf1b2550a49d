"""Plain PyTorch version of the fused decode kernel (port of
``repro/kernels/fused_decode/ref.py``): hard descent + the selected leaf's
MLP + forest combine, all in float32 (FORWARD_I, node_width 1, bias-free
leaves)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import utils


def _mlp(xf: torch.Tensor, w: tuple, act: str, gather=None) -> torch.Tensor:
    """xf (B, D) through one MLP per token; with ``gather`` (B,) the weights
    carry a leading leaf axis and each token uses its own leaf."""
    ws = [(v[gather] if gather is not None else v).float() for v in w]
    eq_in, eq_out = (("bd,bdh->bh", "bh,bho->bo") if gather is not None
                     else ("bd,dh->bh", "bh,ho->bo"))
    if act == "swiglu":
        wg, wu, wd = ws
        h = F.silu(torch.einsum(eq_in, xf, wg)) * torch.einsum(eq_in, xf, wu)
        return torch.einsum(eq_out, h, wd)
    w1, w2 = ws
    h = utils.get_activation(act)(torch.einsum(eq_in, xf, w1))
    return torch.einsum(eq_out, h, w2)


def fused_decode_ref(x: torch.Tensor, nw: torch.Tensor, nb: torch.Tensor,
                     leaf_w: tuple, *, depth: int, act: str = "gelu",
                     master_w: Optional[tuple] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``kernel.fused_forest_decode``: x (B, D), collapsed
    nodes nw (T, N, D) / nb (T, N), ``leaf_w`` = (w1, w2) or (wg, wu, wd)
    with leading (T, E) axes -> ``(y (B, O), leaf_idx (B, T) int32)``."""
    B = x.shape[0]
    xf = x.float()
    y = None
    idxs = []
    for t in range(nw.shape[0]):
        idx = torch.zeros(B, dtype=torch.int64, device=x.device)
        for m in range(depth):
            g = (2 ** m - 1) + idx
            logit = (xf * nw[t][g].float()).sum(-1) + nb[t][g].float()
            idx = 2 * idx + (logit >= 0.0).long()
        yt = _mlp(xf, tuple(w[t] for w in leaf_w), act, gather=idx)
        y = yt if y is None else y + yt
        idxs.append(idx)
    if master_w is not None:
        y = y + _mlp(xf, master_w, act)
    return y.to(x.dtype), torch.stack(idxs, dim=1).to(torch.int32)
