"""Wrapper for the fused decode kernel (port of ``repro/kernels/
fused_decode/ops.py``): node-parameter collapse, eligibility checks and the
``(y, leaf_idx)`` contract of the ``("infer", "cuda_decode")`` backend."""
from __future__ import annotations

import torch

from repro_torch.core import fff as fff_lib
from repro_torch.kernels.fused_decode import kernel as K
from repro_torch.kernels.fused_decode import ref as R


def collapse_nodes(params: dict, cfg: fff_lib.FFFConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold the node_width-1 two-layer node net into one hyperplane per
    node: w = w1[..., 0] * w2[..., 0], b = b1[..., 0] * w2[..., 0] + b2.
    Returns ``(nw (T, N, D), nb (T, N))``."""
    nw = params["node_w1"][:, :, :, 0] * params["node_w2"][:, :, 0:1]
    nb = params["node_b1"][:, :, 0] * params["node_w2"][:, :, 0] \
        + params["node_b2"]
    return nw, nb


def _leaf_weights(params: dict, cfg: fff_lib.FFFConfig) -> tuple[tuple, str]:
    if "leaf_b1" in params or "leaf_b2" in params:
        raise ValueError("fused decode kernel requires bias-free leaves")
    if cfg.activation == "swiglu":
        return ((params["leaf_wg"], params["leaf_wu"], params["leaf_wd"]),
                "swiglu")
    return (params["leaf_w1"], params["leaf_w2"]), cfg.activation


def _master_weights(params: dict, cfg: fff_lib.FFFConfig):
    if not cfg.master_leaf:
        return None
    if cfg.activation == "swiglu":
        return (params["master_wg"], params["master_wu"], params["master_wd"])
    return (params["master_w1"], params["master_w2"])


def _operands(x: torch.Tensor, params: dict, cfg: fff_lib.FFFConfig):
    if cfg.node_width != 1:
        raise ValueError("kernel path supports node_width == 1 (paper default)")
    if cfg.depth < 1:
        raise ValueError("fused decode needs a tree to descend (depth >= 1)")
    nw, nb = collapse_nodes(params, cfg)
    leaf_w, act = _leaf_weights(params, cfg)
    master_w = _master_weights(params, cfg)
    return nw, nb, leaf_w, act, master_w


def fused_decode(x: torch.Tensor, params: dict, cfg: fff_lib.FFFConfig, *,
                 return_leaf_idx: bool = False):
    """Exact FORWARD_I for decode-shaped batches in one kernel call.
    x (B, D) -> (B, dim_out) summed over trees; with ``return_leaf_idx``
    also the (B, trees) leaf indices.  Every operand goes to the kernel in
    the widest of x's and the parameters' dtypes."""
    nw, nb, leaf_w, act, master_w = _operands(x, params, cfg)
    dt = x.dtype
    for w in (nw, *leaf_w):
        dt = torch.promote_types(dt, w.dtype)
    cast = lambda ws: None if ws is None else tuple(
        w.to(dt).contiguous() for w in ws)
    y, leaf_idx = K.fused_forest_decode(
        x.to(dt).contiguous(), nw.to(dt).contiguous(), nb.to(dt).contiguous(),
        cast(leaf_w), depth=cfg.depth, act=act, master_w=cast(master_w))
    y = y.to(x.dtype)
    return (y, leaf_idx) if return_leaf_idx else y


def fused_decode_ref(x: torch.Tensor, params: dict, cfg: fff_lib.FFFConfig,
                     *, return_leaf_idx: bool = False):
    """The plain version at the same params/cfg contract as ``fused_decode``."""
    nw, nb, leaf_w, act, master_w = _operands(x, params, cfg)
    y, leaf_idx = R.fused_decode_ref(x, nw, nb, leaf_w, depth=cfg.depth,
                                     act=act, master_w=master_w)
    return (y, leaf_idx) if return_leaf_idx else y
