"""Fast Feedforward (FFF) layer (port of ``repro/core/fff.py``).

A balanced binary tree of depth ``d`` with ``2^d - 1`` node networks and
``2^d`` leaf networks, in the paper's two modes:

* FORWARD_T (``mode="train"``): every node emits a Bernoulli probability,
  each leaf's mixture weight is the product of the branch probabilities on
  its root-to-leaf path, and all leaves are evaluated and mixed.
* FORWARD_I (``mode="infer"``): each node decision is rounded, one
  root-to-leaf path is followed and exactly one leaf per tree is evaluated.

Nodes are stored level-major: the global index of node ``N[m, k]`` is
``2^m - 1 + k``; its children are ``N[m+1, 2k]`` (left, weight ``1 - p``)
and ``N[m+1, 2k+1]`` (right, weight ``p``, taken when the logit is
``>= 0``).

The single entry point is :func:`repro_torch.core.api.apply`; this module
holds the config, init, the node/leaf math, the soft mixture and the
straight-through grouped estimator the training backends run (plain
PyTorch under autograd), the hardening and balance losses, and the
capacity-bounded inference paths of the ``grouped`` and ``grouped_ep``
backends with their overflow policies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import utils
from repro_torch.core import routing as routing_lib
from repro_torch.distributed import act as dist_act

Params = dict


@dataclasses.dataclass(frozen=True)
class FFFConfig:
    dim_in: int
    dim_out: int
    depth: int                      # d >= 0; 2^d leaves
    leaf_width: int                 # l
    node_width: int = 1             # n (paper: n = 1 suffices)
    activation: str = "gelu"        # relu|gelu|silu|swiglu
    trees: int = 1                  # forest size; 1 == paper
    hardening_scale: float = 0.0
    transposition_prob: float = 0.0
    freeze_tree: bool = False
    leaf_bias: bool = True
    st_training: bool = False
    master_leaf: bool = False       # always-on master MLP added to every token
    master_width: int = 0           # 0 = leaf_width
    param_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32

    @property
    def num_leaves(self) -> int:
        return 2 ** self.depth

    @property
    def num_nodes(self) -> int:
        return 2 ** self.depth - 1

    @property
    def training_width(self) -> int:
        return self.trees * self.num_leaves * self.leaf_width

    @property
    def inference_width(self) -> int:
        return self.trees * self.leaf_width

    @property
    def training_size(self) -> int:
        return self.trees * (self.num_nodes * self.node_width
                             + self.num_leaves * self.leaf_width)

    @property
    def inference_size(self) -> int:
        return self.trees * (self.depth * self.node_width + self.leaf_width)

    @property
    def master_hidden(self) -> int:
        return self.master_width or self.leaf_width

    def validate(self) -> "FFFConfig":
        if self.depth < 0:
            raise ValueError("depth must be >= 0")
        if self.leaf_width < 1 or self.node_width < 1 or self.trees < 1:
            raise ValueError("leaf_width, node_width, trees must be >= 1")
        if self.master_width < 0:
            raise ValueError("master_width must be >= 0 (0 = leaf_width)")
        if self.activation != "swiglu":
            utils.get_activation(self.activation)
        return self


def for_ffn(dim: int, d_ff: int, leaf_width: int, *, trees: int = 1,
            activation: str = "swiglu", **kw) -> FFFConfig:
    """The paper's "user manual" Case 1: replace a width-``d_ff`` FFN
    keeping the training width, ``2^d * l * trees == next_pow2(d_ff)``."""
    per_tree = utils.cdiv(d_ff, trees)
    depth = max(0, math.ceil(math.log2(max(1, utils.cdiv(per_tree, leaf_width)))))
    return FFFConfig(dim_in=dim, dim_out=dim, depth=depth, leaf_width=leaf_width,
                     trees=trees, activation=activation, leaf_bias=False, **kw)


def init(gen: torch.Generator, cfg: FFFConfig) -> Params:
    """Parameters on ``gen.device``, stacked over a leading ``trees`` axis;
    keys and shapes are those of ``repro.core.fff.init``:

    node_w1 (T, N, dim_in, n), node_b1 (T, N, n), node_w2 (T, N, n),
    node_b2 (T, N); SwiGLU leaves leaf_wg, leaf_wu (T, L, dim_in, l) and
    leaf_wd (T, L, l, dim_out), else leaf_w1/leaf_w2 (+ leaf_b1/leaf_b2);
    master leaf master_wg/master_wu/master_wd or master_w1/master_w2.
    """
    cfg.validate()
    T, N, L = cfg.trees, max(cfg.num_nodes, 1), cfg.num_leaves
    D, O, l, n = cfg.dim_in, cfg.dim_out, cfg.leaf_width, cfg.node_width
    pd, dev = cfg.param_dtype, gen.device
    params: Params = {
        "node_w1": utils.truncated_init(gen, (T, N, D, n), 1.0 / math.sqrt(D), pd),
        "node_b1": torch.zeros((T, N, n), dtype=pd, device=dev),
        "node_w2": utils.truncated_init(gen, (T, N, n), 1.0 / math.sqrt(n), pd),
        "node_b2": torch.zeros((T, N), dtype=pd, device=dev),
    }
    if cfg.activation == "swiglu":
        params["leaf_wg"] = utils.truncated_init(gen, (T, L, D, l), 1.0 / math.sqrt(D), pd)
        params["leaf_wu"] = utils.truncated_init(gen, (T, L, D, l), 1.0 / math.sqrt(D), pd)
        params["leaf_wd"] = utils.truncated_init(gen, (T, L, l, O), 1.0 / math.sqrt(l), pd)
    else:
        params["leaf_w1"] = utils.he_normal(gen, (T, L, D, l), pd)
        params["leaf_w2"] = utils.lecun_normal(gen, (T, L, l, O), pd)
        if cfg.leaf_bias:
            params["leaf_b1"] = torch.zeros((T, L, l), dtype=pd, device=dev)
            params["leaf_b2"] = torch.zeros((T, L, O), dtype=pd, device=dev)
    if cfg.master_leaf:
        mw = cfg.master_hidden
        if cfg.activation == "swiglu":
            params["master_wg"] = utils.truncated_init(gen, (D, mw), 1.0 / math.sqrt(D), pd)
            params["master_wu"] = utils.truncated_init(gen, (D, mw), 1.0 / math.sqrt(D), pd)
            params["master_wd"] = utils.truncated_init(gen, (mw, O), 1.0 / math.sqrt(mw), pd)
        else:
            params["master_w1"] = utils.he_normal(gen, (D, mw), pd)
            params["master_w2"] = utils.lecun_normal(gen, (mw, O), pd)
    return params


# ---------------------------------------------------------------------------
# node math
# ---------------------------------------------------------------------------

def _node_logits_all(params: Params, cfg: FFFConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits of every node for every token: x (B, D) -> (B, T, N).  For
    n == 1 the node's hidden activation is the identity."""
    ad = cfg.accum_dtype
    h = utils.einsum_as("bd,tndk->btnk", x, params["node_w1"], out_dtype=ad)
    h = h + params["node_b1"][None].to(ad)
    if cfg.node_width > 1:
        h = F.gelu(h, approximate="tanh")
    logit = utils.einsum_as("btnk,tnk->btn", h, params["node_w2"], out_dtype=ad)
    return logit + params["node_b2"][None].to(ad)


def _node_logit_at(params: Params, cfg: FFFConfig, x: torch.Tensor,
                   gidx: torch.Tensor) -> torch.Tensor:
    """Logit of one node per (token, tree): x (B, D), gidx (B, T) -> (B, T)."""
    ad = cfg.accum_dtype
    out = []
    for t in range(cfg.trees):
        idx = gidx[:, t]
        w1 = params["node_w1"][t][idx]                    # (B, D, n)
        b1 = params["node_b1"][t][idx]                    # (B, n)
        w2 = params["node_w2"][t][idx]                    # (B, n)
        b2 = params["node_b2"][t][idx]                    # (B,)
        h = utils.einsum_as("bd,bdn->bn", x, w1, out_dtype=ad) + b1.to(ad)
        if cfg.node_width > 1:
            h = F.gelu(h, approximate="tanh")
        out.append((h * w2.to(ad)).sum(-1) + b2.to(ad))
    return torch.stack(out, dim=1)


def mixture_weights(node_probs: torch.Tensor, depth: int) -> torch.Tensor:
    """Leaf mixture weights from level-major node probabilities:
    (..., 2^d - 1) -> (..., 2^d), w[leaf] = product over its path of p
    (right) or 1 - p (left); a distribution over leaves by construction."""
    lead = tuple(node_probs.shape[:-1])
    w = torch.ones(lead + (1,), dtype=node_probs.dtype, device=node_probs.device)
    off = 0
    for m in range(depth):
        p = node_probs[..., off:off + 2 ** m]
        w = torch.stack([w * (1.0 - p), w * p], dim=-1).reshape(lead + (2 ** (m + 1),))
        off += 2 ** m
    return w


def route_hard(params: Params, cfg: FFFConfig, x: torch.Tensor,
               dense_levels: int = 8) -> torch.Tensor:
    """FORWARD_I descent only: x (..., dim_in) -> leaf indices (..., trees).

    The first ``dense_levels`` levels take every node logit from one dense
    product; deeper levels gather the one node each token reaches.  Ties go
    right (``>= 0``)."""
    xf, lead = utils.flatten_leading(x)
    xf = xf.to(cfg.accum_dtype)
    B = xf.shape[0]
    idx = torch.zeros((B, cfg.trees), dtype=torch.int64, device=x.device)
    nd = min(dense_levels, cfg.depth)
    if nd > 0:
        n_dense = 2 ** nd - 1
        p_dense = {k: (v[:, :n_dense] if k.startswith("node_") else v)
                   for k, v in params.items()}
        logits = _node_logits_all(p_dense, cfg, xf)       # (B, T, n_dense)
        off = 0
        for m in range(nd):
            level = logits[:, :, off:off + 2 ** m]        # (B, T, 2^m)
            cur = torch.gather(level, 2, idx[..., None])[..., 0]
            idx = 2 * idx + (cur >= 0).long()
            off += 2 ** m
    for m in range(nd, cfg.depth):
        logit = _node_logit_at(params, cfg, xf, (2 ** m - 1) + idx)
        idx = 2 * idx + (logit >= 0).long()
    return idx.to(torch.int32).reshape(*lead, cfg.trees)


# ---------------------------------------------------------------------------
# leaf math
# ---------------------------------------------------------------------------

def _leaf_forward_all(params: Params, cfg: FFFConfig, x: torch.Tensor
                      ) -> torch.Tensor:
    """Every leaf of every tree: x (B, D) -> (B, T, L, dim_out)."""
    ad = cfg.accum_dtype
    if cfg.activation == "swiglu":
        g = utils.einsum_as("bd,tldh->btlh", x, params["leaf_wg"], out_dtype=ad)
        u = utils.einsum_as("bd,tldh->btlh", x, params["leaf_wu"], out_dtype=ad)
        return utils.einsum_as("btlh,tlho->btlo", F.silu(g) * u,
                               params["leaf_wd"], out_dtype=ad)
    h = utils.einsum_as("bd,tldh->btlh", x, params["leaf_w1"], out_dtype=ad)
    if "leaf_b1" in params:
        h = h + params["leaf_b1"][None].to(ad)
    h = utils.get_activation(cfg.activation)(h)
    y = utils.einsum_as("btlh,tlho->btlo", h, params["leaf_w2"], out_dtype=ad)
    if "leaf_b2" in params:
        y = y + params["leaf_b2"][None].to(ad)
    return y


def leaf_mlp(w: dict, x: torch.Tensor, activation: str, accum_dtype,
             prefix: str = "leaf_") -> torch.Tensor:
    """One leaf (or the master leaf) on tokens x (B, D) -> (B, dim_out):
    ``w`` holds that leaf's ``{prefix}wg/wu/wd`` (SwiGLU) or
    ``{prefix}w1/w2`` (+ optional biases), without the (T, L) axes."""
    ad = accum_dtype
    if activation == "swiglu":
        g = utils.einsum_as("bd,dh->bh", x, w[prefix + "wg"], out_dtype=ad)
        u = utils.einsum_as("bd,dh->bh", x, w[prefix + "wu"], out_dtype=ad)
        return utils.einsum_as("bh,ho->bo", F.silu(g) * u, w[prefix + "wd"],
                               out_dtype=ad)
    h = utils.einsum_as("bd,dh->bh", x, w[prefix + "w1"], out_dtype=ad)
    if prefix + "b1" in w:
        h = h + w[prefix + "b1"].to(ad)
    h = utils.get_activation(activation)(h)
    y = utils.einsum_as("bh,ho->bo", h, w[prefix + "w2"], out_dtype=ad)
    if prefix + "b2" in w:
        y = y + w[prefix + "b2"].to(ad)
    return y


def leaf_apply_grouped(leaves: dict, x: torch.Tensor, leaf_idx: torch.Tensor,
                       activation: str, accum_dtype) -> torch.Tensor:
    """Each token's routed leaf, x (B, D), leaf_idx (B,) -> (B, dim_out).

    ``leaves`` holds one tree's leaf weights with a leading leaf axis E.
    The same function as a per-token weight gather, computed leaf by leaf
    over the tokens routed to it: a gathered ``(B, D, l)`` weight copy is
    ~26 GB per weight at full width and 1024 tokens.  Tokens routed to the
    sentinel leaf E get zeros."""
    B = x.shape[0]
    out_w = leaves["leaf_wd"] if activation == "swiglu" else leaves["leaf_w2"]
    E = out_w.shape[0]
    y = torch.zeros((B, out_w.shape[-1]), dtype=accum_dtype, device=x.device)
    if B == 0:
        return y
    idx = leaf_idx.long().clamp(max=E)
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=E + 1)[:E].tolist()
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = order[start:start + n]
            w = {k: v[e] for k, v in leaves.items()}
            y[rows] = leaf_mlp(w, x[rows], activation, accum_dtype)
            start += n
    return y


def _leaf_forward_gather(params: Params, cfg: FFFConfig, x: torch.Tensor,
                         leaf_idx: torch.Tensor) -> torch.Tensor:
    """Only the selected leaf per (token, tree): x (B, D), leaf_idx (B, T)
    -> (B, T, dim_out)."""
    out = []
    for t in range(cfg.trees):
        leaves = {k: v[t] for k, v in params.items() if k.startswith("leaf_")}
        out.append(leaf_apply_grouped(leaves, x, leaf_idx[:, t],
                                      cfg.activation, cfg.accum_dtype))
    return torch.stack(out, dim=1)


def master_apply(params: Params, cfg: FFFConfig, x: torch.Tensor) -> torch.Tensor:
    """The always-on master leaf: x (..., dim_in) -> (..., dim_out)."""
    xf, lead = utils.flatten_leading(x.to(cfg.accum_dtype))
    y = leaf_mlp(params, xf, cfg.activation, cfg.accum_dtype, prefix="master_")
    return utils.unflatten_leading(y, lead)


def _forward_hard_gather(params: Params, cfg: FFFConfig, x: torch.Tensor,
                         dense_levels: int = 8) -> tuple[torch.Tensor, dict]:
    """FORWARD_I: hard descent + single-leaf evaluation per tree (the exact
    inference reference, no capacity bound)."""
    xf, lead = utils.flatten_leading(x)
    xf = xf.to(cfg.accum_dtype)
    leaf_idx = route_hard(params, cfg, xf, dense_levels=dense_levels)
    y = _leaf_forward_gather(params, cfg, xf, leaf_idx).sum(dim=1)
    return (utils.unflatten_leading(y, lead),
            {"leaf_idx": leaf_idx.reshape(*lead, cfg.trees)})


# ---------------------------------------------------------------------------
# training: FORWARD_T's soft mixture and the straight-through grouped
# estimator (the train backends; autograd differentiates both)
# ---------------------------------------------------------------------------

def _soft_stats(params: Params, cfg: FFFConfig, xf: torch.Tensor,
                gen: Optional[torch.Generator]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft routing statistics of flat tokens xf (B, D): node probabilities
    (B, T, N), leaf mixture (B, T, L) and the mean decision entropy.
    ``cfg.freeze_tree`` (the paper's h = inf) stops the node gradients;
    ``cfg.transposition_prob`` swaps a node's children (p -> 1 - p) with
    that probability, drawn from ``gen`` (no swaps without one)."""
    B, ad = xf.shape[0], cfg.accum_dtype
    if cfg.depth == 0:
        return (torch.zeros((B, cfg.trees, 0), dtype=ad, device=xf.device),
                torch.ones((B, cfg.trees, 1), dtype=ad, device=xf.device),
                torch.zeros((), dtype=ad, device=xf.device))
    logits = _node_logits_all(params, cfg, xf)            # (B, T, N)
    if cfg.freeze_tree:
        logits = logits.detach()
    probs = torch.sigmoid(logits)
    if cfg.transposition_prob > 0.0 and gen is not None:
        flip = torch.rand(probs.shape, generator=gen,
                          device=probs.device) < cfg.transposition_prob
        probs = torch.where(flip, 1.0 - probs, probs)
    mix = mixture_weights(probs, cfg.depth)               # (B, T, L)
    return probs, mix, bernoulli_entropy(probs).mean()


def _forward_soft_mixture(params: Params, cfg: FFFConfig, x: torch.Tensor,
                          gen: Optional[torch.Generator] = None
                          ) -> tuple[torch.Tensor, dict]:
    """FORWARD_T: the soft mixture over all leaves (the training reference).
    x (..., dim_in) -> (..., dim_out), aux {node_probs (B, T, N), mixture
    (B, T, L), entropy}."""
    xf, lead = utils.flatten_leading(x)
    xf = xf.to(cfg.accum_dtype)
    probs, mix, ent = _soft_stats(params, cfg, xf, gen)
    leaf_out = _leaf_forward_all(params, cfg, xf)         # (B, T, L, O)
    y = torch.einsum("btl,btlo->bo", mix, leaf_out)
    aux = {"node_probs": probs, "mixture": mix, "entropy": ent}
    return utils.unflatten_leading(y, lead), aux


def _st_descend(cfg: FFFConfig, probs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard top-1 descent with a straight-through path-probability scale:
    probs (B, T, N) -> (leaf_idx (B, T) int32, scale (B, T)), the scale
    exactly 1 in value while its gradient flows into the path
    probabilities.  Ties (p = 0.5) go right, as in inference."""
    B, T = probs.shape[:2]
    idx = torch.zeros((B, T), dtype=torch.int64, device=probs.device)
    path_prob = torch.ones((B, T), dtype=cfg.accum_dtype, device=probs.device)
    off = 0
    for m in range(cfg.depth):
        p_here = torch.gather(probs[:, :, off:off + 2 ** m], 2, idx[..., None])[..., 0]
        bit = (p_here >= 0.5).detach()
        path_prob = path_prob * torch.where(bit, p_here, 1.0 - p_here)
        idx = 2 * idx + bit.long()
        off += 2 ** m
    scale = path_prob + (1.0 - path_prob).detach()
    return idx.to(torch.int32), scale


def _forward_st_grouped(params: Params, cfg: FFFConfig, x: torch.Tensor,
                        gen: Optional[torch.Generator] = None,
                        capacity_factor: float = 1.5
                        ) -> tuple[torch.Tensor, dict]:
    """Beyond the paper: top-1 training at O(l) leaf cost.  The hard path
    is followed and each tree's routed leaf output is scaled by
    ``path_prob + sg(1 - path_prob)``, so the value is the leaf output and
    the gradient reaches the path probabilities.  The leaves run the
    capacity-bounded grouped dispatch with the differentiable einsums
    (``serving=False``, never the forward-only kernels); tokens over a
    leaf's capacity get zeros and no leaf gradient."""
    xf, lead = utils.flatten_leading(x)
    xf = xf.to(cfg.accum_dtype)
    xf, B = _pad_for_dispatch(xf, dist_act.data_shard_count())
    probs, mix, ent = _soft_stats(params, cfg, xf, gen)
    if xf.shape[0] != B:      # keep the entropy monitor over real tokens only
        ent = bernoulli_entropy(probs[:B]).mean()
    idx, scale = _st_descend(cfg, probs)
    idx = _sentinel_pads(idx, B, cfg.num_leaves)
    out = None
    kept_all = []
    for t in range(cfg.trees):
        tree_leaves = {k: v[t] for k, v in params.items()
                       if k.startswith("leaf_")}
        y, kept = routing_lib.grouped_leaf_apply(
            xf, idx[:, t], tree_leaves, cfg.activation,
            capacity_factor=capacity_factor, accum_dtype=cfg.accum_dtype,
            serving=False, return_kept=True)
        y = y * scale[:, t:t + 1]
        out = y if out is None else out + y
        kept_all.append(kept[:B])
    overflow = 1.0 - torch.stack(kept_all).to(cfg.accum_dtype).mean()
    aux = {"node_probs": probs[:B], "mixture": mix[:B], "entropy": ent,
           "leaf_idx": idx[:B].reshape(*lead, cfg.trees),
           "overflow_fraction": overflow}
    return utils.unflatten_leading(out[:B], lead), aux


# ---------------------------------------------------------------------------
# capacity-bounded inference: the grouped and grouped_ep backends
# ---------------------------------------------------------------------------

def _pad_for_dispatch(xf: torch.Tensor, multiple: int
                      ) -> tuple[torch.Tensor, int]:
    """Pad flat tokens up to ``multiple`` before routing, so every shard of
    the dispatch holds the same token count.  Returns (padded tokens, true
    token count); callers route the pads to the capacity-neutral sentinel
    leaf and slice outputs back to the true count."""
    B = xf.shape[0]
    Bp = utils.round_up(max(B, 1), multiple)
    if Bp == B:
        return xf, B
    buf = torch.zeros((Bp,) + tuple(xf.shape[1:]), dtype=xf.dtype,
                      device=xf.device)
    buf[:B] = xf
    return buf, B


def _sentinel_pads(leaf_idx: torch.Tensor, true_count: int, num_leaves: int
                   ) -> torch.Tensor:
    """leaf_idx (Bp, T) with rows >= true_count sent to the sentinel leaf E
    (a virtual group that never occupies real capacity)."""
    rows = torch.arange(leaf_idx.shape[0], device=leaf_idx.device)[:, None]
    return torch.where(rows < true_count, leaf_idx,
                       torch.full_like(leaf_idx, num_leaves))


def _sentinel_invalid(leaf_idx: torch.Tensor, valid: Optional[torch.Tensor],
                      lead: tuple, B: int, num_leaves: int
                      ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Route caller-declared invalid tokens to the sentinel leaf, so phantom
    rows (a serving engine's free slots) use no capacity and stay out of the
    routing telemetry.  ``valid`` is broadcastable to the leading shape;
    returns the masked (Bp, T) leaf_idx and the flat (Bp,) validity (pads
    invalid), or (leaf_idx, None) without a mask."""
    if valid is None:
        return leaf_idx, None
    vf = torch.broadcast_to(valid.to(leaf_idx.device), lead).reshape(-1)
    vfp = torch.zeros(leaf_idx.shape[0], dtype=torch.bool,
                      device=leaf_idx.device)
    vfp[:B] = vf
    return (torch.where(vfp[:, None], leaf_idx,
                        torch.full_like(leaf_idx, num_leaves)), vfp)


def _overflow_from_kept(kept_all: list, vfp: Optional[torch.Tensor], B: int,
                        accum_dtype) -> torch.Tensor:
    """Dropped fraction over real routed slots: invalid and sentinel rows
    are never ``kept``, so they leave the denominator."""
    kept = torch.stack(kept_all).to(accum_dtype)              # (T, B)
    if vfp is None:
        return 1.0 - kept.mean()
    w = vfp[:B].to(accum_dtype)
    denom = (w.sum() * kept.shape[0]).clamp(min=1.0)
    return 1.0 - (kept * w[None, :]).sum() / denom


def _dispatch_dtype(params: Params, x: torch.Tensor, accum_dtype):
    """The dtype of the capacity buffers.  On the CPU, JAX's: tokens cast to
    ``accum_dtype``.  On the card, the leaves' dtype (promoted with the
    tokens'), as the cuda backend feeds the grouped GEMMs, which accumulate
    in float32; the output then comes back in the tokens' dtype, as the
    cuda backend's does, so a bf16 residual stream stays bf16.  For bf16
    leaves a deliberate deviation within the bf16 tolerance; for float32
    the two agree."""
    if x.device.type != "cuda":
        return accum_dtype
    w = params["leaf_wd"] if "leaf_wd" in params else params["leaf_w2"]
    return torch.promote_types(x.dtype, w.dtype)


def _forward_hard_capacity(params: Params, cfg: FFFConfig, x: torch.Tensor,
                           multiple: int, valid: Optional[torch.Tensor],
                           dense_levels: int, leaf_fn) -> tuple[torch.Tensor, dict]:
    """The frame both capacity-bounded paths share: flatten, pad to
    ``multiple``, route (the plain descent, as JAX's grouped paths do), send
    pads and invalid tokens to the sentinel leaf, run ``leaf_fn(xf,
    leaf_idx, tree_leaves) -> (y, kept)`` per tree, sum the trees and
    report the dropped fraction over real slots."""
    xf, lead = utils.flatten_leading(x)
    xf = xf.to(_dispatch_dtype(params, xf, cfg.accum_dtype))
    xf, B = _pad_for_dispatch(xf, multiple)
    leaf_idx = route_hard(params, cfg, xf,
                          dense_levels=dense_levels).reshape(xf.shape[0],
                                                             cfg.trees)
    leaf_idx = _sentinel_pads(leaf_idx, B, cfg.num_leaves)
    leaf_idx, vfp = _sentinel_invalid(leaf_idx, valid, lead, B,
                                      cfg.num_leaves)
    out = None
    kept_all = []
    for t in range(cfg.trees):
        tree_leaves = {k: v[t] for k, v in params.items()
                       if k.startswith("leaf_")}
        y, kept = leaf_fn(xf, leaf_idx[:, t], tree_leaves)
        out = y if out is None else out + y
        kept_all.append(kept[:B])
    overflow = _overflow_from_kept(kept_all, vfp, B, cfg.accum_dtype)
    aux = {"leaf_idx": leaf_idx[:B].reshape(*lead, cfg.trees),
           "overflow_fraction": overflow}
    y = out[:B]
    if x.device.type == "cuda":      # the tokens' dtype, as the cuda backend
        y = y.to(x.dtype)
    return utils.unflatten_leading(y, lead), aux


def _forward_hard_grouped(params: Params, cfg: FFFConfig, x: torch.Tensor,
                          capacity_factor: float = 2.0, dense_levels: int = 8,
                          valid: Optional[torch.Tensor] = None,
                          overflow_policy: str = "drop"
                          ) -> tuple[torch.Tensor, dict]:
    """FORWARD_I via capacity-bounded grouped dispatch.  ``valid``
    (broadcastable to x's leading shape) routes phantom tokens to the
    sentinel leaf: no capacity used, zero output, no overflow counted.

    ``overflow_policy``: "drop" (over-capacity tokens contribute zeros),
    "exact_dense" (the dropped tokens, and only those, get their exact leaf
    output) or "master_leaf" (as "drop" at this layer: the master term
    ``api.apply`` adds to every token is what dropped tokens fall back to).
    ``overflow_fraction`` reports the true over-capacity rate under every
    policy."""
    E = cfg.num_leaves

    def leaves(xf, idx, tl):
        y, kept = routing_lib.grouped_leaf_apply(
            xf, idx, tl, cfg.activation, capacity_factor=capacity_factor,
            accum_dtype=cfg.accum_dtype, serving=True, return_kept=True)
        if overflow_policy == "exact_dense":
            # only real overflow: sentinel pads and invalid rows need none
            y = routing_lib._repair(y, ~kept & (idx < E), xf, idx, tl,
                                    cfg.activation, cfg.accum_dtype)
        return y, kept

    return _forward_hard_capacity(params, cfg, x, dist_act.data_shard_count(),
                                  valid, dense_levels, leaves)


def _forward_hard_ep(params: Params, cfg: FFFConfig, x: torch.Tensor,
                     capacity_factor: float = 1.25, dense_levels: int = 8,
                     valid: Optional[torch.Tensor] = None,
                     overflow_policy: str = "exact_dense"
                     ) -> tuple[torch.Tensor, dict]:
    """FORWARD_I via expert-parallel all_to_all dispatch
    (``routing.grouped_leaf_apply_ep``): routing runs on every rank, and
    tokens travel to the rank owning their leaf.  The leaves may be stored
    sharded (each rank's E/M, ``distributed/sharding``).  Under the default
    "exact_dense" over-capacity tokens are repaired, so outputs match the
    reference backend; "master_leaf" and "drop" skip the repair round.
    ``overflow_fraction`` reports the true over-capacity rate either way."""
    def leaves(xf, idx, tl):
        return routing_lib.grouped_leaf_apply_ep(
            xf, idx, tl, cfg.activation, capacity_factor=capacity_factor,
            accum_dtype=cfg.accum_dtype, overflow_policy=overflow_policy,
            return_kept=True, num_leaves=cfg.num_leaves)

    return _forward_hard_capacity(
        params, cfg, x,
        dist_act.data_shard_count() * dist_act.model_shard_count(),
        valid, dense_levels, leaves)


# ---------------------------------------------------------------------------
# hardening (paper §Hardening), balance and the routing diagnostics
# ---------------------------------------------------------------------------

def bernoulli_entropy(p: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """H(Bernoulli(p)) in nats, elementwise, with p clipped to [eps, 1 - eps].

    Evaluated in float32 and returned in p's dtype.  For float32 p this is
    the JAX package's arithmetic; for bfloat16 p it is a deliberate
    deviation: 1 - 1e-7 rounds to 1 in bfloat16, so the JAX package's clip
    cannot keep a saturated p (a node logit above ~6.2) below 1 and its
    entropy is 0 * log(0), NaN."""
    q = p.float().clamp(eps, 1.0 - eps)
    return (-(q * torch.log(q) + (1.0 - q) * torch.log1p(-q))).to(p.dtype)


def hardening_loss(node_probs: torch.Tensor, reduction: str = "mean"
                   ) -> torch.Tensor:
    """L_harden: the decision entropies summed (the paper) or, by default,
    averaged (scale-invariant across depths; the scale is ``h``)."""
    ent = bernoulli_entropy(node_probs)
    return ent.sum() if reduction == "sum" else ent.mean()


def balance_loss(node_probs: torch.Tensor, depth: int) -> torch.Tensor:
    """Load balancing over soft leaf usage: (B, T, N) -> scalar
    ``E * sum_e mean_batch(P)_e^2 - 1``, mean over trees, P each token's
    soft leaf mixture.  0 exactly at uniform mean usage, growing with skew."""
    if depth == 0:
        return torch.zeros((), dtype=node_probs.dtype, device=node_probs.device)
    mix = mixture_weights(node_probs, depth)           # (B, T, E)
    usage = mix.mean(dim=0)                            # (T, E)
    return (mix.shape[-1] * torch.square(usage).sum(dim=-1) - 1.0).mean()


def leaf_usage(node_probs: torch.Tensor, depth: int) -> torch.Tensor:
    """Mean soft leaf usage per tree: (B, T, N) -> (T, 2^depth)."""
    return mixture_weights(node_probs, depth).mean(dim=0)


def decision_entropy_per_node(node_probs: torch.Tensor) -> torch.Tensor:
    """Batch-mean Bernoulli entropy per node: (B, T, N) -> (T, N); below
    ~0.10 rounding is nearly lossless (the paper's hardening monitor)."""
    return bernoulli_entropy(node_probs).mean(dim=0)


def decisive_fraction(node_probs: torch.Tensor, threshold: float = 0.10
                      ) -> torch.Tensor:
    """Fraction of (token, node) decisions whose entropy is below threshold."""
    return (bernoulli_entropy(node_probs) < threshold).float().mean()


# ---------------------------------------------------------------------------
# equivalence helper (paper §Size and width)
# ---------------------------------------------------------------------------

def as_dense_ff_params(params: Params, cfg: FFFConfig) -> Params:
    """An FFF with all node weights zero is a vanilla FF of 2^d * l neurons,
    up to the uniform output scale 2^-d; returns that dense parameter set
    (single tree, MLP leaves)."""
    if cfg.trees != 1 or cfg.activation == "swiglu":
        raise ValueError("dense equivalence defined for single-tree MLP leaves")
    L = cfg.num_leaves
    w1 = params["leaf_w1"][0].permute(1, 0, 2).reshape(cfg.dim_in, L * cfg.leaf_width)
    w2 = (params["leaf_w2"][0] * (1.0 / L)).reshape(L * cfg.leaf_width, cfg.dim_out)
    out: Params = {"w1": w1, "w2": w2}
    if "leaf_b1" in params:
        out["b1"] = params["leaf_b1"][0].reshape(L * cfg.leaf_width)
        out["b2"] = params["leaf_b2"][0].sum(dim=0) * (1.0 / L)
    return out
