"""Sparsely-gated mixture-of-experts baseline (port of ``repro/core/
moe.py``; Shazeer et al., 2017): the paper's direct contender.

Noisy top-k gating over ``E`` expert blocks with the importance and
load-balancing auxiliary losses, kept to the original formulation (noise =
softplus(x @ Wn) * N(0, 1), drawn from an explicit ``torch.Generator``;
the load loss through the normal-CDF inclusion probability).

Top-k is stable, as ``jax.lax.top_k`` is: of equal logits the lower expert
index ranks first (the zero-initialised gates tie every expert).  The JAX
package has no Pallas kernel here.  ``forward_sparse`` treats the B k
(token, choice) pairs as tokens routed to experts and runs them on the FFF
leaves' grouped GEMMs (``kernels/leaf_gemm``), at shapes the token count
alone fixes, with nothing read on the host (so a serving dispatch through
it is captured as a CUDA graph); ``forward_sparse_gather`` is the JAX
package's form, a per-token gathered ``(B, D, H)`` expert slab for each of
the k choices, kept as the plain version the grouped form is held against
(the two differ only in summation order and, in bf16, in rounding the
hidden layer to bf16).  The gathered slab is 4.3 GB a take at
olmoe-1b-7b's widths and 1024 tokens in bf16, which is why serving does
not use it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import utils
from repro_torch.kernels.leaf_gemm import kernel as gemm_kernel
from repro_torch.kernels.leaf_gemm import ops as gemm_ops
from repro_torch.kernels.leaf_gemm import ref as gemm_ref

Params = dict


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim_in: int
    dim_out: int
    num_experts: int
    expert_width: int
    top_k: int = 2
    activation: str = "gelu"
    noisy_gating: bool = True
    w_importance: float = 0.1      # the paper's comparison uses 0.1 for both
    w_load: float = 0.1
    bias: bool = True
    param_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32

    @property
    def training_width(self) -> int:
        return self.num_experts * self.expert_width

    @property
    def inference_width(self) -> int:
        return self.top_k * self.expert_width


def init(gen: torch.Generator, cfg: MoEConfig) -> Params:
    """Zero gates and noise weights (Shazeer), He-normal up and LeCun-normal
    down projections drawn from ``gen`` on its device."""
    E, D, H, O = cfg.num_experts, cfg.dim_in, cfg.expert_width, cfg.dim_out
    pd, dev = cfg.param_dtype, gen.device
    p: Params = {
        "gate_w": torch.zeros((D, E), dtype=pd, device=dev),
        "noise_w": torch.zeros((D, E), dtype=pd, device=dev),
        "expert_w1": utils.he_normal(gen, (E, D, H), pd, fan_in_axis=-2),
        "expert_w2": utils.lecun_normal(gen, (E, H, O), pd, fan_in_axis=-2),
    }
    if cfg.bias:
        p["expert_b1"] = torch.zeros((E, H), dtype=pd, device=dev)
        p["expert_b2"] = torch.zeros((E, O), dtype=pd, device=dev)
    return p


def _cv_squared(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Squared coefficient of variation: the balancing loss's shape."""
    x = x.float()
    return x.var(unbiased=False) / (x.mean() ** 2 + eps)


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: values descending, ties to the
    lower index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_gates(clean: torch.Tensor, noisy: torch.Tensor,
                 noise_std: torch.Tensor, k: int, train: bool,
                 num_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gates (B, E) plus the differentiable load estimate (E,).  The normal
    CDF is taken in float32 (JAX takes it in the logits' dtype; the two
    agree in float32)."""
    logits = noisy if train else clean
    kk = min(k + 1, num_experts)
    top_vals, top_idx = top_k(logits, kk)
    gates_k = torch.softmax(top_vals[:, :k], dim=-1)
    gates = torch.zeros_like(logits).scatter(1, top_idx[:, :k], gates_k)

    if not train or kk <= k:
        return gates, (gates > 0).float().sum(dim=0)

    # P(expert e stays in the top-k when its noise alone is resampled): the
    # threshold is the k-th highest *other* noisy logit (Shazeer App. A)
    in_topk = torch.zeros_like(logits, dtype=torch.bool).scatter(
        1, top_idx[:, :k], True)
    thr_if_in = top_vals[:, k:k + 1]           # displaced by the (k+1)-th
    thr_if_out = top_vals[:, k - 1:k]          # must beat the current k-th
    threshold = torch.where(in_topk, thr_if_in, thr_if_out)
    z = (clean - threshold) / torch.clamp(noise_std, min=1e-4)
    prob = torch.special.ndtr(z.float())
    return gates, prob.sum(dim=0)


def _expert_mlp(params: Params, cfg: MoEConfig, x: torch.Tensor,
                e: torch.Tensor) -> torch.Tensor:
    """Experts ``e`` (n,) on x (n, D) -> (n, O), one expert a row, through
    the gathered (n, D, H) slab of the JAX form."""
    ad = cfg.accum_dtype
    h = utils.einsum_as("bd,bdh->bh", x, params["expert_w1"][e], out_dtype=ad)
    if "expert_b1" in params:
        h = h + params["expert_b1"][e].to(ad)
    h = utils.get_activation(cfg.activation)(h)
    y = utils.einsum_as("bh,bho->bo", h, params["expert_w2"][e], out_dtype=ad)
    if "expert_b2" in params:
        y = y + params["expert_b2"][e].to(ad)
    return y


def forward(params: Params, cfg: MoEConfig, x: torch.Tensor,
            gen: Optional[torch.Generator] = None, train: bool = True
            ) -> tuple[torch.Tensor, dict]:
    """x (..., D) -> (..., O), aux: gates, aux_loss (importance + load),
    load, importance.  Noisy gating needs ``train``, ``cfg.noisy_gating``
    and a generator; without one the gates are clean (the load estimate
    still takes unit noise).  Dense combine: every expert is evaluated and
    weighted by its gate."""
    ad = cfg.accum_dtype
    xf, lead = utils.flatten_leading(x)
    xf = xf.to(ad)
    clean = utils.einsum_as("bd,de->be", xf, params["gate_w"], out_dtype=ad)
    if cfg.noisy_gating and train and gen is not None:
        raw = utils.einsum_as("bd,de->be", xf, params["noise_w"], out_dtype=ad)
        noise_std = F.softplus(raw) + 1e-2
        noise = torch.randn(clean.shape, generator=gen, device=gen.device,
                            dtype=torch.float32).to(clean.device)
        noisy = clean + noise * noise_std
    else:
        noise_std = torch.ones_like(clean)
        noisy = clean
    gates, load = _top_k_gates(clean, noisy, noise_std, cfg.top_k,
                               train and cfg.noisy_gating, cfg.num_experts)
    importance = gates.sum(dim=0)
    aux_loss = (cfg.w_importance * _cv_squared(importance)
                + cfg.w_load * _cv_squared(load))

    h = utils.einsum_as("bd,edh->beh", xf, params["expert_w1"], out_dtype=ad)
    if "expert_b1" in params:
        h = h + params["expert_b1"][None].to(ad)
    h = utils.get_activation(cfg.activation)(h)
    y_e = utils.einsum_as("beh,eho->beo", h, params["expert_w2"], out_dtype=ad)
    if "expert_b2" in params:
        y_e = y_e + params["expert_b2"][None].to(ad)
    y = utils.einsum_as("be,beo->bo", gates, y_e,
                        out_dtype=torch.promote_types(gates.dtype, y_e.dtype))
    aux = {"gates": gates, "aux_loss": aux_loss, "load": load,
           "importance": importance}
    return utils.unflatten_leading(y, lead), aux


def _clean_top_k(params: Params, cfg: MoEConfig, x: torch.Tensor):
    ad = cfg.accum_dtype
    xf, lead = utils.flatten_leading(x)
    xf = xf.to(ad)
    clean = utils.einsum_as("bd,de->be", xf, params["gate_w"], out_dtype=ad)
    top_vals, top_idx = top_k(clean, cfg.top_k)                 # (B, k)
    return xf, lead, torch.softmax(top_vals, dim=-1), top_idx


def _combine(ys, gates_k: torch.Tensor) -> torch.Tensor:
    """sum_j ys[j] * gates_k[:, j], in j order (the JAX package's Python
    sum)."""
    y = 0
    for j, yj in enumerate(ys):
        y = y + yj * gates_k[:, j:j + 1]
    return y


#: an expert's rows in ``forward_sparse``'s first pass: twice its even
#: share of the (token, choice) pairs, in steps of CAPACITY_STEP rows
CAPACITY_FACTOR, CAPACITY_STEP = 2.0, 8


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """An expert's rows in ``forward_sparse``'s first pass for ``tokens``
    tokens: ``CAPACITY_FACTOR`` times its even share of the tokens x k
    pairs, and no more than the tokens, each rounded up to
    ``CAPACITY_STEP``.  The k experts of a token are distinct, so an expert
    holds at most one pair a token: at this capacity a slab of at most C
    tokens never overflows."""
    share = int(CAPACITY_FACTOR * utils.cdiv(tokens * cfg.top_k, cfg.num_experts))
    return min(utils.round_up(tokens, CAPACITY_STEP),
               utils.round_up(share, CAPACITY_STEP))


def overflow_rows(tokens: int, cfg: MoEConfig) -> int:
    """The overflow pass's rows an expert: the most pairs one expert can
    hold past ``capacity`` (one a token), rounded up to 32; 0 where the pass
    is left out.  The shape alone decides."""
    return gemm_ops.overflow_rows(tokens, capacity(tokens, cfg))


def _experts(params: Params, cfg: MoEConfig, layout, w1: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    """Every expert's MLP over a layout's buffers through the grouped GEMMs,
    gathered back to the pairs (zeros for pairs outside the buffers).
    Biases are added on the buffers; rows past an expert's group size are
    junk then, which no pair gathers and the down GEMM never reads (its
    rows past the size come out zero whatever x holds there)."""
    gs, b1, b2 = layout.group_sizes, params.get("expert_b1"), params.get("expert_b2")
    if b1 is None and cfg.activation in gemm_ref.ACTS:
        h = gemm_kernel.grouped_matmul(layout.x_grouped, w1, gs, act=cfg.activation)
    else:
        h = gemm_kernel.grouped_matmul(layout.x_grouped, w1, gs)
        if b1 is not None:
            h = h + b1.to(h.dtype)[:, None]
        h = utils.get_activation(cfg.activation)(h)
    y = gemm_kernel.grouped_matmul(h, w2, gs)
    if b2 is not None:
        y = y + b2.to(y.dtype)[:, None]
    return gemm_ops.gather_from_groups(y, layout)


def forward_sparse(params: Params, cfg: MoEConfig, x: torch.Tensor
                   ) -> tuple[torch.Tensor, dict]:
    """Inference: clean top-k, only the selected experts evaluated.  The
    gate only knows its experts through an O(E) logit row, the linear cost
    the paper contrasts with FFF's O(log E) descent.

    The B k (token, choice) pairs are routed like tokens to leaves: each
    takes a slot in its expert by sort ranks and counts by ``index_add_``
    (``leaf_gemm.ops``), is scattered into capacity-padded (E, C, D)
    buffers (``capacity``), runs the grouped GEMMs up (the activation
    fused) and down, and is gathered back and combined in choice order.
    Pairs past C take an overflow pass on the same kernels, slot ``s - C``
    of (E, ``overflow_rows``, D), so no pair is dropped.  Shapes depend on
    B alone and nothing is read on the host.  The buffers are not
    cleared: the kernels read no row past an expert's group size.  The
    products run in the weights' dtype (x's where it is wider)."""
    xf, lead, gates_k, top_idx = _clean_top_k(params, cfg, x)
    B, k = top_idx.shape
    E = cfg.num_experts
    dt = xf.dtype
    for n in ("expert_w1", "expert_w2"):
        dt = torch.promote_types(dt, params[n].dtype)
    w1, w2 = (params[n].to(dt).contiguous() for n in ("expert_w1", "expert_w2"))
    pairs = xf.to(dt)[:, None].expand(B, k, xf.shape[1]).reshape(B * k, -1)
    flat = top_idx.reshape(-1)
    slot = gemm_ops._slots(flat, E, None)
    C = capacity(B, cfg)
    y = _experts(params, cfg, gemm_ops._layout(pairs, flat, slot, E, C, zero=False),
                 w1, w2)
    rows = overflow_rows(B, cfg)
    if rows:
        over = gemm_ops._layout(pairs, flat, slot, E, rows, first=C, zero=False)
        y = torch.where(over.kept[:, None], _experts(params, cfg, over, w1, w2), y)
    y = y.to(cfg.accum_dtype).view(B, k, -1)
    out = _combine([y[:, j] for j in range(k)], gates_k)
    return utils.unflatten_leading(out, lead), {"expert_idx": top_idx}


def forward_sparse_gather(params: Params, cfg: MoEConfig, x: torch.Tensor
                          ) -> tuple[torch.Tensor, dict]:
    """The JAX package's ``forward_sparse``: for each of the k choices a
    gathered (B, D, H) expert slab per token.  The plain version
    ``forward_sparse`` is held against."""
    xf, lead, gates_k, top_idx = _clean_top_k(params, cfg, x)
    ys = [_expert_mlp(params, cfg, xf, top_idx[:, j]) for j in range(cfg.top_k)]
    return (utils.unflatten_leading(_combine(ys, gates_k), lead),
            {"expert_idx": top_idx})
