"""xLSTM blocks (port of ``repro/nn/xlstm.py``): mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory, strictly sequential) — Beck
et al., 2024 (arXiv:2405.04517).

The mLSTM state per head is a (hd x hd) matrix updated with exponential
gating::

    C_t = f_t C_{t-1} + i_t v_t k_t^T,   n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t q_t / max(|n_t . q_t|, 1)

computed chunkwise in log space (a loop over chunks where JAX runs
``lax.scan``; dense einsums inside a chunk), with the per-step recurrence
kept as the oracle.  The intra-chunk log weights are masked with ``-inf``,
so ``exp`` gives exact zeros above the diagonal.  Plain PyTorch: the JAX
package computes both outside Pallas.  Block wiring and dtypes are JAX's:
projections into ``accum_dtype``, GroupNorm over heads in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import utils

Params = dict

#: the stabilizer's starting value (the JAX package's)
M_START = -1e30


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2                # mLSTM up-projection factor
    chunk: int = 256
    param_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, hd, hd)
    n: torch.Tensor   # (B, H, hd)
    m: torch.Tensor   # (B, H)  running log-scale


class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, d_model)
    c: torch.Tensor   # (B, d_model)
    n: torch.Tensor   # (B, d_model)
    m: torch.Tensor   # (B, d_model)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: XLSTMConfig) -> Params:
    """Keys and shapes of ``repro.nn.xlstm.mlstm_init``, drawn from ``gen``."""
    D, DI, H, hd = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.head_dim
    pd, dev = cfg.param_dtype, gen.device
    s, si = 1.0 / math.sqrt(D), 1.0 / math.sqrt(DI)
    return {
        "up_proj": utils.truncated_init(gen, (D, 2 * DI), s, pd),
        "wq": utils.truncated_init(gen, (DI, H, hd), si, pd),
        "wk": utils.truncated_init(gen, (DI, H, hd), si, pd),
        "wv": utils.truncated_init(gen, (DI, H, hd), si, pd),
        "w_if": utils.truncated_init(gen, (DI, 2 * H), si, pd),
        # forget-gate bias >> 0 so early training approximates a cumulative sum
        "b_if": torch.cat([torch.zeros(H), torch.full((H,), 3.0)]).to(dev, pd),
        "gn_scale": torch.ones((H, hd), dtype=pd, device=dev),
        "down_proj": utils.truncated_init(gen, (DI, D), si, pd),
    }


def _mlstm_gates(params: Params, cfg: XLSTMConfig, xi: torch.Tensor):
    """q, k, v (B, S, H, hd); log-i, log-f (B, S, H)."""
    ad = cfg.accum_dtype
    q = utils.einsum_as("bsd,dhk->bshk", xi, params["wq"], out_dtype=ad)
    k = utils.einsum_as("bsd,dhk->bshk", xi, params["wk"], out_dtype=ad) \
        / math.sqrt(cfg.head_dim)
    v = utils.einsum_as("bsd,dhk->bshk", xi, params["wv"], out_dtype=ad)
    g = utils.einsum_as("bsd,dh->bsh", xi, params["w_if"], out_dtype=ad) \
        + params["b_if"].to(ad)
    log_i, f_pre = torch.chunk(g, 2, dim=-1)
    return q, k, v, log_i, F.logsigmoid(f_pre)     # exp-gating, sigmoid forget


def mlstm_sequential(q, k, v, log_i, log_f, state: MLSTMState
                     ) -> tuple[torch.Tensor, MLSTMState]:
    """The oracle: the stabilized per-step recurrence.  Shapes as in
    ``_mlstm_gates``."""
    C, n, m = state
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, lit, lft = (a[:, t] for a in (q, k, v, log_i, log_f))
        m_new = torch.maximum(lft + m, lit)                       # (B, H)
        i_p = torch.exp(lit - m_new)
        f_p = torch.exp(lft + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] \
            * (vt[..., :, None] * kt[..., None, :])               # (B, H, hd, hd)
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = utils.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.abs(utils.einsum("bhk,bhk->bh", n, qt))
        hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, dim=1), MLSTMState(C, n, m)


def mlstm_chunkwise(q, k, v, log_i, log_f, state: MLSTMState, chunk: int
                    ) -> tuple[torch.Tensor, MLSTMState]:
    """The chunkwise-parallel stabilized mLSTM (the production path): a
    loop over S/chunk chunks; inside a chunk the causal intra-chunk terms
    and the carried state are dense einsums.  C and n are kept scaled by
    exp(-m)."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = math.gcd(S, chunk)
    C, n, m = state
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c0 in range(0, S, chunk):
        qt, kt, vt, lit, lft = (a[:, c0:c0 + chunk] for a in (q, k, v, log_i, log_f))
        Fc = torch.cumsum(lft, dim=1)           # (B, C, H) cumulative log-f
        # the log weight of source step s seen at the chunk end: F_L - F_s + li_s
        F_last = Fc[:, -1:, :]
        src = F_last - Fc + lit                 # (B, C, H)
        m_new = torch.maximum(F_last[:, 0] + m, src.amax(dim=1))    # (B, H)
        # intra-chunk: score(t, s) = q_t.k_s * exp(F_t - F_s + li_s), each
        # row stabilized by b_t = max(F_t + m, max_{s<=t} (F_t - F_s + li_s))
        dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + lit[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat,
                           torch.full_like(dmat, -math.inf))      # (B, Ct, Cs, H)
        inter_log = Fc + m[:, None, :]                            # (B, C, H)
        b = torch.maximum(dmat.amax(dim=2), inter_log)            # (B, C, H)
        w_intra = torch.exp(dmat - b[:, :, None, :])
        scores = utils.einsum("bthk,bshk->btsh", qt, kt) * w_intra
        num = utils.einsum("btsh,bshv->bthv", scores, vt)
        den = scores.sum(dim=2)                                   # (B, C, H)
        # inter-chunk: the carried C (already exp(-m)-scaled)
        w_inter = torch.exp(inter_log - b)
        num = num + utils.einsum("bthk,bhvk->bthv", qt, C) * w_inter[..., None]
        den = den + utils.einsum("bthk,bhk->bth", qt, n) * w_inter
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-b))[..., None])
        # the state update, rescaled to the new stabilizer m_new
        w_src = torch.exp(src - m_new[:, None, :])                # (B, C, H)
        w_old = torch.exp(F_last[:, 0] + m - m_new)               # (B, H)
        # the weights go onto k first: a three-operand einsum may build the
        # (B, C, H, hd, hd) outer product (8.6 GB at xlstm-1.3b, batch 8)
        C = w_old[..., None, None] * C + utils.einsum(
            "bshv,bshk->bhvk", vt, kt * w_src[..., None])
        n = w_old[..., None] * n + utils.einsum("bshk,bsh->bhk", kt, w_src)
        m = m_new
    return torch.cat(hs, dim=1), MLSTMState(C, n, m)


def _group_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head LayerNorm (GroupNorm with groups = heads): x (B, S, H, hd)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


def mlstm_block(params: Params, cfg: XLSTMConfig, x: torch.Tensor,
                state: MLSTMState | None = None, *, sequential: bool = False
                ) -> tuple[torch.Tensor, MLSTMState]:
    """The whole mLSTM block: (B, S, D) -> (B, S, D) and the state."""
    ad = cfg.accum_dtype
    B, S, _ = x.shape
    if state is None:
        state = mlstm_init_state(B, cfg, device=x.device)
    up = utils.einsum_as("bsd,de->bse", x, params["up_proj"], out_dtype=ad)
    xi, z = torch.chunk(up, 2, dim=-1)
    q, k, v, log_i, log_f = _mlstm_gates(params, cfg, xi)
    if sequential:
        h, new_state = mlstm_sequential(q, k, v, log_i, log_f, state)
    else:
        h, new_state = mlstm_chunkwise(q, k, v, log_i, log_f, state, cfg.chunk)
    h = _group_norm(h, params["gn_scale"]).reshape(B, S, cfg.d_inner)
    h = h * F.silu(z)
    return utils.einsum_as("bse,ed->bsd", h, params["down_proj"],
                           out_dtype=ad), new_state


def mlstm_init_state(batch: int, cfg: XLSTMConfig, dtype=torch.float32,
                     device="cpu") -> MLSTMState:
    H, hd = cfg.n_heads, cfg.head_dim
    return MLSTMState(torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
                      torch.zeros((batch, H, hd), dtype=dtype, device=device),
                      torch.full((batch, H), M_START, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: XLSTMConfig) -> Params:
    """Keys and shapes of ``repro.nn.xlstm.slstm_init``, drawn from ``gen``."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    pd, dev = cfg.param_dtype, gen.device
    s = 1.0 / math.sqrt(D)
    return {
        # 4 gates (i, f, z, o) from the input; recurrent weights block-diagonal
        "w_x": utils.truncated_init(gen, (D, 4 * D), s, pd),
        "w_h": utils.truncated_init(gen, (H, dh, 4 * dh), 1.0 / math.sqrt(dh), pd),
        "b": torch.cat([torch.zeros(D), torch.full((D,), 3.0),
                        torch.zeros(2 * D)]).to(dev, pd),
        "gn_scale": torch.ones(D, dtype=pd, device=dev),
        "out_proj": utils.truncated_init(gen, (D, D), s, pd),
    }


def slstm_block(params: Params, cfg: XLSTMConfig, x: torch.Tensor,
                state: SLSTMState | None = None
                ) -> tuple[torch.Tensor, SLSTMState]:
    """The strictly sequential sLSTM: (B, S, D) -> (B, S, D) and the state."""
    ad = cfg.accum_dtype
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    if state is None:
        state = slstm_init_state(B, D, dtype=ad, device=x.device)
    gx = utils.einsum_as("bsd,de->bse", x, params["w_x"], out_dtype=ad) \
        + params["b"].to(ad)                                      # (B, S, 4D)
    w_h = params["w_h"].to(ad)
    h, c, n, m = state
    hs = []
    for t in range(S):
        gr = utils.einsum("bhk,hke->bhe", h.reshape(B, H, dh), w_h)
        g = gx[:, t] + gr.reshape(B, 4 * D)
        gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
        log_f = F.logsigmoid(gf)
        m_new = torch.maximum(log_f + m, gi)
        i_p = torch.exp(gi - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * torch.tanh(gz)
        n = f_p * n + i_p
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1)                                    # (B, S, D)
    yh = _group_norm(y.reshape(B, S, H, dh),
                     params["gn_scale"].reshape(H, dh)).reshape(B, S, D)
    out = utils.einsum_as("bsd,de->bse", yh, params["out_proj"], out_dtype=ad)
    return out, SLSTMState(h, c, n, m)


def slstm_init_state(batch: int, d_model: int, dtype=torch.float32,
                     device="cpu") -> SLSTMState:
    z = lambda: torch.zeros((batch, d_model), dtype=dtype, device=device)
    return SLSTMState(z(), z(), z(),
                      torch.full((batch, d_model), M_START, dtype=dtype, device=device))
