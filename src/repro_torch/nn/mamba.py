"""Mamba (selective SSM) block, the Jamba hybrid's sequence mixer (port of
``repro/nn/mamba.py``).

The selective scan runs chunk by chunk, as the JAX package's ``lax.scan``
over chunks does; inside a chunk the recurrence ``h_t = da_t * h_{t-1} +
dbx_t`` is a step loop where JAX runs an ``associative_scan``.  Each step
builds its own ``(B, d_inner, d_state)`` factors and reads its output off
``h_t`` at once, so no ``(B, chunk, d_inner, d_state)`` tensor is ever
held.  Plain PyTorch: the JAX package computes the scan outside Pallas.
The dtype policy is JAX's: projections into ``accum_dtype``, the state in
``accum_dtype``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import utils

Params = dict


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    chunk: int = 256
    param_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or utils.cdiv(self.d_model, 16)


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv - 1, d_inner) the latest inputs
    ssm: torch.Tensor     # (B, d_inner, d_state)


def init(gen: torch.Generator, cfg: MambaConfig) -> Params:
    """Keys and shapes of ``repro.nn.mamba.init``, drawn from ``gen``."""
    D, DI, N, R = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.resolved_dt_rank
    pd, dev = cfg.param_dtype, gen.device
    # dt bias: softplus^-1 of dt ~ log-uniform on [1e-3, 1e-1] (Mamba init)
    u = torch.rand(DI, generator=gen, device=dev, dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log1p(-torch.exp(-dt))
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev))
    return {
        "in_proj": utils.truncated_init(gen, (D, 2 * DI), 1.0 / math.sqrt(D), pd),
        "conv_w": utils.truncated_init(gen, (cfg.d_conv, DI),
                                       1.0 / math.sqrt(cfg.d_conv), pd),
        "conv_b": torch.zeros(DI, dtype=pd, device=dev),
        "x_proj": utils.truncated_init(gen, (DI, R + 2 * N), 1.0 / math.sqrt(DI), pd),
        "dt_proj": utils.truncated_init(gen, (R, DI), 1.0 / math.sqrt(R), pd),
        "dt_bias": dt_bias.to(pd),
        "A_log": a_log.repeat(DI, 1).to(pd),
        "D_skip": torch.ones(DI, dtype=pd, device=dev),
        "out_proj": utils.truncated_init(gen, (DI, D), 1.0 / math.sqrt(DI), pd),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x (B, S, DI), w (k, DI); history (B, k-1,
    DI) holds the previous segment's last inputs (zeros at the start)."""
    k, S = w.shape[0], x.shape[1]
    if history is None:
        history = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                              device=x.device)
    xp = torch.cat([history, x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(k))
    return out + b


def scan_sequence(params: Params, cfg: MambaConfig, xz: torch.Tensor,
                  state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """The SSM over (B, S, DI) pre-activation input; returns (B, S, DI)
    and the final state."""
    ad = cfg.accum_dtype
    B, S, DI = xz.shape
    N, R = cfg.d_state, cfg.resolved_dt_rank
    chunk = min(cfg.chunk, S)
    if S % chunk:
        chunk = math.gcd(S, chunk)
    A = -torch.exp(params["A_log"].to(ad))                        # (DI, N)
    h, hist = state.ssm, state.conv
    ys = []
    for c0 in range(0, S, chunk):
        x_chunk = xz[:, c0:c0 + chunk]                            # (B, C, DI)
        xc = F.silu(_causal_conv(x_chunk, params["conv_w"], params["conv_b"], hist))
        proj = utils.einsum_as("bcd,dr->bcr", xc, params["x_proj"], out_dtype=ad)
        dt_r, Bmat, Cmat = torch.split(proj, [R, N, N], dim=-1)
        dt = F.softplus(utils.einsum_as("bcr,rd->bcd", dt_r, params["dt_proj"],
                                        out_dtype=ad)
                        + params["dt_bias"].to(ad))               # (B, C, DI)
        steps = []
        for t in range(chunk):
            dt_t = dt[:, t, :, None]                              # (B, DI, 1)
            h = (torch.exp(dt_t * A) * h
                 + dt_t * Bmat[:, t, None, :] * xc[:, t, :, None])
            steps.append(utils.einsum("bdn,bn->bd", h, Cmat[:, t]))
        ys.append(torch.stack(steps, dim=1) + xc * params["D_skip"].to(ad))
        hist = torch.cat([hist, x_chunk], dim=1)[:, -(cfg.d_conv - 1):]
    return torch.cat(ys, dim=1), MambaState(hist, h)


def init_state(batch: int, cfg: MambaConfig, dtype=None, device="cpu") -> MambaState:
    dtype = dtype or cfg.accum_dtype
    return MambaState(
        torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=dtype, device=device))


def forward(params: Params, cfg: MambaConfig, x: torch.Tensor,
            state: MambaState | None = None) -> tuple[torch.Tensor, MambaState]:
    """The whole Mamba block: x (B, S, D) -> (B, S, D) and the final state."""
    ad = cfg.accum_dtype
    if state is None:
        state = init_state(x.shape[0], cfg, device=x.device)
    xz = utils.einsum_as("bsd,de->bse", x, params["in_proj"], out_dtype=ad)
    xs, z = torch.chunk(xz, 2, dim=-1)
    y, new_state = scan_sequence(params, cfg, xs, state)
    y = y * F.silu(z)
    out = utils.einsum_as("bse,ed->bsd", y, params["out_proj"], out_dtype=ad)
    return out, new_state


def forward_step(params: Params, cfg: MambaConfig, x1: torch.Tensor,
                 state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """One-token decode: x1 (B, 1, D) -> (B, 1, D), O(1) in the context."""
    return forward(params, cfg, x1, state)
