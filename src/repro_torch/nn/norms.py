"""Normalization layers (port of ``repro/nn/norms.py``): reductions in
float32, the normalize multiply in the input dtype."""
from __future__ import annotations

import torch

Params = dict


def rmsnorm_init(dim: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mean.to(x.dtype)) * inv
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def norm_init(kind: str, dim: int, dtype=torch.float32, device="cpu") -> Params:
    return (rmsnorm_init(dim, dtype, device) if kind == "rmsnorm"
            else layernorm_init(dim, dtype, device))


def norm_apply(kind: str, params: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)
