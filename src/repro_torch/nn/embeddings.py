"""Token embeddings and the LM head (port of ``repro/nn/embeddings.py``),
learned position rows, and the frontend stubs: the audio and vision archs
take precomputed frame or patch embeddings through a learned projection,
not a conv or ViT tower."""
from __future__ import annotations

import math

import torch

from repro_torch import utils

Params = dict


def embed_init(gen: torch.Generator, vocab: int, d_model: int, *, tie: bool,
               param_dtype) -> Params:
    p: Params = {"tok": utils.truncated_init(gen, (vocab, d_model),
                                             1.0 / math.sqrt(d_model), param_dtype)}
    if not tie:
        p["head"] = utils.truncated_init(gen, (d_model, vocab),
                                         1.0 / math.sqrt(d_model), param_dtype)
    return p


def embed(params: Params, tokens: torch.Tensor,
          accum_dtype=torch.float32) -> torch.Tensor:
    return params["tok"][tokens.long()].to(accum_dtype)


def logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., D) -> (..., V) in float32.  Float32 operands multiply in
    float32; a bf16 head multiplies in bf16 (f32 accumulation inside the
    matmul) and the result is cast, rather than copying the head to f32."""
    w = params["head"] if "head" in params else params["tok"].t()
    ct = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(ct), w.to(ct)).float()


def learned_pos_init(gen: torch.Generator, max_len: int, d_model: int,
                     param_dtype) -> Params:
    return {"pos": utils.truncated_init(gen, (max_len, d_model), 0.02, param_dtype)}


def learned_pos(params: Params, x: torch.Tensor, offset=0) -> torch.Tensor:
    """x (B, S, D) plus learned position rows from ``offset``: an int or a
    0-dim tensor (the whole batch's prefix length) or a (B,) tensor of
    per-row offsets.  As in the JAX package, a scalar window is clamped
    into the table, a negative start counting from the table's end
    (``lax.dynamic_slice``), and a per-row position past it reads NaN
    (``jnp.take``'s fill).  A tensor offset is read on the device, never
    on the host."""
    table = params["pos"]
    n, S = table.shape[0], x.shape[1]
    if not isinstance(offset, torch.Tensor):
        start = int(offset)
        start = min(max(start + n if start < 0 else start, 0), max(n - S, 0))
        return x + table[start:start + S].to(x.dtype)
    steps = torch.arange(S, device=x.device)
    offset = offset.to(x.device).long()
    if offset.ndim == 0:
        start = torch.where(offset < 0, offset + n, offset)
        rows = start.clamp(0, max(n - S, 0)) + steps
        return x + table[rows].to(x.dtype)
    idx = offset[:, None] + steps[None, :]
    inside = (idx >= 0) & (idx < n)
    pos = table[idx.clamp(0, n - 1)].to(x.dtype)
    return x + torch.where(inside[..., None], pos, torch.nan)


def frontend_init(gen: torch.Generator, kind: str, d_model: int,
                  param_dtype) -> Params:
    """The stub frontends: a learned (D, D) projection plus bias over
    precomputed embeddings; ``{}`` for ``"none"``."""
    if kind == "none":
        return {}
    return {
        "proj": utils.truncated_init(gen, (d_model, d_model),
                                     1.0 / math.sqrt(d_model), param_dtype),
        "bias": torch.zeros((d_model,), dtype=param_dtype, device=gen.device),
    }


def frontend(params: Params, embeds: torch.Tensor,
             accum_dtype=torch.float32) -> torch.Tensor:
    """Precomputed frame/patch embeddings (B, S, D) -> (B, S, D) in
    ``accum_dtype``."""
    x = embeds.to(accum_dtype)
    if not params:
        return x
    y = utils.einsum_as("bsd,de->bse", x, params["proj"], out_dtype=accum_dtype)
    return y + params["bias"].to(accum_dtype)
