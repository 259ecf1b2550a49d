"""Token embeddings and the LM head (port of ``repro/nn/embeddings.py``)."""
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
