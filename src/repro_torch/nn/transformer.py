"""Transformer block + stack (port of ``repro/nn/transformer.py``).

The stack is a Python loop over layers.  Where the JAX package stacks each
period position's parameters on a leading ``n_periods`` axis for
``lax.scan``, the port keeps one parameter dict (and one cache dict) per
layer, in layer order: layer ``i`` is period ``i // len(period)``,
position ``i % len(period)``.  Modes: ``prefill`` (build caches over a
prefix), ``decode`` (one token against the caches) and ``chunk`` (a
``(B, C)`` slab continuing each row at its own cache length: chunked
prefill and speculative verify).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.core import api
from repro_torch.nn import attention, mlp, norms

Params = dict
Cache = dict

MODES = ("prefill", "decode", "chunk")


def make_attn_config(cfg: ModelConfig, spec: BlockSpec, *, causal: bool = True
                     ) -> attention.AttnConfig:
    return attention.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, bias=cfg.attn_bias,
        rope_theta=cfg.rope_theta, use_rope=(cfg.pos_emb == "rope"),
        causal=causal, sliding_window=spec.sliding_window,
        param_dtype=cfg.param_dtype, accum_dtype=cfg.accum_dtype)


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer != "attn" or spec.cross_attention:
        raise NotImplementedError(
            f"mixer {spec.mixer!r} (cross_attention={spec.cross_attention}) "
            f"is not ported yet")


def block_init(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec) -> Params:
    _check_spec(spec)
    dev = gen.device
    p: Params = {
        "norm1": norms.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
        "mixer": attention.init(gen, make_attn_config(cfg, spec)),
    }
    if spec.ffn.kind != "none":
        p["norm2"] = norms.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev)
        p["ffn"] = mlp.init(gen, spec.ffn, cfg.d_model,
                            param_dtype=cfg.param_dtype,
                            accum_dtype=cfg.accum_dtype)
    return p


def block_forward(params: Params, cfg: ModelConfig, spec: BlockSpec,
                  x: torch.Tensor, *, mode: str, cache: Cache,
                  chunk_valid: Optional[torch.Tensor] = None,
                  decode_mask: Optional[torch.Tensor] = None,
                  token_valid: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Cache, dict]:
    """One block: pre-norm attention + residual, pre-norm FFN + residual.
    ``chunk_valid`` (B,) is each row's real token count in chunk mode;
    ``decode_mask`` (B,) keeps rows from writing their KV cache in decode
    mode; ``token_valid`` marks phantom tokens for the FFN dispatch (in
    chunk mode derived from ``chunk_valid`` when not given)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check_spec(spec)
    h = norms.norm_apply(cfg.norm, params["norm1"], x)
    acfg = make_attn_config(cfg, spec)
    if mode == "prefill":
        y, kv = attention.forward_prefill(params["mixer"], acfg, h, cache["kv"])
    elif mode == "chunk":
        y, kv = attention.forward_chunk(params["mixer"], acfg, h, cache["kv"],
                                        chunk_valid)
        if token_valid is None:
            token_valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                           < chunk_valid.to(x.device)[:, None])
    else:
        y, kv = attention.forward_decode(params["mixer"], acfg, h, cache["kv"],
                                         decode_mask)
    x = x + y
    aux = {}
    if spec.ffn.kind != "none":
        h2 = norms.norm_apply(cfg.norm, params["norm2"], x)
        y2, aux = mlp.forward(params["ffn"], spec.ffn, cfg.d_model, h2,
                              param_dtype=cfg.param_dtype,
                              accum_dtype=cfg.accum_dtype, train=False,
                              valid=token_valid)
        x = x + y2
    return x, {"kv": kv}, aux


def stack_init(gen: torch.Generator, cfg: ModelConfig) -> list[Params]:
    """One parameter dict per layer, in layer order."""
    return [block_init(gen, cfg, cfg.period[i % len(cfg.period)])
            for i in range(cfg.n_layers)]


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                device="cpu") -> list[Cache]:
    """One contiguous KV cache per layer, mirroring ``stack_init``."""
    return [{"kv": attention.init_cache(
                batch, max_len, make_attn_config(cfg, cfg.period[i % len(cfg.period)]),
                dtype, device=device)}
            for i in range(cfg.n_layers)]


def stack_forward(params: list[Params], cfg: ModelConfig, x: torch.Tensor, *,
                  mode: str, caches: list[Cache],
                  chunk_valid: Optional[torch.Tensor] = None,
                  decode_mask: Optional[torch.Tensor] = None,
                  token_valid: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, list[Cache], dict]:
    """Run the whole stack.  aux["routing"], when a ``collect_routing`` tap
    is active, holds one ``RoutingStats`` per period position, summed over
    periods (overflow weighted by slots), as the JAX package reports."""
    n_pos = len(cfg.period)
    new_caches = []
    routing: list = [None] * n_pos
    for i, (p, c) in enumerate(zip(params, caches)):
        pos = i % n_pos
        x, nc, aux = block_forward(p, cfg, cfg.period[pos], x, mode=mode,
                                   cache=c, chunk_valid=chunk_valid,
                                   decode_mask=decode_mask,
                                   token_valid=token_valid)
        new_caches.append(nc)
        r = aux.get("routing")
        if r is not None:
            w = (r.leaf_counts, r.overflow * r.slots, r.slots)
            routing[pos] = w if routing[pos] is None else tuple(
                a + b for a, b in zip(routing[pos], w))
    out = {}
    if any(r is not None for r in routing):
        out["routing"] = tuple(
            None if r is None else api.RoutingStats(
                r[0], r[1] / torch.clamp(r[2], min=1.0), r[2])
            for r in routing)
    return x, new_caches, out
