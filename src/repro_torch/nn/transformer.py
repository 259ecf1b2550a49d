"""Transformer block + stack (port of ``repro/nn/transformer.py``).

The stack is a Python loop over layers.  Where the JAX package stacks each
period position's parameters on a leading ``n_periods`` axis for
``lax.scan``, the port keeps one parameter dict (and one cache dict) per
layer, in layer order: layer ``i`` is period ``i // len(period)``,
position ``i % len(period)``.  Modes: ``train`` (full attention, no
cache, the FFN sites in training mode), ``eval`` (the same with hard FFN
routing), ``prefill`` (build caches over a prefix), ``decode`` (one token
against the caches) and ``chunk`` (a ``(B, C)`` slab continuing each row
at its own cache length: chunked prefill and speculative verify).

In ``train`` mode ``cfg.remat`` chooses what the backward pass recomputes,
as ``jax.checkpoint`` around the JAX package's scan body does: ``"full"``
checkpoints each layer (``torch.utils.checkpoint``, non-reentrant), so
only layer inputs are kept; ``"dots"`` checkpoints each layer but keeps
its matmul outputs; ``"none"`` keeps everything.  Values and gradients do
not depend on it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.core import api
from repro_torch.nn import attention, mlp, norms

Params = dict
Cache = dict

MODES = ("train", "eval", "prefill", "decode", "chunk")
REMATS = ("none", "dots", "full")
#: the matmul ops whose outputs ``remat="dots"`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


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
                  x: torch.Tensor, *, mode: str, cache: Optional[Cache] = None,
                  gen: Optional[torch.Generator] = None,
                  chunk_valid: Optional[torch.Tensor] = None,
                  decode_mask: Optional[torch.Tensor] = None,
                  token_valid: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Optional[Cache], dict]:
    """One block: pre-norm attention + residual, pre-norm FFN + residual.
    ``train`` and ``eval`` take no cache and return None for it; ``gen``
    drives the FFN's stochastic training feature.  ``chunk_valid`` (B,) is
    each row's real token count in chunk mode; ``decode_mask`` (B,) keeps
    rows from writing their KV cache in decode mode; ``token_valid`` marks
    phantom tokens for the FFN dispatch (in chunk mode derived from
    ``chunk_valid`` when not given)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check_spec(spec)
    h = norms.norm_apply(cfg.norm, params["norm1"], x)
    acfg = make_attn_config(cfg, spec)
    kv = None
    if mode in ("train", "eval"):      # eval: full attention, hard FFN routing
        y = attention.forward(params["mixer"], acfg, h)
    elif mode == "prefill":
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
                              accum_dtype=cfg.accum_dtype,
                              train=(mode == "train"), gen=gen,
                              valid=token_valid)
        x = x + y2
    return x, (None if kv is None else {"kv": kv}), aux


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


def _layer_seeds(gen: Optional[torch.Generator], n: int) -> Optional[list]:
    """One seed per layer drawn from ``gen`` (the JAX package splits its key
    per layer): each layer makes its own generator from its seed, so a
    checkpointed layer's recompute replays the same draws."""
    if gen is None:
        return None
    return torch.randint(0, 2 ** 62, (n,), generator=gen,
                         device=gen.device).tolist()


def _remat(fn, remat: str):
    """``fn`` wrapped for ``cfg.remat`` (see the module docstring)."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        def policy(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)
    return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def stack_forward(params: list[Params], cfg: ModelConfig, x: torch.Tensor, *,
                  mode: str, caches: Optional[list[Cache]] = None,
                  gen: Optional[torch.Generator] = None,
                  chunk_valid: Optional[torch.Tensor] = None,
                  decode_mask: Optional[torch.Tensor] = None,
                  token_valid: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Optional[list[Cache]], dict]:
    """Run the whole stack.  ``train`` and ``eval`` take no caches and
    return None for them.  In ``train`` mode aux holds the per-layer sums
    of 'hardening', 'moe_aux' and 'balance' (float32) and ``cfg.remat``
    applies.  aux["routing"], when a ``collect_routing`` tap is active at
    inference, holds one ``RoutingStats`` per period position, summed over
    periods (overflow weighted by slots), as the JAX package reports."""
    n_pos = len(cfg.period)
    no_cache = mode in ("train", "eval")
    if not no_cache and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    seeds = _layer_seeds(gen, len(params))

    def block(i, p, c, x):
        lg = (None if seeds is None else
              torch.Generator(device=x.device).manual_seed(seeds[i]))
        return block_forward(p, cfg, cfg.period[i % n_pos], x, mode=mode,
                             cache=c, gen=lg, chunk_valid=chunk_valid,
                             decode_mask=decode_mask, token_valid=token_valid)

    run = block
    if mode == "train" and cfg.remat != "none":
        # a checkpointed block's recompute runs in autograd's thread on the
        # card: it gets this thread's overrides, routing tap and groups
        ctx = api.thread_context()

        def in_context(*args):
            with api.context_installed(ctx):
                return block(*args)

        run = _remat(in_context, cfg.remat)
    train_aux = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
                  for k in ("hardening", "moe_aux", "balance")}
                 if mode == "train" else {})
    new_caches = []
    routing: list = [None] * n_pos
    for i, p in enumerate(params):
        pos = i % n_pos
        x, nc, aux = run(i, p, None if no_cache else caches[i], x)
        new_caches.append(nc)
        for k in train_aux.keys() & aux.keys():
            train_aux[k] = train_aux[k] + aux[k]
        r = aux.get("routing")
        if r is not None:
            w = (r.leaf_counts, r.overflow * r.slots, r.slots)
            routing[pos] = w if routing[pos] is None else tuple(
                a + b for a, b in zip(routing[pos], w))
    out = dict(train_aux)
    if any(r is not None for r in routing):
        out["routing"] = tuple(
            None if r is None else api.RoutingStats(
                r[0], r[1] / torch.clamp(r[2], min=1.0), r[2])
            for r in routing)
    return x, (None if no_cache else new_caches), out
