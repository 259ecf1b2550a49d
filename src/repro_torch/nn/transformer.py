"""Transformer block + stack (port of ``repro/nn/transformer.py``).

A block is a pre-norm sequence mixer (attention, or the recurrent Mamba,
mLSTM and sLSTM mixers of ``nn/mamba.py`` and ``nn/xlstm.py``), in the
decoder blocks of an encoder-decoder model a pre-norm cross-attention over
the encoder output, and an optional pre-norm FFN site.  A layer's cache
holds its mixer's state under the JAX package's keys: ``"kv"``
(attention), ``"mamba"``, ``"mlstm"`` or ``"slstm"``, and a
cross-attention block's encoder K/V as ``"cross_k"``/``"cross_v"``.

The stack is a Python loop over layers.  Where the JAX package stacks each
period position's parameters on a leading ``n_periods`` axis for
``lax.scan``, the port keeps one parameter dict (and one cache dict) per
layer, in layer order: layer ``i`` is period ``i // len(period)``,
position ``i % len(period)``; an encoder stack is the same over
``cfg.encoder``'s period (``period=``, ``n_layers=``, ``causal=False``).
Modes: ``train`` (full attention, no
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
from repro_torch.distributed import sharding
from repro_torch.nn import attention, mamba, mlp, norms, xlstm

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
        causal=causal, sliding_window=spec.sliding_window, chunk=cfg.attn_chunk,
        param_dtype=cfg.param_dtype, accum_dtype=cfg.accum_dtype)


def make_mamba_config(cfg: ModelConfig) -> mamba.MambaConfig:
    return mamba.MambaConfig(
        d_model=cfg.d_model, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
        expand=cfg.mamba_expand, param_dtype=cfg.param_dtype,
        accum_dtype=cfg.accum_dtype)


def make_xlstm_config(cfg: ModelConfig) -> xlstm.XLSTMConfig:
    return xlstm.XLSTMConfig(
        d_model=cfg.d_model, n_heads=cfg.lstm_heads,
        param_dtype=cfg.param_dtype, accum_dtype=cfg.accum_dtype)


MIXERS = ("attn", "mamba", "mlstm", "slstm")


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer not in MIXERS:
        raise ValueError(f"unknown mixer {spec.mixer!r}; have {MIXERS}")


def block_init(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec, *,
               causal: bool = True) -> Params:
    _check_spec(spec)
    dev = gen.device
    p: Params = {"norm1": norms.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev)}
    if spec.mixer == "attn":
        p["mixer"] = attention.init(gen, make_attn_config(cfg, spec, causal=causal))
    elif spec.mixer == "mamba":
        p["mixer"] = mamba.init(gen, make_mamba_config(cfg))
    elif spec.mixer == "mlstm":
        p["mixer"] = xlstm.mlstm_init(gen, make_xlstm_config(cfg))
    else:
        p["mixer"] = xlstm.slstm_init(gen, make_xlstm_config(cfg))
    if spec.cross_attention:
        p["norm_x"] = norms.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev)
        p["cross"] = attention.init(gen, make_attn_config(cfg, spec, causal=False))
    if spec.ffn.kind != "none":
        p["norm2"] = norms.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev)
        p["ffn"] = mlp.init(gen, spec.ffn, cfg.d_model,
                            param_dtype=cfg.param_dtype,
                            accum_dtype=cfg.accum_dtype)
    return p


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_len: int, dtype=None, *, enc_len: int = 0,
                     page_size: int = 0, num_pages: int = 0,
                     prealloc: bool = True, device="cpu") -> Cache:
    """One layer's cache: the attention KV cache (contiguous, or paged with
    ``page_size > 0``) or the recurrent mixer's state, zeros in
    ``cfg.accum_dtype`` as in the JAX package; a cross-attention block
    adds ``cross_k``/``cross_v``, zeros (B, enc_len, K, hd) in ``dtype``
    (default the parameter dtype) that prefill replaces."""
    _check_spec(spec)
    if spec.mixer == "attn":
        c = {"kv": attention.init_cache(
            batch, max_len, make_attn_config(cfg, spec), dtype,
            page_size=page_size, num_pages=num_pages, prealloc=prealloc,
            device=device)}
    elif spec.mixer == "mamba":
        c = {"mamba": mamba.init_state(batch, make_mamba_config(cfg),
                                       cfg.accum_dtype, device=device)}
    elif spec.mixer == "mlstm":
        c = {"mlstm": xlstm.mlstm_init_state(batch, make_xlstm_config(cfg),
                                             cfg.accum_dtype, device=device)}
    else:
        c = {"slstm": xlstm.slstm_init_state(batch, cfg.d_model, cfg.accum_dtype,
                                             device=device)}
    if spec.cross_attention:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        for k in ("cross_k", "cross_v"):
            c[k] = torch.zeros(shape, dtype=dtype or cfg.param_dtype, device=device)
    return c


def _recurrent(params: Params, cfg: ModelConfig, spec: BlockSpec,
               h: torch.Tensor, state):
    """The recurrent mixer of ``spec`` on h (B, S, D) from ``state`` (None:
    zeros); returns (y, the final state)."""
    if spec.mixer == "mamba":
        return mamba.forward(params, make_mamba_config(cfg), h, state)
    if spec.mixer == "mlstm":
        return xlstm.mlstm_block(params, make_xlstm_config(cfg), h, state)
    return xlstm.slstm_block(params, make_xlstm_config(cfg), h, state)


def block_forward(params: Params, cfg: ModelConfig, spec: BlockSpec,
                  x: torch.Tensor, *, mode: str, cache: Optional[Cache] = None,
                  gen: Optional[torch.Generator] = None,
                  enc_out: Optional[torch.Tensor] = None,
                  causal: bool = True,
                  chunk_valid: Optional[torch.Tensor] = None,
                  decode_mask: Optional[torch.Tensor] = None,
                  token_valid: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Optional[Cache], dict]:
    """One block: pre-norm mixer + residual, [pre-norm cross-attention +
    residual], pre-norm FFN + residual.  ``train`` and ``eval`` take no
    cache and return None for it; ``gen`` drives the FFN's stochastic
    training feature.  ``causal=False`` is the encoder's self-attention.
    A cross-attention block attends to ``enc_out`` (B, S_enc, D): train,
    eval and prefill compute its K/V (prefill stores them in the cache),
    decode reads them back.  ``chunk_valid`` (B,) is each row's real token
    count in chunk mode; ``decode_mask`` (B,) keeps rows from writing their
    KV cache in decode mode; ``token_valid`` marks phantom tokens for the
    FFN dispatch (in chunk mode derived from ``chunk_valid`` when not
    given).  Those three are attention features: chunk mode refuses a
    recurrent mixer (it has no length-masked state) and a cross-attention
    block, as the JAX package does (the serving engine refuses such
    models)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check_spec(spec)
    if mode == "chunk" and (spec.mixer != "attn" or spec.cross_attention):
        raise ValueError("chunked prefill requires plain attention mixers "
                         "(recurrent state folds pad garbage in; cross-attn "
                         "slabs are unsupported)")
    h = norms.norm_apply(cfg.norm, params["norm1"], x)
    new_cache = None if mode in ("train", "eval") else {}
    if spec.mixer != "attn":
        y, state = _recurrent(params["mixer"], cfg, spec, h,
                              None if cache is None else cache[spec.mixer])
        if new_cache is not None:
            new_cache[spec.mixer] = state
    else:
        acfg = make_attn_config(cfg, spec, causal=causal)
        if mode in ("train", "eval"):      # eval: full attention, hard FFN routing
            y = attention.forward(params["mixer"], acfg, h)
        elif mode == "prefill":
            y, new_cache["kv"] = attention.forward_prefill(params["mixer"], acfg, h,
                                                           cache["kv"])
        elif mode == "chunk":
            y, new_cache["kv"] = attention.forward_chunk(params["mixer"], acfg, h,
                                                         cache["kv"], chunk_valid)
            if token_valid is None:
                token_valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                               < chunk_valid.to(x.device)[:, None])
        else:
            y, new_cache["kv"] = attention.forward_decode(params["mixer"], acfg, h,
                                                          cache["kv"], decode_mask)
    x = x + y
    if spec.cross_attention:
        acfg = make_attn_config(cfg, spec, causal=False)
        hx = norms.norm_apply(cfg.norm, params["norm_x"], x)
        if mode == "decode":
            ek, ev = cache["cross_k"], cache["cross_v"]
        else:
            ek, ev = attention.cross_kv(params["cross"], acfg, enc_out)
        if new_cache is not None:
            new_cache["cross_k"], new_cache["cross_v"] = ek, ev
        x = x + attention.forward_cross(params["cross"], acfg, hx, ek, ev)
    return _ffn(params, cfg, spec, x, mode, gen, token_valid, new_cache)


def _ffn(params: Params, cfg: ModelConfig, spec: BlockSpec, x: torch.Tensor,
         mode: str, gen, token_valid, new_cache):
    """The block's pre-norm FFN site + residual; returns block_forward's
    (x, cache, aux)."""
    aux = {}
    if spec.ffn.kind != "none":
        h2 = norms.norm_apply(cfg.norm, params["norm2"], x)
        y2, aux = mlp.forward(params["ffn"], spec.ffn, cfg.d_model, h2,
                              param_dtype=cfg.param_dtype,
                              accum_dtype=cfg.accum_dtype,
                              train=(mode == "train"), gen=gen,
                              valid=token_valid)
        x = x + y2
    return x, new_cache, aux


def stack_init(gen: torch.Generator, cfg: ModelConfig, *, causal: bool = True,
               period: Optional[tuple[BlockSpec, ...]] = None,
               n_layers: Optional[int] = None) -> list[Params]:
    """One parameter dict per layer, in layer order: ``n_layers`` (default
    ``cfg.n_layers``) over ``period`` (default ``cfg.period``)."""
    period = period or cfg.period
    return [block_init(gen, cfg, period[i % len(period)], causal=causal)
            for i in range(n_layers or cfg.n_layers)]


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                enc_len: int = 0, page_size: int = 0, num_pages: int = 0,
                prealloc: bool = True, device="cpu") -> list[Cache]:
    """One cache per layer, mirroring ``stack_init`` (``init_block_cache``;
    ``enc_len`` sizes the cross-attention K/V)."""
    return [init_block_cache(cfg, cfg.period[i % len(cfg.period)], batch, max_len,
                             dtype, enc_len=enc_len, page_size=page_size,
                             num_pages=num_pages, prealloc=prealloc, device=device)
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
                  enc_out: Optional[torch.Tensor] = None,
                  causal: bool = True,
                  period: Optional[tuple[BlockSpec, ...]] = None,
                  chunk_valid: Optional[torch.Tensor] = None,
                  decode_mask: Optional[torch.Tensor] = None,
                  token_valid: Optional[torch.Tensor] = None,
                  name: str = "stack"
                  ) -> tuple[torch.Tensor, Optional[list[Cache]], dict]:
    """Run the whole stack.  ``train`` and ``eval`` take no caches and
    return None for them.  In ``train`` mode aux holds the per-layer sums
    of 'hardening', 'moe_aux' and 'balance' (float32) and ``cfg.remat``
    applies.  aux["routing"], when a ``collect_routing`` tap is active at
    inference, holds one ``RoutingStats`` per period position, summed over
    periods (overflow weighted by slots), as the JAX package reports.
    ``period`` (default ``cfg.period``) and ``causal`` select the stack
    (the encoder: its own period, non-causal); ``enc_out`` reaches every
    cross-attention block.  Under installed placements
    (``distributed/sharding.use_placements``) each layer's sharded tensors,
    placed under ``name/i``, are gathered whole just before layer ``i``
    runs."""
    period = period or cfg.period
    n_pos = len(period)
    no_cache = mode in ("train", "eval")
    if not no_cache and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    seeds = _layer_seeds(gen, len(params))

    def block(i, p, c, x):
        lg = (None if seeds is None else
              torch.Generator(device=x.device).manual_seed(seeds[i]))
        p = sharding.gathered(p, f"{name}/{i}")
        return block_forward(p, cfg, period[i % n_pos], x, mode=mode,
                             cache=c, gen=lg, enc_out=enc_out, causal=causal,
                             chunk_valid=chunk_valid,
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
