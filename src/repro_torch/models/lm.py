"""Causal LM wrapper (port of ``repro/models/lm.py``): init, the training
loss (``loss_fn``: cross-entropy plus the FFF hardening and balance aux
terms), KV caches, prefill, one decode step, the fixed-shape chunk slabs
of the serving engine (chunked prefill, speculative verify), per-row cache
surgery and the greedy/temperature generate loop.  Serving builds no
autograd graph: ``generate`` runs under ``torch.no_grad``, and the serving
drivers under ``inference_mode``.

Every registry arch's inputs: token LMs take ``tokens``; an encoder-decoder
model (whisper-small) also takes ``enc_embeds`` (B, S_enc, D), precomputed
frame embeddings that ``encode`` runs through the frontend stub, the
sinusoidal table and the encoder stack; a frontend model without an
encoder (internvl2-26b) may take its prompt as ``embeds`` (B, S, D)
instead of tokens, and embeds each decoded token."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import utils
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.nn import embeddings, norms, rope as rope_lib, transformer

Params = dict


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    tensor by tensor on ``device`` in the config's parameter dtype.  Same
    layout as ``repro.models.lm.init`` except the stacks, which are one
    dict per layer (``nn/transformer.py``); ``weights.from_jax`` carries
    JAX weights over instead.  Learned positions add ``pos`` (a
    ``max_seq_len``-row table); a frontend model without an encoder adds
    ``frontend``; an encoder-decoder model adds ``enc_frontend``,
    ``enc_stack`` (non-causal, over the encoder's period) and
    ``enc_norm``."""
    dev = utils.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pd = cfg.param_dtype
    p = {
        "embed": embeddings.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       tie=cfg.tie_embeddings, param_dtype=pd),
        "stack": transformer.stack_init(gen, cfg),
        "final_norm": norms.norm_init(cfg.norm, cfg.d_model, pd, dev),
    }
    if cfg.pos_emb == "learned":
        p["pos"] = embeddings.learned_pos_init(gen, cfg.max_seq_len, cfg.d_model, pd)
    if cfg.frontend != "none" and cfg.encoder is None:
        p["frontend"] = embeddings.frontend_init(gen, cfg.frontend, cfg.d_model, pd)
    if cfg.encoder is not None:
        p["enc_frontend"] = embeddings.frontend_init(gen, cfg.frontend,
                                                     cfg.d_model, pd)
        p["enc_stack"] = transformer.stack_init(
            gen, cfg, causal=False, period=cfg.encoder.period,
            n_layers=cfg.encoder.n_layers)
        p["enc_norm"] = norms.norm_init(cfg.norm, cfg.d_model, pd, dev)
    return p


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_count(p) for p in items)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                page_size: int = 0, num_pages: int = 0, prealloc: bool = True,
                device="cuda") -> list[dict]:
    """Per-layer caches: an attention layer's KV cache, contiguous
    (``page_size`` 0) or a paged pool of ``num_pages`` pages of
    ``page_size`` tokens with identity tables (``prealloc``) or unmapped
    ones for the engine to install; a recurrent layer's state (zeros); a
    cross-attention layer's encoder K/V, ``cfg.encoder.seq_len`` long."""
    enc_len = cfg.encoder.seq_len if cfg.encoder is not None else 0
    return transformer.init_caches(cfg, batch, max_len, dtype, enc_len=enc_len,
                                   page_size=page_size, num_pages=num_pages,
                                   prealloc=prealloc,
                                   device=utils.resolve_device(device))


def _device(params: Params) -> torch.device:
    return params["embed"]["tok"].device


def encode(params: Params, cfg: ModelConfig, enc_embeds) -> torch.Tensor:
    """The encoder over precomputed frame/patch embeddings (B, S_enc, D), a
    tensor or numpy array: the frontend stub, the sinusoidal table, the
    non-causal encoder stack and its norm.  The stack runs in train mode,
    as in the JAX package, so its FFF sites compute FORWARD_T's soft
    mixture over every leaf (no kernel) even when serving; their aux
    terms are dropped."""
    x = embeddings.frontend(
        sharding.gathered(params["enc_frontend"], "enc_frontend"),
        torch.as_tensor(enc_embeds, device=_device(params)), cfg.accum_dtype)
    x = x + rope_lib.sinusoidal_embedding(x.shape[1], cfg.d_model,
                                          device=x.device).to(x.dtype)
    x, _, _ = transformer.stack_forward(params["enc_stack"], cfg, x, mode="train",
                                        causal=False, period=cfg.encoder.period,
                                        name="enc_stack")
    return norms.norm_apply(cfg.norm, params["enc_norm"], x)


def _encode_batch(params: Params, cfg: ModelConfig, batch: dict):
    return encode(params, cfg, batch["enc_embeds"]) if cfg.encoder is not None else None


def _embed_inputs(params: Params, cfg: ModelConfig, batch: dict,
                  pos_offset=0) -> torch.Tensor:
    """The stack's input (B, S, D) in ``cfg.accum_dtype``: a frontend model
    without an encoder takes ``batch["embeds"]`` through its frontend when
    the batch has them, any other batch embeds ``batch["tokens"]``
    (tensors or numpy arrays).  Learned positions are taken from
    ``pos_offset`` (an int or per-row (B,)); sinusoidal ones from row 0
    whatever the offset, as the JAX package adds them."""
    dev = _device(params)
    if cfg.frontend != "none" and cfg.encoder is None and "embeds" in batch:
        x = embeddings.frontend(
            sharding.gathered(params["frontend"], "frontend"),
            torch.as_tensor(batch["embeds"], device=dev), cfg.accum_dtype)
    else:
        x = embeddings.embed(
            sharding.gathered({"tok": params["embed"]["tok"]}, "embed"),
            torch.as_tensor(batch["tokens"], device=dev), cfg.accum_dtype)
    if cfg.pos_emb == "learned":
        x = embeddings.learned_pos(params["pos"], x, pos_offset)
    elif cfg.pos_emb == "sinusoidal":
        x = x + rope_lib.sinusoidal_embedding(x.shape[1], cfg.d_model,
                                              device=dev).to(x.dtype)
    return x


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = norms.norm_apply(cfg.norm, params["final_norm"], x)
    key = "head" if "head" in params["embed"] else "tok"
    return embeddings.logits(sharding.gathered({key: params["embed"][key]},
                                               "embed"), x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over positions whose label is not
    ``ignore_index``, the log-softmax in float32; returns (loss, accuracy)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = valid.sum().clamp(min=1)
    loss = -(ll * valid).sum() / denom
    acc = ((logits.argmax(-1) == labels) & valid).sum() / denom
    return loss, acc


def loss_fn(params: Params, cfg: ModelConfig, batch: dict,
            gen: Optional[torch.Generator] = None
            ) -> tuple[torch.Tensor, dict]:
    """Training loss: cross-entropy plus the FFF hardening and balance and
    the MoE balancing aux terms, summed over the decoder's layers (an
    encoder's aux terms are dropped, as in the JAX package).  ``batch``
    holds ``labels`` (B, S) and the inputs (``tokens``, or ``embeds``;
    ``enc_embeds`` for an encoder), tensors or numpy arrays; ``gen`` drives
    the FFN sites' stochastic training feature.  Returns (loss, metrics)
    with the JAX package's metric names: loss, ce, accuracy, hardening,
    moe_aux, balance."""
    labels = torch.as_tensor(batch["labels"], device=_device(params))
    enc_out = _encode_batch(params, cfg, batch)
    x = _embed_inputs(params, cfg, batch)
    x, _, aux = transformer.stack_forward(params["stack"], cfg, x, mode="train",
                                          gen=gen, enc_out=enc_out)
    ce, acc = cross_entropy(_head(params, cfg, x), labels)
    loss = ce + aux["hardening"] + aux["moe_aux"] + aux["balance"]
    metrics = {"loss": loss, "ce": ce, "accuracy": acc,
               "hardening": aux["hardening"], "moe_aux": aux["moe_aux"],
               "balance": aux["balance"]}
    return loss, metrics


def prefill(params: Params, cfg: ModelConfig, batch: dict, caches: list[dict]
            ) -> tuple[torch.Tensor, list[dict]]:
    """Run the prefix (``tokens``, or ``embeds``; with ``enc_embeds`` for an
    encoder), fill caches, return last-position logits (B, V)."""
    enc_out = _encode_batch(params, cfg, batch)
    x = _embed_inputs(params, cfg, batch)
    x, caches, _ = transformer.stack_forward(params["stack"], cfg, x,
                                             mode="prefill", caches=caches,
                                             enc_out=enc_out)
    return _head(params, cfg, x[:, -1:, :])[:, 0], caches


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: list[dict], pos_offset=0, *,
                write_mask: Optional[torch.Tensor] = None,
                token_valid: Optional[torch.Tensor] = None,
                with_stats: bool = False):
    """One serve step: token (B, 1) -> logits (B, V), updated caches.

    ``pos_offset`` (an int, or per row (B,)) is the token's position, which
    learned positional embeddings read; RoPE reads each row's position off
    its cache length instead.  ``write_mask`` (B,) keeps rows from writing K/V; ``token_valid``
    (B,) marks phantom rows for the FFN dispatch.  With ``with_stats=True``
    also returns the per-site routing stats of an active
    ``api.collect_routing`` tap (None without one)."""
    x = _embed_inputs(params, cfg, {"tokens": token}, pos_offset=pos_offset)
    tv = token_valid[:, None] if token_valid is not None else None
    x, caches, aux = transformer.stack_forward(params["stack"], cfg, x,
                                               mode="decode", caches=caches,
                                               decode_mask=write_mask,
                                               token_valid=tv)
    logits = _head(params, cfg, x)[:, 0]
    if with_stats:
        return logits, caches, aux.get("routing")
    return logits, caches


# ---------------------------------------------------------------------------
# slot-pooled serving (the continuous-batching engine, serving/engine.py)
# ---------------------------------------------------------------------------

def set_cache_lengths(caches: list[dict], lengths: torch.Tensor) -> list[dict]:
    """Overwrite every layer's per-row filled length with ``lengths`` (B,):
    the speculative round's rollback.  Positions at or past a row's new
    length stay in the pools, masked by length, until appends overwrite
    them.  A recurrent layer's state has no length and is left as it is,
    as in the JAX package."""
    out = []
    for c in caches:
        if "kv" in c:
            kv = c["kv"]
            c = dict(c, kv=kv._replace(
                length=lengths.to(kv.length.device, kv.length.dtype)))
        out.append(c)
    return out


def cache_admit(caches: list[dict], admit: torch.Tensor,
                tables: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                cow_src: Optional[torch.Tensor] = None,
                cow_dst: Optional[torch.Tensor] = None) -> list[dict]:
    """Install the rows marked in ``admit`` (B,) bool, in one batched call
    on the device with no host synchronization.

    Paged caches: the admitted rows' page tables become ``tables`` (B, ppr)
    and their lengths ``lengths`` (B,), the shared-prefix boundary, so
    prefill resumes at the first novel token.  ``cow_src``/``cow_dst`` (B,)
    are page ids for copy-on-write (a prompt fully covered by shared pages
    recomputes its last token privately): the source page's K/V are copied
    into the row's own ``cow_dst`` page before the table swap.  Rows
    without a copy pass the ``num_pages`` sentinel as ``cow_dst``, whose
    copy lands in the sink page.

    Contiguous caches (every row owns one ``max_len`` page, and no prefix
    is shared) take ``admit`` alone and restart those rows at length 0.
    The pools are not cleared; everything past a row's length is masked.
    Recurrent state cannot be restarted per row by length, so caches with
    a recurrent layer are refused."""
    if any("kv" not in c for c in caches):
        raise ValueError("cache_admit requires attention KV caches (recurrent "
                         "state is not length-masked)")
    out = []
    for c in caches:
        kv = c["kv"]
        dev = kv.length.device
        a = admit.to(dev)
        if not kv.paged:
            if tables is not None or cow_src is not None or cow_dst is not None:
                raise ValueError("a contiguous cache has no page tables to "
                                 "install")
            new_len = (torch.zeros_like(kv.length) if lengths is None
                       else lengths.to(dev, kv.length.dtype))
            out.append(dict(c, kv=kv._replace(
                length=torch.where(a, new_len, kv.length))))
            continue
        src = cow_src.to(dev).long().clamp(max=kv.k.shape[0] - 2)
        dst = cow_dst.to(dev).long()
        for pool in (kv.k, kv.v):
            pool[dst] = pool[src]
        out.append(dict(c, kv=kv._replace(
            table=torch.where(a[:, None], tables.to(dev, kv.table.dtype),
                              kv.table),
            length=torch.where(a, lengths.to(dev, kv.length.dtype),
                               kv.length))))
    return out


def cache_install(caches: list[dict], admit: torch.Tensor, tables: torch.Tensor,
                  lengths: torch.Tensor, pages: torch.Tensor,
                  k_rows: list[torch.Tensor], v_rows: list[torch.Tensor]
                  ) -> list[dict]:
    """Install handed-off rows, page contents and table, in one batched call
    on the device with no host synchronization (the cluster's receive path,
    ``cluster/handoff.install``).

    ``admit`` / ``tables`` / ``lengths`` as in ``cache_admit``.  The K/V
    arrive over the wire instead of being computed: ``k_rows[i]`` /
    ``v_rows[i]`` (P, page_size, K, hd), one per layer, are copied into
    the pages ``pages`` (P,) of this pool; the ``num_pages`` sentinel sends
    its row to the sink page, where JAX drops the write.  Paged attention
    caches only."""
    if any("kv" not in c or not c["kv"].paged for c in caches):
        raise ValueError("cache_install requires paged attention KV caches")
    if not len(k_rows) == len(v_rows) == len(caches):
        raise ValueError(f"{len(k_rows)} K and {len(v_rows)} V row sets for "
                         f"{len(caches)} layers")
    out = []
    for c, kr, vr in zip(caches, k_rows, v_rows):
        kv = c["kv"]
        dev = kv.length.device
        a = admit.to(dev)
        dst = pages.to(dev).long()
        for pool, rows in ((kv.k, kr), (kv.v, vr)):
            pool.index_copy_(0, dst, rows.to(dev, pool.dtype, non_blocking=True))
        out.append(dict(c, kv=kv._replace(
            table=torch.where(a[:, None], tables.to(dev, kv.table.dtype),
                              kv.table),
            length=torch.where(a, lengths.to(dev, kv.length.dtype),
                               kv.length))))
    return out


def _chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           valid_len: torch.Tensor, caches: list[dict]):
    dev = _device(params)
    valid_len = valid_len.to(dev)
    x = embeddings.embed(params["embed"], tokens.to(dev), cfg.accum_dtype)
    x, caches, aux = transformer.stack_forward(params["stack"], cfg, x,
                                               mode="chunk", caches=caches,
                                               chunk_valid=valid_len)
    return x, valid_len, caches, aux.get("routing")


def prefill_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  valid_len: torch.Tensor, caches: list[dict]):
    """One chunk of prefill for every row of a slot-pooled cache: tokens
    (B, C), a fixed shape for every call; row b's first ``valid_len[b]``
    tokens are real (0 = no prefill work this chunk) and continue its
    sequence at its cache length, which is also where RoPE reads each
    row's start position.  Returns (logits (B, V) at
    each row's last valid position, caches, routing stats of an active
    ``api.collect_routing`` tap or None)."""
    x, valid_len, caches, stats = _chunk(params, cfg, tokens, valid_len, caches)
    last = (valid_len.long() - 1).clamp(min=0)[:, None, None]
    x = torch.gather(x, 1, last.expand(-1, 1, x.shape[-1]))
    return _head(params, cfg, x)[:, 0], caches, stats


def verify_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 valid_len: torch.Tensor, caches: list[dict]):
    """The speculative verify slab: ``prefill_chunk``'s dispatch with the
    target's logits at every position, (B, C, V): ``logits[b, j]`` follows
    ``tokens[b, :j + 1]``.  K/V of all valid positions are appended
    optimistically; the caller rolls rejected ones back with
    ``set_cache_lengths``.  Returns (logits, caches, routing stats)."""
    x, _, caches, stats = _chunk(params, cfg, tokens, valid_len, caches)
    return _head(params, cfg, x), caches, stats


@torch.no_grad()
def generate(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
             steps: int, max_len: int, generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, eos_id: Optional[int] = None,
             caches: Optional[list] = None) -> torch.Tensor:
    """Greedy (or, with a generator and temperature > 0, sampled) decoding.

    With ``eos_id`` set, rows that emit it stop: their later tokens are
    pinned to ``eos_id`` and the loop exits once every row has finished, so
    the result may have fewer than ``steps`` generated columns.  ``caches``
    replaces the contiguous caches built here with the caller's, e.g. a
    preallocated paged set (``init_caches(..., page_size=N)``): fresh, and
    sized ``(B, max_len)``."""
    dev = _device(params)
    prompt = prompt.to(dev)
    B = prompt.shape[0]
    if caches is None:
        caches = init_caches(cfg, B, max_len, device=dev)
    logits, caches = prefill(params, cfg, {"tokens": prompt}, caches)
    out = [prompt.to(torch.int32)]
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(steps):
        out.append(tok)
        if eos_id is not None:
            done = done | (tok[:, 0] == eos_id)
            if bool(done.all()):
                break
        logits, caches = decode_step(params, cfg, tok, caches,
                                     pos_offset=prompt.shape[1] + i)
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator).to(torch.int32)
        else:
            tok = logits.argmax(-1)[:, None].to(torch.int32)
        if eos_id is not None:
            tok = torch.where(done[:, None], torch.full_like(tok, eos_id), tok)
    return torch.cat(out, dim=1)
