"""Causal LM wrapper (port of ``repro/models/lm.py``): init, the training
loss (``loss_fn``: cross-entropy plus the FFF hardening and balance aux
terms), KV caches, prefill, one decode step, the fixed-shape chunk slabs
of the serving engine (chunked prefill, speculative verify), per-row cache
surgery and the greedy/temperature generate loop.  Serving builds no
autograd graph: ``generate`` runs under ``torch.no_grad``, and the serving
drivers under ``inference_mode``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import utils
from repro_torch.configs.base import ModelConfig
from repro_torch.nn import embeddings, norms, transformer

Params = dict


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    tensor by tensor on ``device`` in the config's parameter dtype.  Same
    layout as ``repro.models.lm.init`` except the stack, which is one dict
    per layer (``nn/transformer.py``); ``weights.from_jax`` carries JAX
    weights over instead."""
    if cfg.pos_emb != "rope":
        raise NotImplementedError("the port serves RoPE models so far")
    dev = utils.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": embeddings.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       tie=cfg.tie_embeddings,
                                       param_dtype=cfg.param_dtype),
        "stack": transformer.stack_init(gen, cfg),
        "final_norm": norms.norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, dev),
    }


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_count(p) for p in items)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                device="cuda") -> list[dict]:
    return transformer.init_caches(cfg, batch, max_len, dtype,
                                   device=utils.resolve_device(device))


def _device(params: Params) -> torch.device:
    return params["embed"]["tok"].device


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = norms.norm_apply(cfg.norm, params["final_norm"], x)
    return embeddings.logits(params["embed"], x)


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
    """Training loss: cross-entropy plus the FFF hardening and balance aux
    terms (and the MoE one, zero until MoE sites are ported), summed over
    layers.  ``batch`` holds ``tokens`` and ``labels`` (B, S), tensors or
    numpy arrays; ``gen`` drives the FFF sites' stochastic training
    feature.  Returns (loss, metrics) with the JAX package's metric names:
    loss, ce, accuracy, hardening, moe_aux, balance."""
    dev = _device(params)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    x = embeddings.embed(params["embed"], tokens, cfg.accum_dtype)
    x, _, aux = transformer.stack_forward(params["stack"], cfg, x,
                                          mode="train", gen=gen)
    ce, acc = cross_entropy(_head(params, cfg, x), labels)
    loss = ce + aux["hardening"] + aux["moe_aux"] + aux["balance"]
    metrics = {"loss": loss, "ce": ce, "accuracy": acc,
               "hardening": aux["hardening"], "moe_aux": aux["moe_aux"],
               "balance": aux["balance"]}
    return loss, metrics


def prefill(params: Params, cfg: ModelConfig, batch: dict, caches: list[dict]
            ) -> tuple[torch.Tensor, list[dict]]:
    """Run the prefix, fill caches, return last-position logits (B, V)."""
    x = embeddings.embed(params["embed"], batch["tokens"].to(_device(params)),
                         cfg.accum_dtype)
    x, caches, _ = transformer.stack_forward(params["stack"], cfg, x,
                                             mode="prefill", caches=caches)
    return _head(params, cfg, x[:, -1:, :])[:, 0], caches


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: list[dict], pos_offset=0, *,
                write_mask: Optional[torch.Tensor] = None,
                token_valid: Optional[torch.Tensor] = None,
                with_stats: bool = False):
    """One serve step: token (B, 1) -> logits (B, V), updated caches.

    RoPE reads each row's position off its cache length, so ``pos_offset``
    (kept for the JAX signature) is unused by the RoPE models ported so
    far.  ``write_mask`` (B,) keeps rows from writing K/V; ``token_valid``
    (B,) marks phantom rows for the FFN dispatch.  With ``with_stats=True``
    also returns the per-site routing stats of an active
    ``api.collect_routing`` tap (None without one)."""
    x = embeddings.embed(params["embed"], token.to(_device(params)),
                         cfg.accum_dtype)
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
    them."""
    out = []
    for c in caches:
        kv = c["kv"]
        out.append(dict(c, kv=kv._replace(
            length=lengths.to(kv.length.device, kv.length.dtype))))
    return out


def cache_admit(caches: list[dict], admit: torch.Tensor) -> list[dict]:
    """Restart the rows marked in ``admit`` (B,) bool at length 0: the
    contiguous-layout counterpart of the JAX package's ``cache_admit``,
    whose page tables and shared-prefix lengths need paging (every row here
    owns one ``max_len`` page, and an admission shares no prefix).  The
    pools are not cleared; everything past length 0 is masked by length."""
    out = []
    for c in caches:
        kv = c["kv"]
        a = admit.to(kv.length.device)
        out.append(dict(c, kv=kv._replace(
            length=torch.where(a, torch.zeros_like(kv.length), kv.length))))
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
             temperature: float = 0.0, eos_id: Optional[int] = None
             ) -> torch.Tensor:
    """Greedy (or, with a generator and temperature > 0, sampled) decoding.

    With ``eos_id`` set, rows that emit it stop: their later tokens are
    pinned to ``eos_id`` and the loop exits once every row has finished, so
    the result may have fewer than ``steps`` generated columns."""
    dev = _device(params)
    prompt = prompt.to(dev)
    B = prompt.shape[0]
    caches = transformer.init_caches(cfg, B, max_len, device=dev)
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
