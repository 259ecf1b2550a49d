"""Speculative decoding for the continuous-batching engine (port of
``repro/serving/spec.py``).

A cheap DRAFT model proposes ``k`` tokens per slot autoregressively, the
TARGET scores all ``k + 1`` positions in one ``(num_slots, k + 1)`` verify
slab, and host-side rejection sampling keeps the longest prefix the target
agrees with: the output distribution is exactly the target's, for any
draft (Leviathan et al., 2023).

* ``draft_rollout`` — both cache trees' length rollback from the previous
  round, then ``k + 1`` draft decode steps at ``(num_slots, 1)`` (the extra
  step appends the last draft's K/V, so an all-accepted round leaves the
  draft cache aligned), sampling on the device.
* ``spec_round`` — the rollout, then ``lm.verify_chunk`` over the slab.  On
  the card the draft steps resolve to ``cuda_decode`` and the verify slab
  (``num_slots * (k + 1)`` tokens, 32 at 8 slots and k = 3) to ``cuda``'s
  gathered-kernel branch.
* ``rejection_sample`` — host numpy, per row, exact.

The JAX package runs a round as one compiled dispatch; PyTorch runs it
eagerly and reads nothing on the host: the engine copies the round's
logits, drafts and routing stats off the device in one transfer, for
rejection sampling.  Only the ``self`` / ``self:N`` early-exit
draft is ported: an independent draft architecture needs the other archs.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.models import lm

Params = dict


# ---------------------------------------------------------------------------
# draft-model construction
# ---------------------------------------------------------------------------

def _check_periods(cfg, n_periods: int) -> None:
    total = cfg.n_layers // len(cfg.period)
    if not 1 <= n_periods <= total:
        raise ValueError(f"self-draft n_periods {n_periods} out of range "
                         f"[1, {total}]")


def self_draft_config(cfg, n_periods: int = 1):
    """The ``self:N`` draft config: the target truncated to its first
    ``n_periods`` period repetitions (an early-exit draft)."""
    _check_periods(cfg, n_periods)
    return dataclasses.replace(cfg, n_layers=n_periods * len(cfg.period))


def slice_draft_params(params: Params, cfg, n_periods: int = 1) -> Params:
    """Self-speculative draft parameters: the target's first ``n_periods``
    periods of layers, sharing every tensor (embeddings and final norm
    included) with the target: no copies."""
    _check_periods(cfg, n_periods)
    return dict(params, stack=params["stack"][:n_periods * len(cfg.period)])


def build_draft(spec: Optional[str], params: Params, cfg
                ) -> Tuple[Params, object]:
    """``None`` / ``"self"`` / ``"self:N"`` -> ``(draft_params, draft_cfg)``:
    the target's own first N periods (default 1), parameters shared."""
    spec = spec or "self"
    if spec != "self" and not spec.startswith("self:"):
        raise ValueError(f"draft {spec!r}: the port serves the self / self:N "
                         f"early-exit drafts only")
    n = int(spec.split(":", 1)[1]) if ":" in spec else 1
    return slice_draft_params(params, cfg, n), self_draft_config(cfg, n)


# ---------------------------------------------------------------------------
# the draft phase and the round
# ---------------------------------------------------------------------------

def _agg_stats(per_step):
    """Per-step per-site RoutingStats tuples -> one per site: summed leaf
    counts and slots, slot-weighted overflow."""
    per_step = [s for s in per_step if s is not None]
    if not per_step:
        return None
    out = []
    for site in zip(*per_step):
        if any(s is None for s in site):
            out.append(None)
            continue
        slots = sum(s.slots for s in site)
        out.append(api.RoutingStats(
            leaf_counts=sum(s.leaf_counts for s in site),
            overflow=sum(s.overflow * s.slots for s in site)
            / torch.clamp(slots, min=1.0),
            slots=slots))
    return tuple(out)


def draft_rollout(draft_params: Params, dcfg, tok0: torch.Tensor,
                  target_caches: list, draft_caches: list,
                  target_len: torch.Tensor, draft_len: torch.Tensor,
                  write_masks: torch.Tensor, live: torch.Tensor,
                  temps: torch.Tensor, generator: torch.Generator):
    """The draft phase of a round.

    1. Roll both cache trees back to the host-tracked lengths (the previous
       verify appended ``k + 1`` positions optimistically).
    2. ``k + 1`` draft decode steps: step ``j`` feeds the current token at
       each row's cache length, appends its K/V where ``write_masks[j]``
       allows (the ``max_len`` edge), and picks the next draft: argmax for
       ``temps == 0`` rows, a Gumbel-max sample of ``softmax(q / temp)``
       drawn from ``generator`` otherwise, so host rejection can use the
       returned logits as the proposal distribution verbatim.

    tok0 (S, 1) int32 pending tokens; target_len / draft_len (S,) int32;
    write_masks (k+1, S) bool; live (S,) bool, the FFF validity mask; temps
    (S,) float32, or None when every row is greedy.  All on the draft's
    device.  Returns ``(drafts (k, S),
    q_logits (k+1, S, V), target_caches, draft_caches, stats)``, ``stats``
    the step-aggregated per-site routing stats (None without a tap)."""
    target_caches = lm.set_cache_lengths(target_caches, target_len)
    draft_caches = lm.set_cache_lengths(draft_caches, draft_len)
    tok, sampled, q_logits, stats = tok0, [], [], []
    for j in range(write_masks.shape[0]):
        logits, draft_caches, st = lm.decode_step(
            draft_params, dcfg, tok, draft_caches, write_mask=write_masks[j],
            token_valid=live, with_stats=True)
        nxt = logits.argmax(-1)
        if temps is not None:
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device).clamp_(1e-20, 1.0)
            z = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
            nxt = torch.where(temps > 0.0, (z - torch.log(-torch.log(u))).argmax(-1),
                              nxt)
        nxt = nxt.to(torch.int32)
        tok = nxt[:, None]
        sampled.append(nxt)
        q_logits.append(logits)
        stats.append(st)
    # the last step only appends d_k's K/V; its sample is unused
    return (torch.stack(sampled[:-1]), torch.stack(q_logits), target_caches,
            draft_caches, _agg_stats(stats))


def spec_round(params: Params, cfg, draft_params: Params, dcfg,
               tok0: torch.Tensor, caches: list, draft_caches: list,
               target_len: torch.Tensor, draft_len: torch.Tensor,
               write_masks: torch.Tensor, verify_len: torch.Tensor,
               live: torch.Tensor, temps: torch.Tensor,
               generator: torch.Generator, verify_cf: Optional[float] = None):
    """One speculative round: the draft rollout, then the target's verify of
    the ``(S, k + 1)`` slab ``[pending, d_1 .. d_k]``, which reads the drafts
    on the device.  ``verify_len`` (S,) int32 in [0, k + 1] is how many slab
    tokens each row scores and appends (0 = free slot; rows at the cache
    edge clip, as ``write_masks`` does).  ``verify_cf``: the capacity factor
    of the round's dispatches (``api.overrides``, nested inside and winning
    over the engine's own), which the engine scales by ``k + 1``; the
    rollout runs at it too, since draft capacity drops only cost acceptance.
    None = the backends' defaults.  Returns ``(drafts (k, S), q_logits
    (k+1, S, V), p_logits (S, k+1, V), caches, draft_caches, draft_stats,
    verify_stats)``."""
    with (api.overrides(capacity_factor=verify_cf) if verify_cf is not None
          else contextlib.nullcontext()):
        drafts, q_logits, caches, draft_caches, dstats = draft_rollout(
            draft_params, dcfg, tok0, caches, draft_caches, target_len,
            draft_len, write_masks, live, temps, generator)
        vtoks = torch.cat([tok0, drafts.t()], dim=1)          # (S, k+1)
        p_logits, caches, vstats = lm.verify_chunk(params, cfg, vtoks,
                                                   verify_len, caches)
    return drafts, q_logits, p_logits, caches, draft_caches, dstats, vstats


def chunk_both(params: Params, cfg, draft_params: Params, dcfg,
               tokens: torch.Tensor, valid_len: torch.Tensor, caches: list,
               draft_caches: list):
    """A prefill slab with speculation on: the same slab advances both
    cache trees."""
    logits, caches, stats = lm.prefill_chunk(params, cfg, tokens, valid_len,
                                             caches)
    _, draft_caches, dstats = lm.prefill_chunk(draft_params, dcfg, tokens,
                                               valid_len, draft_caches)
    return logits, caches, draft_caches, stats, dstats


# ---------------------------------------------------------------------------
# host-side rejection sampling (exact target distribution); numpy, as in the
# JAX package
# ---------------------------------------------------------------------------

def _softmax64(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, np.float64)
    z = z - z.max()
    e = np.exp(z)
    return e / e.sum()


def rejection_sample(p_logits: np.ndarray, q_logits: np.ndarray,
                     drafts: np.ndarray, temperature: float,
                     rng: Optional[np.random.Generator] = None
                     ) -> Tuple[List[int], int]:
    """Speculative rejection sampling for one row.

    p_logits (m+1, V): row ``j`` is the target's next-token distribution
    after the pending token plus drafts ``d_1 .. d_j``; q_logits (m, V): row
    ``j`` is what ``d_{j+1}`` was sampled from; drafts (m,).  Returns
    ``(emitted, n_accepted)``: the accepted prefix plus one more token (the
    corrected sample from ``norm(max(p - q, 0))`` at the first rejection,
    or the bonus token from the target's last distribution).  Emitted
    tokens are distributed exactly as the target's one-at-a-time samples;
    greedy (temperature <= 0) gives the target's argmax chain."""
    m = len(drafts)
    emitted: List[int] = []
    if temperature <= 0.0:
        for j in range(m):
            t = int(p_logits[j].argmax())
            if t != int(drafts[j]):
                return emitted + [t], j
            emitted.append(t)
        return emitted + [int(p_logits[m].argmax())], m
    for j in range(m):
        p = _softmax64(p_logits[j] / temperature)
        q = _softmax64(q_logits[j] / temperature)
        d = int(drafts[j])
        if rng.random() < min(1.0, p[d] / max(q[d], 1e-300)):
            emitted.append(d)
            continue
        r = np.maximum(p - q, 0.0)
        s = r.sum()
        if s <= 0.0:          # numerically p <= q everywhere: p itself
            r, s = p, p.sum()
        return emitted + [int(rng.choice(r.size, p=r / s))], j
    p = _softmax64(p_logits[m] / temperature)
    return emitted + [int(rng.choice(p.size, p=p / p.sum()))], m
