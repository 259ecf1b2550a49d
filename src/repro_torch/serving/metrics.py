"""Latency/throughput summaries and the engine's metrics (port of
``repro/serving/metrics.py``): the paging counters, the per-tenant
breakdown and the JSON view (``as_dict``, ``serve.py --metrics-json``).
Inputs are seconds; summaries render in milliseconds."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    n: int
    mean_ms: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    max_ms: float

    def line(self, label: str) -> str:
        return (f"{label}: p50 {self.p50_ms:.2f}ms p90 {self.p90_ms:.2f}ms "
                f"p99 {self.p99_ms:.2f}ms mean {self.mean_ms:.2f}ms "
                f"max {self.max_ms:.2f}ms (n={self.n})")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def summarize(samples_s: Sequence[float]) -> LatencySummary:
    """Percentile summary of latency samples (seconds in, ms out)."""
    a = np.asarray(list(samples_s), np.float64)
    if a.size == 0:
        return LatencySummary(0, 0.0, 0.0, 0.0, 0.0, 0.0)
    ms = a * 1e3
    return LatencySummary(
        n=int(a.size), mean_ms=float(ms.mean()),
        p50_ms=float(np.percentile(ms, 50)),
        p90_ms=float(np.percentile(ms, 90)),
        p99_ms=float(np.percentile(ms, 99)),
        max_ms=float(ms.max()))


def tokens_per_second(n_tokens: int, elapsed_s: float) -> float:
    """Throughput with a zero-division guard (0 tokens in 0s -> 0.0)."""
    return n_tokens / max(elapsed_s, 1e-9)


@dataclasses.dataclass
class EngineMetrics:
    """Aggregate engine telemetry, filled by ``engine.run`` from its
    finished ``RequestResult``s and snapshotted live by
    ``engine.poll_metrics()``.

    Latency summaries are over finished requests (``ttft``, ``per_token``,
    ``e2e``), decode-side dispatches (``decode_step``: a decode step, or a
    whole speculative round), and gaps between consecutive decode-side
    dispatches while work was in flight (``decode_interval``: a monolithic
    prefill lands in one of these gaps, chunked prefill bounds them).
    ``queue_depth``, ``active_slots``, ``prefilling_slots``, ``pages_in_use``
    and ``pages_free`` are instantaneous (the queue and slot counts are 0 in
    a finished ``run`` report, meaningful from ``poll_metrics``).

    Paged KV cache and prefix sharing: ``prefill_tokens`` counts prompt
    tokens prefilled on the device, ``prefix_hit_tokens`` those served from
    shared pages instead (together, the prompt tokens admitted), and
    ``cow_copies`` the copy-on-write page copies.  ``tenants`` is the
    per-tenant breakdown over finished requests (``tenant_breakdown``);
    ``poll_metrics`` adds each tenant's live ``queue_depth`` and learned
    ``profile``."""
    n_requests: int = 0
    n_tokens: int = 0
    elapsed_s: float = 0.0
    n_steps: int = 0
    n_prefills: int = 0
    n_chunks: int = 0                    # chunked-prefill dispatches
    ttft: LatencySummary = dataclasses.field(
        default_factory=lambda: summarize(()))
    per_token: LatencySummary = dataclasses.field(
        default_factory=lambda: summarize(()))
    e2e: LatencySummary = dataclasses.field(
        default_factory=lambda: summarize(()))
    decode_step: LatencySummary = dataclasses.field(
        default_factory=lambda: summarize(()))
    decode_interval: LatencySummary = dataclasses.field(
        default_factory=lambda: summarize(()))
    overflow_fraction_mean: float = 0.0
    overflow_decode_mean: float = 0.0
    # overflow-policy accounting: estimated (token, tree) slots that took
    # the configured overflow path instead of dropping to zeros, and the
    # fraction of slots served by the master leaf alone (nonzero only under
    # overflow_policy="master_leaf")
    overflow_repairs: int = 0
    master_leaf_fraction: float = 0.0
    hint_mismatches: int = 0             # leaf_hints dropped for size mismatch
    # speculative decoding: draft tokens proposed and accepted
    # (spec_acceptance = accepted / drafted, 0 when speculation is off)
    draft_tokens: int = 0
    accepted_tokens: int = 0
    prefill_tokens: int = 0              # prompt tokens prefilled on device
    prefix_hit_tokens: int = 0           # prompt tokens from shared pages
    cow_copies: int = 0                  # copy-on-write page copies
    pages_in_use: int = 0                # page pool (instantaneous)
    pages_free: int = 0
    queue_depth: int = 0                 # waiting requests (instantaneous)
    active_slots: int = 0                # occupied slots (instantaneous)
    prefilling_slots: int = 0            # slots mid-chunked-prefill
    tenants: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def throughput_tok_s(self) -> float:
        return tokens_per_second(self.n_tokens, self.elapsed_s)

    @property
    def spec_acceptance(self) -> float:
        return self.accepted_tokens / max(self.draft_tokens, 1)

    @property
    def wasted_tokens(self) -> int:
        return self.draft_tokens - self.accepted_tokens

    def report(self) -> str:
        lines = [
            f"served {self.n_requests} requests, {self.n_tokens} tokens in "
            f"{self.elapsed_s:.2f}s ({self.throughput_tok_s:.1f} tok/s, "
            f"{self.n_steps} decode steps, {self.n_prefills} prefills"
            + (f", {self.n_chunks} prefill chunks" if self.n_chunks else "")
            + ")",
            self.ttft.line("ttft"),
            self.per_token.line("per-token"),
            self.e2e.line("e2e"),
            self.decode_step.line("decode step"),
            self.decode_interval.line("decode interval"),
            f"fff overflow_fraction mean {self.overflow_fraction_mean:.4f} "
            f"(decode-only {self.overflow_decode_mean:.4f})",
        ]
        if self.overflow_repairs:
            lines.append(
                f"overflow policy: ~{self.overflow_repairs} slots repaired "
                f"(master-leaf fraction {self.master_leaf_fraction:.4f})")
        if self.draft_tokens:
            lines.append(
                f"speculative: {self.draft_tokens} drafted, "
                f"{self.accepted_tokens} accepted "
                f"(acceptance {self.spec_acceptance:.3f}, "
                f"{self.wasted_tokens} wasted)")
        if self.hint_mismatches:
            lines.append(f"leaf_hint size mismatches dropped: "
                         f"{self.hint_mismatches}")
        if self.prefix_hit_tokens or self.cow_copies:
            lines.append(
                f"paged kv: {self.prefill_tokens} tokens prefilled, "
                f"{self.prefix_hit_tokens} served from shared prefix pages "
                f"({self.cow_copies} cow copies)")
        if set(self.tenants) - {"default"}:
            for t, d in sorted(self.tenants.items()):
                if "n_requests" not in d:
                    continue
                lines.append(
                    f"tenant {t}: {d['n_requests']} requests, "
                    f"{d['n_tokens']} tokens ({d['throughput_tok_s']:.1f} "
                    f"tok/s), ttft p50 {d['ttft_ms']['p50_ms']:.2f}ms")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        """The metrics JSON schema (``serve.py --metrics-json``), the JAX
        package's field for field."""
        return {
            "n_requests": self.n_requests, "n_tokens": self.n_tokens,
            "elapsed_s": self.elapsed_s, "n_steps": self.n_steps,
            "n_prefills": self.n_prefills, "n_chunks": self.n_chunks,
            "throughput_tok_s": self.throughput_tok_s,
            "ttft_ms": self.ttft.as_dict(),
            "per_token_ms": self.per_token.as_dict(),
            "e2e_ms": self.e2e.as_dict(),
            "decode_step_ms": self.decode_step.as_dict(),
            "decode_interval_ms": self.decode_interval.as_dict(),
            "overflow_fraction_mean": self.overflow_fraction_mean,
            "overflow_decode_mean": self.overflow_decode_mean,
            "overflow_repairs": self.overflow_repairs,
            "master_leaf_fraction": self.master_leaf_fraction,
            "hint_mismatches": self.hint_mismatches,
            "spec_acceptance": self.spec_acceptance,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "wasted_tokens": self.wasted_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "prefilling_slots": self.prefilling_slots,
            "tenants": self.tenants,
        }


def tenant_breakdown(results: Iterable, elapsed_s: float) -> Dict[str, dict]:
    """Per-tenant slice of finished requests: request and token counts,
    tokens/s over the shared wall clock (under saturation the ratios track
    the admission weights), TTFT and e2e summaries, speculation counts."""
    rs = list(results)
    out: Dict[str, dict] = {}
    for t in sorted({r.tenant for r in rs}):
        trs = [r for r in rs if r.tenant == t]
        n_tok = sum(r.n_generated for r in trs)
        drafted = sum(r.n_drafted for r in trs)
        accepted = sum(r.n_accepted for r in trs)
        out[t] = {
            "n_requests": len(trs),
            "n_tokens": n_tok,
            "throughput_tok_s": tokens_per_second(n_tok, elapsed_s),
            "ttft_ms": summarize([r.ttft for r in trs]).as_dict(),
            "e2e_ms": summarize([r.e2e_latency for r in trs]).as_dict(),
            "draft_tokens": drafted,
            "accepted_tokens": accepted,
            "spec_acceptance": accepted / max(drafted, 1),
        }
    return out


def from_results(results: Iterable, *, elapsed_s: float, n_steps: int,
                 n_prefills: int, decode_lat_s: Sequence[float],
                 overflow_mean: float, overflow_decode_mean: float = 0.0,
                 overflow_repairs: int = 0, master_leaf_fraction: float = 0.0,
                 n_chunks: int = 0, decode_interval_s: Sequence[float] = (),
                 hint_mismatches: int = 0, draft_tokens: int = 0,
                 accepted_tokens: int = 0, prefill_tokens: int = 0,
                 prefix_hit_tokens: int = 0, cow_copies: int = 0,
                 pages_in_use: int = 0, pages_free: int = 0
                 ) -> EngineMetrics:
    """Build an ``EngineMetrics`` from finished ``RequestResult`` records."""
    rs = list(results)
    return EngineMetrics(
        n_requests=len(rs),
        n_tokens=sum(r.n_generated for r in rs),
        elapsed_s=elapsed_s, n_steps=n_steps, n_prefills=n_prefills,
        n_chunks=n_chunks,
        ttft=summarize([r.ttft for r in rs]),
        per_token=summarize([r.per_token_latency() for r in rs]),
        e2e=summarize([r.e2e_latency for r in rs]),
        decode_step=summarize(decode_lat_s),
        decode_interval=summarize(decode_interval_s),
        overflow_fraction_mean=overflow_mean,
        overflow_decode_mean=overflow_decode_mean,
        overflow_repairs=overflow_repairs,
        master_leaf_fraction=master_leaf_fraction,
        hint_mismatches=hint_mismatches,
        draft_tokens=draft_tokens,
        accepted_tokens=accepted_tokens,
        prefill_tokens=prefill_tokens,
        prefix_hit_tokens=prefix_hit_tokens,
        cow_copies=cow_copies,
        pages_in_use=pages_in_use,
        pages_free=pages_free,
        tenants=tenant_breakdown(rs, elapsed_s))
