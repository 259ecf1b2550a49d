"""Latency/throughput summaries (port of the parts of ``repro/serving/
metrics.py`` the fixed-batch serve loop uses).  Inputs are seconds;
summaries render in milliseconds."""
from __future__ import annotations

import dataclasses
from typing import Sequence

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
