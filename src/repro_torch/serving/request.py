"""Serving request and result types (port of ``repro/serving/request.py``).

A ``Request`` is what enters the engine queue: prompt tokens plus sampling
and stop parameters.  ``tenant`` names the traffic class the request bills
to: the engine keeps per-tenant queues, the ``weighted_leaf_aware``
scheduler admits weighted-fair across tenants, and the routing-profile
store (``serving/profiles.py``) learns each tenant's leaf footprint from
its finished requests.  ``leaf_hint`` is an optional prior over the
model's FFF leaves for this request's tokens, which the leaf-aware
schedulers use to predict how a candidate would load the batch before it
has been prefilled; without one they fall back to the tenant's learned
profile, then uniform.  Once admitted, live telemetry replaces both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


# eq=False (identity equality): the engine's queue.remove and the
# scheduler's hold map must never field-compare numpy prompts, and
# duplicate rids must not alias distinct requests
@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray                      # (L,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0                # 0 = greedy
    eos_id: Optional[int] = None            # None = run the full budget
    arrival_time: float = 0.0               # engine-clock seconds
    leaf_hint: Optional[np.ndarray] = None  # (E,) nonnegative, any scale
    tenant: str = "default"                 # traffic class (QoS accounting)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError(f"request {self.rid}: tenant must be a "
                             f"non-empty string")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")
        if self.leaf_hint is not None:
            self.leaf_hint = np.asarray(self.leaf_hint, np.float64).reshape(-1)
            if (self.leaf_hint < 0).any():
                # the scheduler normalizes by sum: a mixed-sign hint would
                # lower predicted load and queue-jump every honest request
                raise ValueError(f"request {self.rid}: leaf_hint must be "
                                 f"nonnegative")
            if not np.isfinite(self.leaf_hint).all():
                raise ValueError(f"request {self.rid}: leaf_hint must be "
                                 f"finite")


@dataclasses.dataclass(eq=False)
class RequestResult:
    """Completed request: generated tokens and lifecycle timestamps (engine
    clock, seconds).  ``finish_reason`` is "eos" | "length"."""
    rid: int
    prompt: np.ndarray
    tokens: np.ndarray                      # (n_generated,) int32
    finish_reason: str
    arrival_time: float
    admitted_time: float
    first_token_time: float
    finish_time: float
    tenant: str = "default"
    # speculative decoding: draft tokens proposed/accepted for this request
    # (0/0 without speculation)
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def n_generated(self) -> int:
        return int(self.tokens.size)

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def e2e_latency(self) -> float:
        return self.finish_time - self.arrival_time

    def per_token_latency(self) -> float:
        """Mean decode seconds per generated token after the first."""
        n = max(self.n_generated - 1, 1)
        return (self.finish_time - self.first_token_time) / n


@dataclasses.dataclass
class SlotState:
    """Host-side record of one cache slot's occupant.

    ``prefill_pos`` is how many prompt tokens are already in the slot's
    cache: monolithic admission sets it to the prompt length at once;
    chunked prefill advances it chunk by chunk, and the slot decodes once
    ``prefilling`` is False.  ``first_token_time`` is 0.0 until the first
    token is sampled."""
    request: Request
    admitted_time: float
    first_token_time: float
    tokens: list                            # generated token ids (host ints)
    total_len: int                          # prompt + generated, in cache
    prefill_pos: int = 0                    # prompt tokens consumed so far
    done: bool = False
    finish_reason: str = ""
    finish_time: float = 0.0
    n_drafted: int = 0                      # spec decoding: proposed drafts
    n_accepted: int = 0                     # spec decoding: accepted drafts

    @property
    def prefilling(self) -> bool:
        """True while the occupant still has prompt tokens to consume."""
        return self.prefill_pos < self.request.prompt.size
