"""Synthetic LM token stream: an order-2 Markov source with a power-law
unigram prior.  Learnable structure (bigram/trigram statistics) so LM training
loss decreases meaningfully; fully deterministic given a seed.  (Copy of
``repro/data/tokens.py``: the port imports nothing of the JAX package.)"""
from __future__ import annotations

import numpy as np


class MarkovTokenSource:
    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 8):
        self.vocab = vocab_size
        self.branch = branch
        rng = np.random.default_rng(seed)
        # power-law unigram prior
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.prior = (1.0 / ranks ** 1.1)
        self.prior /= self.prior.sum()
        # each context hashes to `branch` plausible successors
        self._a = int(rng.integers(1, 2**31 - 1)) | 1
        self._b = int(rng.integers(1, 2**31 - 1))
        self._succ = rng.choice(vocab_size, size=(4096, branch), p=self.prior)

    def _ctx_hash(self, t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
        return ((t1 * self._a + t2 * 31 + self._b) % 4096).astype(np.int64)

    def sample(self, batch: int, seq_len: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty((batch, seq_len + 1), dtype=np.int32)
        out[:, 0] = rng.choice(self.vocab, size=batch, p=self.prior)
        out[:, 1] = rng.choice(self.vocab, size=batch, p=self.prior)
        for t in range(2, seq_len + 1):
            h = self._ctx_hash(out[:, t - 2], out[:, t - 1])
            pick = rng.integers(0, self.branch, size=batch)
            nxt = self._succ[h, pick]
            # 10% noise from the prior keeps entropy > 0
            noise = rng.random(batch) < 0.1
            nxt = np.where(noise, rng.choice(self.vocab, size=batch, p=self.prior),
                           nxt)
            out[:, t] = nxt
        return out

    def batch(self, batch: int, seq_len: int, seed: int) -> dict:
        toks = self.sample(batch, seq_len, seed)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
