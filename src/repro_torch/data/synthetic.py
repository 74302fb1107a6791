"""Deterministic synthetic token stream (a private numpy copy of
``repro/data/synthetic.py:SyntheticLMDataset``, so the port's calibration
stream yields the reference's tokens without importing it).

Markov-chain tokens with copyable bigrams; determinism is keyed by
(seed, step, host)."""
from __future__ import annotations

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab: int, seq_len: int, seed: int = 0):
        self.vocab, self.seq_len, self.seed = vocab, seq_len, seed
        rng = np.random.default_rng(seed)
        # sparse bigram transition table (each token has 4 likely followers)
        self.next_tok = rng.integers(0, vocab, size=(vocab, 4))

    def batch(self, step: int, batch_size: int, host: int = 0):
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + host)
        toks = np.empty((batch_size, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch_size)
        choice = rng.integers(0, 4, size=(batch_size, self.seq_len))
        noise = rng.random((batch_size, self.seq_len)) < 0.05
        rand = rng.integers(0, self.vocab, size=(batch_size, self.seq_len))
        for t in range(self.seq_len):
            nxt = self.next_tok[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
