"""Deterministic synthetic datasets (a private numpy copy of
``repro/data/synthetic.py``, so the port yields the reference's data
without importing it).

- SyntheticLMDataset: Markov-chain tokens with copyable bigrams;
  determinism is keyed by (seed, step, host).
- synthetic_images: procedural shape-classification images for the
  paper's Table-2 accuracy-mechanism reproduction."""
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


def synthetic_images(n: int, size: int = 16, n_classes: int = 10,
                     seed: int = 0):
    """Procedural images: class = (shape, quadrant) combos + color noise.

    Returns (images (n, size, size, 3) f32 in [0,1], labels (n,) int32),
    the reference's arrays bit for bit."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    imgs = rng.normal(0.5, 0.08, (n, size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        c = labels[i]
        shape, quad = c % 5, c // 5
        cx = size // 4 + (quad % 2) * size // 2 + rng.integers(-1, 2)
        cy = size // 4 + (quad // 2) * size // 2 + rng.integers(-1, 2)
        r = size // 5
        if shape == 0:
            m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
        elif shape == 1:
            m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        elif shape == 2:
            m = (np.abs(xx - cx) + np.abs(yy - cy)) < r
        elif shape == 3:
            m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < 2)
        else:
            m = (np.abs(xx - cx) < 2) & (np.abs(yy - cy) < r)
        col = np.array([0.9, 0.2, 0.2]) if shape % 2 else \
            np.array([0.2, 0.2, 0.9])
        imgs[i][m] = col + rng.normal(0, 0.05, 3)
    return np.clip(imgs, 0, 1), labels
