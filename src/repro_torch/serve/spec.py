"""Speculative decoding: the draft and verify steps and the acceptance
rules (port of ``repro/serve/spec.py``).

The encoded model is a built-in drafter: draft k tokens per slot with a
cheap path, then score all k+1 positions in ONE batched forward of the
verifier over the same paged pools and keep the longest agreeing prefix
plus a bonus token.  It is exact, not approximate:

  * **Verify overwrites draft K/V.**  The draft steps write approximate
    K/V at positions ``C..C+k-1`` (C = tokens already cached); the verify
    forward runs those positions through the verifier's projections and,
    because the paged attention branch scatters before it attends,
    overwrites them before any read.  Every committed position is the
    verifier's, so greedy verification gives plain decode's tokens.
  * **Rollback is host arithmetic.**  Rejected positions stay past the
    request's ``n_cached``: masked on read, overwritten by the next round.

``rejection_sample`` is the speculative-sampling rule (accept draft token
x with probability ``min(1, p_target / p_draft)``, on the first rejection
resample from ``max(0, p_t - p_d)``, a bonus token when all k survive);
``greedy_accept`` is its temperature-0 form, the engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import apply_model


def greedy_accept(draft: Sequence[int], target: Sequence[int]) -> int:
    """Length of the longest prefix where ``draft[i] == target[i]``."""
    n = 0
    for d, t in zip(draft, target):
        if int(d) != int(t):
            break
        n += 1
    return n


def rejection_sample(draft_probs: np.ndarray, target_probs: np.ndarray,
                     draft_tokens: Sequence[int],
                     rng: np.random.Generator) -> Tuple[list, int]:
    """Speculative rejection sampling: ``(emitted_tokens, n_accepted)``.

    draft_probs (k, V) and target_probs (k+1, V) are the two models'
    distributions at the drafted positions (the target's plus the bonus
    position); draft_tokens (k,) the tokens the drafter sampled.  Emits 1
    to k+1 tokens distributed as ancestral sampling from the target, with
    the reference's draws from ``rng``."""
    k = len(draft_tokens)
    assert draft_probs.shape[0] == k and target_probs.shape[0] == k + 1
    out: list = []
    for i in range(k):
        x = int(draft_tokens[i])
        p_t = float(target_probs[i, x])
        p_d = float(draft_probs[i, x])
        if p_d <= 0.0 or rng.random() < min(1.0, p_t / p_d):
            out.append(x)
            continue
        resid = np.maximum(target_probs[i] - draft_probs[i], 0.0)
        tot = float(resid.sum())
        if tot <= 0.0:
            tok = int(np.argmax(target_probs[i]))
        else:
            tok = int(rng.choice(resid.shape[0], p=resid / tot))
        return out + [tok], i
    bonus = np.asarray(target_probs[k], np.float64)
    bonus = bonus / bonus.sum()
    return out + [int(rng.choice(bonus.shape[0], p=bonus))], k


def make_spec_draft(cfg, k: int):
    """Draft ``k`` greedy tokens per slot against the shared paged pools:
    the k decode steps run one after another in one call (one captured
    graph on the card), step i at ``lens + i``.  ``tokens`` (B, 1) int32
    → draft tokens (B, k) int32, with the drafter's K/V written at
    positions ``lens .. lens + k - 1``."""
    def draft(params, layers, tokens, pages, lens):
        toks = []
        t = tokens
        for i in range(k):
            cache = {"layers": layers, "pages": pages, "lens": lens + i}
            logits, _ = apply_model(params, cfg, t, cache=cache)
            t = torch.argmax(logits[:, -1:, :cfg.vocab_size],
                             dim=-1).to(torch.int32)
            toks.append(t)
        return torch.cat(toks, dim=1)

    return draft


def make_spec_verify(cfg, k: int):
    """One forward of the verifier over all k+1 positions per slot:
    ``tokens`` (B, 1) and ``draft`` (B, k) are joined on the device, the
    forward writes its K/V over positions ``lens .. lens + k`` and attends
    through the fused op (``paged_fused_max_sq`` raised to k+1).  Returns
    the verifier's argmax (B, k+1) int32."""
    cfg_v = dataclasses.replace(
        cfg, paged_fused_max_sq=max(cfg.paged_fused_max_sq, k + 1))

    def verify(params, layers, tokens, draft, pages, lens):
        seq = torch.cat([tokens, draft], dim=1)               # (B, k+1)
        cache = {"layers": layers, "pages": pages, "lens": lens}
        logits, _ = apply_model(params, cfg_v, seq, cache=cache)
        return torch.argmax(logits[..., :cfg_v.vocab_size],
                            dim=-1).to(torch.int32)

    return verify
