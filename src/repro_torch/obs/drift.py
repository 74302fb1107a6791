"""Encoded-MAC drift monitor: dense-vs-encoded agreement, online (port of
``repro/obs/drift.py``).

The paper's accuracy/efficiency tradeoff is top-1 logit agreement
between the dense fp forward and the calibrated encoded forward.  The
``DriftMonitor`` makes that number observable *while serving*: every N
engine steps it runs a sample of the currently resident prompts through
both parameter sets and publishes the agreement as a gauge.  The
forwards run eagerly between engine steps, without a cache, on tensors
of their own: they touch neither the page pools nor any captured graph's
buffers, and the encoded one runs kernel 1 at m = the sampled prompt
length (at most ``max_len``).

Under speculative decoding the replay is redundant work: every verify
step already computes the serving logits at each drafted position, and
draft-vs-target top-1 agreement is the drift number.  The engine feeds
those per-round counts into ``observe_agreement`` instead of calling
``maybe_sample``, so the gauge costs no extra forward.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def logit_agreement(params_a, cfg_a, params_b, cfg_b, prompts,
                    max_len: Optional[int] = None):
    """Top-1 argmax agreement + mean |Δlogit| between two forwards over
    full prompt prefills (all positions, vocab-clipped).  Each forward
    runs on its params' device; the logits are compared on the host in
    f32, as the reference compares them."""
    import torch
    from repro_torch.models import apply_model
    agree, n, dsum = 0, 0, 0.0
    for p in prompts:
        # analysis: allow(host-sync): the prompts are host token arrays
        p = np.asarray(p)[:max_len] if max_len else np.asarray(p)
        if p.size == 0:
            continue
        v = min(cfg_a.vocab_size, cfg_b.vocab_size)
        rows = []
        for params, cfg in ((params_a, cfg_a), (params_b, cfg_b)):
            dev = params["embed"]["table"].device
            t = torch.as_tensor(p.astype(np.int32), device=dev)[None]
            with torch.inference_mode():
                lg, _ = apply_model(params, cfg, t)
            # analysis: allow(host-sync): opt-in drift sample between steps
            rows.append(lg[0, :, :v].to(torch.float32).cpu().numpy())
        la, lb = rows
        agree += int((la.argmax(-1) == lb.argmax(-1)).sum())
        n += la.shape[0]
        dsum += float(np.abs(la - lb).mean())
    if n == 0:
        return float("nan"), float("nan")
    return agree / n, dsum / max(len(prompts), 1)


class DriftMonitor:
    """Samples serving-params-vs-reference top-1 agreement every
    ``every`` engine steps and publishes it through the registry.

    ``params_ref``/``cfg_ref`` are the dense fp reference (the params
    from before the fold); the engine passes its own (encoded) params at
    sample time.  Sampling runs both forwards between engine steps, so
    ``every`` trades freshness against throughput — the work is bounded
    by ``max_prompts`` prompts of ``max_len`` tokens per sample.
    """

    def __init__(self, params_ref, cfg_ref, every: int = 64,
                 max_prompts: int = 2, max_len: int = 32):
        if every < 1:
            raise ValueError("drift monitor: every must be >= 1")
        self.params_ref, self.cfg_ref = params_ref, cfg_ref
        self.every = every
        self.max_prompts = max_prompts
        self.max_len = max_len
        self.last: Optional[float] = None
        self.last_delta: Optional[float] = None
        self._g_agree = self._g_delta = self._c_samples = None
        # observe_agreement accumulators (spec-decode reuse path)
        self._obs_match = 0
        self._obs_total = 0

    def bind(self, registry) -> "DriftMonitor":
        self._g_agree = registry.gauge(
            "encoded_drift_top1",
            "online dense-vs-encoded top-1 logit agreement")
        self._g_delta = registry.gauge(
            "encoded_drift_abs_logit", "mean |Δlogit| vs the reference")
        self._c_samples = registry.counter(
            "drift_samples", "drift monitor sampling events")
        return self

    def sample(self, params, cfg, prompts: List[np.ndarray]):
        """Measure now (unconditionally) and publish; returns the
        agreement, or None when there was nothing to sample."""
        # analysis: allow(host-sync): the prompts are host token arrays
        prompts = [p for p in prompts if np.asarray(p).size][:self.max_prompts]
        if not prompts:
            return None
        agree, delta = logit_agreement(self.params_ref, self.cfg_ref,
                                       params, cfg, prompts,
                                       max_len=self.max_len)
        self.last, self.last_delta = agree, delta
        if self._g_agree is not None:
            self._g_agree.set(agree)
            self._g_delta.set(delta)
            self._c_samples.inc()
        return agree

    def maybe_sample(self, step: int, params, cfg,
                     prompts: List[np.ndarray]):
        """Engine hook: sample only on every ``every``-th step."""
        if step % self.every:
            return None
        return self.sample(params, cfg, prompts)

    def observe_agreement(self, n_match: int, n_total: int) -> None:
        """Publish drift from agreement counts the caller already has —
        the speculative-decoding engine's draft-vs-verify top-1 matches,
        measured on the verifier's logits during verification, so the
        gauge costs no extra forward.  Counts
        accumulate over the run (the gauge is the running agreement
        rate); |Δlogit| is not observable this way and keeps its last
        sampled value."""
        if n_total <= 0:
            return
        self._obs_match += int(n_match)
        self._obs_total += int(n_total)
        self.last = self._obs_match / self._obs_total
        if self._g_agree is not None:
            self._g_agree.set(self.last)
            self._c_samples.inc()
