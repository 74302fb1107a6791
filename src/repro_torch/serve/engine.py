"""Continuous-batching greedy ``Engine`` over the paged KV cache (port of
``Engine`` from ``repro/serve/engine.py``; telemetry, speculative
decoding, mesh, sanitizer and prefix cache wait).

A scheduler admits queued requests into a fixed number of slots under a
page budget; each engine step runs one prefill chunk per prefilling slot
(``(1, prefill_chunk)`` tokens, right-padded) and then one decode step for
all ``n_slots`` rows, whatever each request's progress.  The page pools are
updated in place by both.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import apply_model, supports_paged_cache
from .paged_cache import PagedKVCache
from .scheduler import DECODING, FINISHED, Request, Scheduler


def _percentile(xs, q: float) -> float:
    """numpy's linear-interpolation percentile; NaN on an empty sample."""
    return float(np.percentile(xs, q)) if len(xs) else float("nan")


class Engine:
    """Continuous-batching greedy serving engine over the paged KV cache.

    ``reserve='conservative'`` admits a request only when pages for
    prompt+max_new are free; ``'optimistic'`` admits on prompt pages alone
    and grows page by page, evicting the youngest running request on
    exhaustion (its generated tokens are kept and re-prefilled).

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    PyTorch versions.  ``params`` must already live on that device."""

    def __init__(self, params, cfg, *, n_slots: int = 4,
                 page_size: int = 16, n_pages: int = 128,
                 max_seq_pages: Optional[int] = None,
                 reserve: str = "conservative", prefill_chunk: int = 32,
                 device=None):
        if not supports_paged_cache(cfg):
            raise ValueError(f"{cfg.arch!r} cannot serve paged")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.params, self.cfg = params, cfg
        self.prefill_chunk = prefill_chunk
        if max_seq_pages is None:
            # default: one sequence may hold up to half the pool
            max_seq_pages = max(4, (n_pages - 1) // 2)
        self.kv = PagedKVCache(cfg, n_slots, n_pages, page_size,
                               max_seq_pages, device=device)
        self.device = self.kv.device
        self.sched = Scheduler(self.kv, reserve=reserve)
        self.requests = {}
        self._next_rid = 0
        self.clock = 0
        self.counters = {"steps": 0, "decode_steps": 0, "decode_tokens": 0,
                         "prefill_tokens": 0, "prefills": 0,
                         "prefill_chunks": 0, "occupancy_sum": 0.0,
                         "stalls": 0, "rejects": 0}
        self.step_ms = []

    # ---- API ---------------------------------------------------------------

    def submit(self, prompt, max_new: int = 32,
               eos_id: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32).ravel()
        if int(prompt.shape[0]) + max_new > self.kv.max_seq_tokens:
            self.counters["rejects"] += 1
            raise ValueError(
                f"request of {prompt.shape[0]} prompt + {max_new} new "
                f"tokens exceeds the {self.kv.max_seq_tokens}-token "
                f"per-sequence limit (max_seq_pages={self.kv.max_seq_pages}"
                f" × page_size={self.kv.page_size}); raise max_seq_pages "
                "or split the request")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new, eos_id=eos_id,
                      t_arrive=time.perf_counter())
        self.requests[rid] = req
        self.sched.submit(req)
        return rid

    @property
    def busy(self) -> bool:
        return self.sched.busy

    def run(self, max_steps: int = 100_000) -> dict:
        """Drive the loop until the queue and all slots drain; at most
        ``max_steps`` steps in this call."""
        start = self.counters["steps"]
        while self.busy:
            if self.counters["steps"] - start >= max_steps:
                raise RuntimeError(f"engine did not drain within {max_steps}"
                                   " steps (livelock?)")
            self.step()
        return self.results()

    def results(self) -> dict:
        return {rid: np.asarray(r.out, np.int32)
                for rid, r in self.requests.items() if r.state == FINISHED}

    def step(self) -> None:
        t0 = time.perf_counter()
        self._step_impl()
        self.step_ms.append((time.perf_counter() - t0) * 1e3)

    # ---- one scheduler tick ------------------------------------------------

    def _step_impl(self) -> None:
        self.counters["steps"] += 1
        self.clock += 1
        # admit and run ONE prefill chunk per prefilling slot; a prefill
        # that finishes at EOS frees its slot, so keep admitting until no
        # new slot fills (each request still runs at most one chunk)
        chunked = set()
        while True:
            self.sched.admissions()
            todo = [r for r in self.sched.prefilling()
                    if r.rid not in chunked]
            if not todo:
                break
            for req in todo:
                chunked.add(req.rid)
                self._prefill_chunk(req)
        active = self._runnable()
        worked = set(chunked) | {r.rid for r in active}
        self.counters["occupancy_sum"] += len(worked) / self.kv.n_slots
        if not active:
            if chunked or not self.sched.queue:
                return
            raise RuntimeError(
                "page pool too small for the queued request "
                f"(need {self.sched._pages_needed(self.sched.queue[0])}"
                f" pages, {self.kv.alloc.n_free} free)")
        tokens = np.zeros((self.kv.n_slots, 1), np.int32)
        # refresh lens for every slotted request (stalled ones included, so
        # their dummy write this step lands past their pages → scratch;
        # mid-prefill slots' dummy write lands at their cursor and is
        # overwritten by their next chunk before it is ever read); idle
        # rows keep lens 0 and an all-scratch page row
        for r in self.sched.slots:
            if r is not None:
                self.kv.set_len(r.slot, r.n_cached)
        for req in active:
            tokens[req.slot, 0] = req.out[-1]
        toks = self._decode(tokens)
        self.counters["decode_steps"] += 1
        now = time.perf_counter()
        for req in active:
            req.n_cached += 1
            req.out.append(int(toks[req.slot]))
            self.counters["decode_tokens"] += 1
            if req.done:
                self.sched.finish(req, now)

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray) -> np.ndarray:
        """One greedy token for every slot (all ``n_slots`` rows run)."""
        cache = {"layers": self.kv.layers, "pages": self.kv.pages_dev(),
                 "lens": self.kv.lens_dev()}
        logits, _ = apply_model(
            self.params, self.cfg,
            torch.from_numpy(tokens).to(self.device), cache=cache)
        toks = torch.argmax(logits[:, -1, :self.cfg.vocab_size], -1)
        return toks.cpu().numpy()       # the step boundary: tokens to host

    @torch.inference_mode()
    def _prefill_logits_argmax(self, padded: np.ndarray, slot: int,
                               start: int) -> torch.Tensor:
        cache = {"layers": self.kv.layers,
                 "pages": self.kv.pages_dev()[slot:slot + 1],
                 "lens": torch.tensor([start], dtype=torch.int32,
                                      device=self.device)}
        logits, _ = apply_model(
            self.params, self.cfg,
            torch.from_numpy(padded).to(self.device), cache=cache)
        return torch.argmax(logits[..., :self.cfg.vocab_size], -1)

    def _runnable(self):
        """Decoding requests with a page for their next write, oldest
        first (growth may evict younger requests; a request that can
        neither grow nor evict stalls this step)."""
        out = []
        for req in sorted(self.sched.active(),
                          key=lambda r: (r.t_arrive, r.rid)):
            if req.state != DECODING:
                continue                     # evicted by an older peer
            if self.sched.ensure_page(req):
                out.append(req)
            else:
                self.counters["stalls"] += 1
        return out

    def _prefill_chunk(self, req: Request) -> None:
        """Run one fixed-shape prefill chunk for a PREFILLING request from
        its cursor ``n_cached``.  On the final chunk the request turns
        DECODING; a fresh request takes its first token from the last
        prompt position, a re-admitted one keeps the tokens it had."""
        stream = req.prefill_stream()
        target = req.prefill_target
        start = req.n_cached
        C = self.prefill_chunk
        chunk = stream[start:start + C]
        n = int(chunk.shape[0])
        padded = np.zeros((1, C), np.int32)
        padded[0, :n] = chunk
        toks = self._prefill_logits_argmax(padded, req.slot, start)
        req.n_cached = start + n
        self.kv.set_len(req.slot, req.n_cached)
        self.counters["prefill_chunks"] += 1
        self.counters["prefill_tokens"] += n
        if req.n_cached < target:
            return
        now = time.perf_counter()
        req.state = DECODING
        req.t_prefill_done = now
        self.counters["prefills"] += 1
        if not req.out:
            req.out = [int(toks[0, req.plen - 1 - start])]
            if req.t_first is None:
                req.t_first = now
        if req.done:
            self.sched.finish(req, now)

    # ---- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """Counters plus request-derived percentiles (numpy linear
        interpolation).  Latency and TPOT are over finished requests,
        TTFT over every request with a first token."""
        reqs = list(self.requests.values())
        fin = [r for r in reqs if r.state == FINISHED]
        lat = [r.t_finish - r.t_arrive for r in fin]
        ttft = [r.t_first - r.t_arrive for r in reqs
                if r.t_first is not None]
        tpot = [(r.t_finish - r.t_first) / (len(r.out) - 1) for r in fin
                if r.t_first is not None and len(r.out) > 1]
        m = dict(self.counters)
        m.update({
            "finished": len(fin),
            "admissions": self.sched.n_admissions,
            "evictions": self.sched.n_evictions,
            "occupancy": (m["occupancy_sum"] / m["steps"]
                          if m["steps"] else 0.0),
            "latency_p50_s": _percentile(lat, 50),
            "latency_p99_s": _percentile(lat, 99),
            "ttft_p50_s": _percentile(ttft, 50),
            "ttft_p99_s": _percentile(ttft, 99),
            "tpot_p50_s": _percentile(tpot, 50),
            "tpot_p99_s": _percentile(tpot, 99),
            "step_ms_p50": _percentile(self.step_ms, 50),
            "step_ms_p99": _percentile(self.step_ms, 99),
            "pages_free": self.kv.alloc.n_free_strict,
            "pages_held": self.kv.alloc.n_held,
            "kv_pool_bytes": self.kv.mem_bytes(),
            "kv_bytes_per_token": self.kv.kv_bytes_per_token(),
            "kv_capacity_tokens": (self.kv.n_pages - 1) * self.kv.page_size,
            "page_size": self.kv.page_size,
            "n_pages": self.kv.n_pages,
            "n_slots": self.kv.n_slots,
            "prefill_chunk": self.prefill_chunk,
            "mac_mode": self.cfg.mac.mode,
            "attention_backend": self.cfg.attention_backend,
            "device": str(self.device),
        })
        return m
