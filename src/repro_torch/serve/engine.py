"""Continuous-batching greedy ``Engine`` over the paged KV cache (port of
``Engine`` from ``repro/serve/engine.py``, with its prefix cache and
speculative decoding; telemetry, mesh and sanitizer wait).

A scheduler admits queued requests into a fixed number of slots under a
page budget; each engine step runs one prefill chunk per prefilling slot
(``(1, prefill_chunk)`` tokens, right-padded) and then one decode step for
all ``n_slots`` rows, whatever each request's progress (or, with
``spec_decode=k``, one draft + verify round).  The page pools are updated
in place by every step.

Every step the reference jits runs here as one captured CUDA graph on the
card (``serve/graphs.py``): the prefill chunk, the decode step, the k
unrolled draft steps and the verify forward, one graph per shape.
"""
from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.macexec import check_drafter
from repro_torch.models import apply_model, supports_paged_cache
from repro_torch.models.lm import paged_cache_layout
from .graphs import Step
from .paged_cache import PagedKVCache
from .scheduler import DECODING, FINISHED, Request, Scheduler
from .spec import greedy_accept, make_spec_draft, make_spec_verify


def _percentile(xs, q: float) -> float:
    """numpy's linear-interpolation percentile; NaN on an empty sample."""
    return float(np.percentile(xs, q)) if len(xs) else float("nan")


def make_paged_prefill(cfg):
    """Prefill one right-padded token chunk (1, C) into its pages from
    offset ``lens`` (0 for a fresh slot; the cached tokens for a later
    chunk or after a prefix-cache hit).  Returns the greedy token at every
    position (1, C) int32; the pools are written in place."""
    def prefill(params, layers, tokens, pages, lens):
        cache = {"layers": layers, "pages": pages, "lens": lens}
        logits, _ = apply_model(params, cfg, tokens, cache=cache)
        return torch.argmax(logits[..., :cfg.vocab_size],
                            dim=-1).to(torch.int32)
    return prefill


def make_paged_decode_step(cfg):
    """One greedy token (B,) int32 for every slot against the shared page
    pools."""
    def step(params, layers, tokens, pages, lens):
        cache = {"layers": layers, "pages": pages, "lens": lens}
        logits, _ = apply_model(params, cfg, tokens, cache=cache)
        return torch.argmax(logits[:, -1, :cfg.vocab_size],
                            dim=-1).to(torch.int32)
    return step


class Engine:
    """Continuous-batching greedy serving engine over the paged KV cache.

    ``reserve='conservative'`` admits a request only when pages for
    prompt+max_new are free; ``'optimistic'`` admits on prompt pages alone
    and grows page by page, evicting the youngest running request on
    exhaustion (its generated tokens are kept and re-prefilled).

    ``prefix_cache=True``: full prompt pages are hash-indexed after
    prefill, and admission maps matching cached pages into a new request's
    table (refcount-shared, copied on write), so only the uncached suffix
    is prefilled.

    ``spec_decode=k`` (k >= 1): each decode round drafts k greedy tokens
    per slot with ``draft_params``/``draft_cfg`` (default: the serving
    params) in one step, verifies all k+1 positions in one batched forward
    over the same pools and commits the longest agreeing prefix plus a
    bonus token.  Greedy output is token-identical to ``spec_decode=0``
    for any drafter; build a cheap one with
    ``repro_torch.serve.encoded.prepare_drafter``.

    ``cuda_graphs``: None (default) captures every step into a CUDA graph
    when the engine runs on the card; False runs the same step functions
    eagerly; True on the CPU raises.  ``stats()["jit_compiles"]`` counts
    the graphs this engine captured (each after one eager warm-up run of
    its step, whose kernel launches count as any other).

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    PyTorch versions.  ``params`` must already live on that device."""

    def __init__(self, params, cfg, *, n_slots: int = 4,
                 page_size: int = 16, n_pages: int = 128,
                 max_seq_pages: Optional[int] = None,
                 reserve: str = "conservative", prefill_chunk: int = 32,
                 prefix_cache: bool = False, spec_decode: int = 0,
                 draft_params=None, draft_cfg=None, device=None,
                 cuda_graphs: Optional[bool] = None):
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
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError("cuda_graphs=True needs the card; the engine "
                             f"runs on {self.device}")
        self.cuda_graphs = bool(cuda_graphs)
        self.sched = Scheduler(self.kv, reserve=reserve,
                               prefix_cache=prefix_cache)
        self.spec_k = int(spec_decode)
        if self.spec_k < 0:
            raise ValueError("spec_decode must be >= 0")
        step = functools.partial(Step, device=self.device,
                                 graphs=self.cuda_graphs)
        # the step functions by name, each one graph per engine on the card
        self.steps = {
            "prefill": step("prefill", functools.partial(
                make_paged_prefill(cfg), params, self.kv.layers)),
            "decode": step("decode", functools.partial(
                make_paged_decode_step(cfg), params, self.kv.layers))}
        if self.spec_k:
            self.draft_cfg = draft_cfg if draft_cfg is not None else cfg
            self.draft_params = (draft_params if draft_params is not None
                                 else params)
            check_drafter(self.draft_params, self.draft_cfg.mac.mode)
            # the drafter writes into the verifier's pools, so its paged
            # cache geometry must match exactly
            if (paged_cache_layout(self.draft_cfg, 2, page_size)
                    != paged_cache_layout(cfg, 2, page_size)):
                raise ValueError(
                    "spec_decode drafter cache geometry mismatch: "
                    "draft_cfg must produce the same paged KV layout "
                    "(layers/kv-heads/head-dim/dtype) as the serving cfg")
            self.steps["draft"] = step("draft", functools.partial(
                make_spec_draft(self.draft_cfg, self.spec_k),
                self.draft_params, self.kv.layers))
            self.steps["verify"] = step("verify", functools.partial(
                make_spec_verify(cfg, self.spec_k), params, self.kv.layers))
        self.requests = {}
        self._next_rid = 0
        self.clock = 0
        self.counters = {"steps": 0, "decode_steps": 0, "decode_tokens": 0,
                         "prefill_tokens": 0, "prefills": 0,
                         "prefill_chunks": 0, "occupancy_sum": 0.0,
                         "stalls": 0, "rejects": 0, "spec_rounds": 0,
                         "spec_draft_tokens": 0, "spec_accepted_tokens": 0}
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
        if self.spec_k:
            self._spec_round(chunked)
            return
        active = self._runnable()
        worked = set(chunked) | {r.rid for r in active}
        self.counters["occupancy_sum"] += len(worked) / self.kv.n_slots
        if not active:
            self._check_progress(chunked)
            return
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
        out = self.steps["decode"](tokens, self.kv.ptab, self.kv.lens)
        toks = out.cpu().numpy()         # the step boundary: tokens to host
        self.counters["decode_steps"] += 1
        now = time.perf_counter()
        for req in active:
            req.n_cached += 1
            req.out.append(int(toks[req.slot]))
            self.counters["decode_tokens"] += 1
            if req.done:
                self.sched.finish(req, now)

    def _check_progress(self, chunked) -> None:
        """No request decodes this step: fine while prefill progresses or
        nothing waits; a queued request that no pool could hold raises."""
        if chunked or not self.sched.queue:
            return
        raise RuntimeError(
            "page pool too small for the queued request "
            f"(need {self.sched._pages_needed(self.sched.queue[0])}"
            f" pages, {self.kv.alloc.n_free} free)")

    def _spec_round(self, chunked) -> None:
        """One speculative draft + verify round (the reference's
        ``Engine._spec_round``).

        Each active slot secures a write window of ``min(k+1, tokens
        left)`` positions it owns alone (``ensure_write_window``; on
        failure a window of 1, else it stalls); the drafter drafts k
        tokens (one step), the verifier scores the k+1 positions (one
        step, reading the draft on the device) and the longest agreeing
        prefix plus the bonus token is committed, capped at the window:
        logits past it may have read scratch.  Rejected positions are
        rolled back by host arithmetic on ``n_cached``.  Slotted requests
        that do not decode get lens at the end of their own pages, so the
        round's k+1 writes land in the scratch page."""
        k = self.spec_k
        active, wins = [], {}
        for req in sorted(self.sched.active(),
                          key=lambda r: (r.t_arrive, r.rid)):
            if req.state != DECODING:
                continue                    # evicted mid-loop by a peer
            want = min(k + 1, req.max_new - len(req.out))
            if self.sched.ensure_write_window(req, want):
                wins[req.rid] = want
            elif want > 1 and self.sched.ensure_write_window(req, 1):
                wins[req.rid] = 1
            else:
                self.counters["stalls"] += 1
                continue
            active.append(req)
        active = [r for r in active if r.state == DECODING]  # late evicts
        worked = set(chunked) | {r.rid for r in active}
        self.counters["occupancy_sum"] += len(worked) / self.kv.n_slots
        if not active:
            self._check_progress(chunked)
            return
        act = {r.rid for r in active}
        for r in self.sched.slots:
            if r is None:
                continue
            if r.rid in act:
                self.kv.set_len(r.slot, r.n_cached)
            else:
                self.kv.set_len(r.slot, len(r.pages) * self.kv.page_size)
        tokens = np.zeros((self.kv.n_slots, 1), np.int32)
        for req in active:
            tokens[req.slot, 0] = req.out[-1]
        draft, verify = self.steps["draft"], self.steps["verify"]
        d_toks = draft(tokens, self.kv.ptab, self.kv.lens)
        # the draft stays on the device: verify reads it, the round's
        # input tokens, page table and lens from the draft step's own
        # tensors, so draft → verify needs no copy and no host sync
        v_toks = verify(draft.arg(0), d_toks, draft.arg(1), draft.arg(2))
        d_np, v_np = d_toks.cpu().numpy(), v_toks.cpu().numpy()
        now = time.perf_counter()
        r_acc = r_cons = 0
        for req in active:
            cons = min(k, wins[req.rid] - 1)   # draft tokens we may trust
            d, v = d_np[req.slot], v_np[req.slot]
            n_acc = greedy_accept(d[:cons], v[:cons])
            emit = [int(x) for x in d[:n_acc]] + [int(v[n_acc])]
            emit = emit[:req.max_new - len(req.out)]
            if req.eos_id is not None:
                for j, t in enumerate(emit):
                    if t == req.eos_id:
                        emit = emit[:j + 1]
                        break
            req.out.extend(emit)
            req.n_cached += len(emit)
            self.counters["decode_tokens"] += len(emit)
            r_acc += n_acc
            r_cons += cons
            if req.done:
                self.sched.finish(req, now)
        self.counters["spec_rounds"] += 1
        self.counters["spec_draft_tokens"] += r_cons
        self.counters["spec_accepted_tokens"] += r_acc

    def _runnable(self):
        """Decoding requests with a page of their own for their next
        write, oldest first (growth may evict younger requests; a request
        that can neither grow nor evict stalls this step)."""
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
        its cursor ``n_cached`` (past the mapped pages after a prefix-cache
        hit).  On the final chunk the request turns DECODING and its prompt
        pages enter the prefix index; a fresh request takes its first token
        from the last prompt position, a re-admitted one keeps the tokens
        it had."""
        stream = req.prefill_stream()
        target = req.prefill_target
        start = req.n_cached
        C = self.prefill_chunk
        chunk = stream[start:start + C]
        n = int(chunk.shape[0])
        padded = np.zeros((1, C), np.int32)
        padded[0, :n] = chunk
        toks = self.steps["prefill"](
            padded, self.kv.ptab[req.slot:req.slot + 1],
            np.array([start], np.int32))
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
        self.sched.note_prefilled(req)
        if not req.out:
            # read before the next prefill replay overwrites the graph's
            # output
            req.out = [int(toks[0, req.plen - 1 - start])]
            if req.t_first is None:
                req.t_first = now
        if req.done:
            self.sched.finish(req, now)

    # ---- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """Counters plus request-derived percentiles (numpy linear
        interpolation), with the reference's prefix-cache, copy-on-write
        and speculative keys.  Latency and TPOT are over finished
        requests, TTFT over every request with a first token."""
        reqs = list(self.requests.values())
        fin = [r for r in reqs if r.state == FINISHED]
        lat = [r.t_finish - r.t_arrive for r in fin]
        ttft = [r.t_first - r.t_arrive for r in reqs
                if r.t_first is not None]
        tpot = [(r.t_finish - r.t_first) / (len(r.out) - 1) for r in fin
                if r.t_first is not None and len(r.out) > 1]
        pfx = self.sched.prefix
        on = pfx is not None        # NOT truthiness: an empty index is falsy
        m = dict(self.counters)
        m.update({
            "finished": len(fin),
            "admissions": self.sched.n_admissions,
            "evictions": self.sched.n_evictions,
            "cow_copies": self.sched.n_cow_copies,
            "prefix_cache": on,
            "prefix_hit_tokens": pfx.hit_tokens if on else 0,
            "prefix_lookup_tokens": pfx.lookup_tokens if on else 0,
            "prefix_hit_rate": pfx.hit_rate if on else 0.0,
            "prefix_windowed_hit_rate": pfx.windowed_hit_rate if on else 0.0,
            "prefix_pages_indexed": len(pfx) if on else 0,
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
            "pages_cached": self.kv.alloc.n_cached,
            "pages_held": self.kv.alloc.n_held,
            "kv_pool_bytes": self.kv.mem_bytes(),
            "kv_bytes_per_token": self.kv.kv_bytes_per_token(),
            "kv_capacity_tokens": (self.kv.n_pages - 1) * self.kv.page_size,
            "kv_cache_dtype": self.cfg.kv_cache_dtype,
            "page_size": self.kv.page_size,
            "n_pages": self.kv.n_pages,
            "n_slots": self.kv.n_slots,
            "prefill_chunk": self.prefill_chunk,
            "mac_mode": self.cfg.mac.mode,
            "attention_backend": self.cfg.attention_backend,
            "device": str(self.device),
            "cuda_graphs": self.cuda_graphs,
            "jit_compiles": sum(s.captures for s in self.steps.values()),
            "jit_compiles_by_step": {n: s.captures
                                     for n, s in self.steps.items()},
        })
        if self.spec_k:
            rounds, prop = m["spec_rounds"], m["spec_draft_tokens"]
            m.update({
                "spec_decode_k": self.spec_k,
                "spec_acceptance_rate": (m["spec_accepted_tokens"] / prop
                                         if prop else 0.0),
                "spec_tokens_per_round": (m["decode_tokens"] / rounds
                                          if rounds else 0.0),
                "draft_mac_mode": self.draft_cfg.mac.mode,
            })
        return m
