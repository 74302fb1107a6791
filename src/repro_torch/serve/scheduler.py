"""Continuous-batching scheduler (port of ``repro/serve/scheduler.py``
without the prefix index): request queue, FCFS admission under a page
budget, page growth with eviction by recompute.

Request states::

    queued → prefilling → decoding → finished
                 ↑____________|  (evicted: pages freed, requeued at the
                                  front; generated tokens are KEPT and
                                  re-prefilled on re-admission)

Reservation policy: ``conservative`` reserves pages for ``len(prompt) +
max_new`` at admission; ``optimistic`` reserves only the pages of the
tokens that must be cached and grows page by page during decode, evicting
the youngest other running request on exhaustion.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from .paged_cache import PagedKVCache, pages_for

QUEUED, PREFILLING, DECODING, FINISHED, EVICTED = (
    "queued", "prefilling", "decoding", "finished", "evicted")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (plen,) int32
    max_new: int = 32
    eos_id: Optional[int] = None
    state: str = QUEUED
    slot: Optional[int] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    out: List[int] = dataclasses.field(default_factory=list)
    n_cached: int = 0                  # tokens with KV in the pool
    n_evictions: int = 0
    t_arrive: float = 0.0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_prefill_done: Optional[float] = None
    t_finish: Optional[float] = None

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefill_target(self) -> int:
        """Tokens that must be in the pool before decode (re)starts: the
        prompt plus every generated token except the last."""
        return self.plen + max(0, len(self.out) - 1)

    def prefill_stream(self) -> np.ndarray:
        """The token stream prefill ingests (prompt, then any generated
        tokens an eviction preserved, minus the final one)."""
        if not self.out:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out[:-1], np.int32)])

    @property
    def done(self) -> bool:
        return (len(self.out) >= self.max_new
                or (self.eos_id is not None and len(self.out) > 0
                    and self.out[-1] == self.eos_id))


class Scheduler:
    """FCFS continuous-batching scheduler over a PagedKVCache."""

    def __init__(self, kv: PagedKVCache, reserve: str = "conservative"):
        if reserve not in ("conservative", "optimistic"):
            raise ValueError(f"unknown reserve policy {reserve!r}")
        self.kv = kv
        self.reserve = reserve
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * kv.n_slots
        self.n_evictions = 0
        self.n_admissions = 0

    def submit(self, req: Request) -> None:
        max_tokens = self.kv.max_seq_tokens
        if req.plen + req.max_new > max_tokens:
            raise ValueError(
                f"request {req.rid}: {req.plen}+{req.max_new} tokens exceed "
                f"the {max_tokens}-token per-sequence page table")
        req.state = QUEUED
        self.queue.append(req)

    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None and r.state == DECODING]

    def prefilling(self) -> List[Request]:
        return [r for r in self.slots
                if r is not None and r.state == PREFILLING]

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def _pages_needed(self, req: Request) -> int:
        if self.reserve == "conservative":
            return pages_for(req.plen + req.max_new, self.kv.page_size)
        return pages_for(req.prefill_target, self.kv.page_size)

    def admissions(self) -> List[Tuple[int, Request]]:
        """Admit queued requests into free slots while pages last (FCFS,
        head-of-line blocking)."""
        out = []
        free = [i for i, r in enumerate(self.slots) if r is None]
        while self.queue and free:
            req = self.queue[0]
            pages = self.kv.alloc.alloc(self._pages_needed(req))
            if pages is None:
                break                        # head-of-line: wait for pages
            self.queue.popleft()
            slot = free.pop(0)
            req.slot, req.state = slot, PREFILLING
            req.pages = pages
            req.n_cached = 0
            req.t_admit = time.perf_counter()
            self.slots[slot] = req
            self.kv.set_pages(slot, req.pages)
            self.kv.set_len(slot, req.n_cached)
            self.n_admissions += 1
            out.append((slot, req))
        return out

    def ensure_page(self, req: Request) -> bool:
        """Make sure the page for the next write position exists, growing
        by one page (reclaiming cached pages, then evicting a strictly
        younger running request).  False → no page and no younger victim:
        ``req`` keeps its pages and stalls this step.  (Without the prefix
        index no page is ever shared, so no copy-on-write is needed.)"""
        ps = self.kv.page_size
        while req.n_cached >= len(req.pages) * ps:
            grown = self._alloc_or_evict(req, 1)
            if grown is None:
                return False
            req.pages.extend(grown)
            self.kv.set_pages(req.slot, req.pages)
        return True

    def _alloc_or_evict(self, req: Request, n: int) -> Optional[List[int]]:
        while True:
            got = self.kv.alloc.alloc(n)
            if got is not None:
                return got
            victim = self._pick_victim(req)
            if victim is not None:
                self.evict(victim)
                continue
            if all(r is None or r is req for r in self.slots):
                raise RuntimeError(
                    f"page pool exhausted by request {req.rid} alone "
                    f"({len(req.pages)} pages); increase n_pages or use "
                    f"reserve='conservative'")
            return None

    def _pick_victim(self, requesting: Request) -> Optional[Request]:
        """Youngest running request strictly younger than ``requesting``."""
        cands = [r for r in self.slots
                 if r is not None and r is not requesting
                 and (r.t_arrive, r.rid) > (requesting.t_arrive,
                                            requesting.rid)]
        if not cands:
            return None
        return max(cands, key=lambda r: (r.t_arrive, r.rid))

    def evict(self, req: Request) -> None:
        """Free a running request's pages and requeue it at the front;
        its generated tokens are kept and re-prefilled on re-admission."""
        self.kv.reset_slot(req.slot)
        self.slots[req.slot] = None
        self.kv.alloc.free(req.pages)
        req.pages, req.slot = [], None
        req.n_cached = 0
        req.state = QUEUED
        req.n_evictions += 1
        self.n_evictions += 1
        self.queue.appendleft(req)

    def finish(self, req: Request, t: float) -> None:
        self.kv.reset_slot(req.slot)
        self.slots[req.slot] = None
        self.kv.alloc.free(req.pages)
        req.pages, req.slot = [], None
        req.state = FINISHED
        req.t_finish = t
