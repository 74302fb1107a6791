"""Allocator state-machine sanitizer: a shadow page ledger (port of
``repro/analysis/ledger.py``).

``attach_ledger(kv)`` wraps a ``PagedKVCache``'s mutating entry points
(and its allocator's) with a shadow replica of the page state machine::

    free ──alloc──▶ held (ref 1) ──retain──▶ shared (ref k)
      ▲                  │ free (ref→0)
      └──────────────────┴──▶ cached (LRU) ──alloc evicts──▶ held

Every operation is validated BEFORE the real one runs (a violation raises
``LedgerError`` with the allocator untouched), then the shadow is compared
against the allocator's real ``_free``/``_ref``/``_cached`` and the
conservation invariant is asserted::

    free_strict + held + cached == n_pages - 1    (page 0 is scratch)

Beyond the allocator lifecycle, the device-facing surface is policed:
``set_pages`` (KV scatter targets), ``set_len`` (gather window), and
``copy_page`` (COW) must only name pages the caller owns — catching
use-after-free / double-free / foreign-write bugs at the call that makes
them, not at the test that later reads garbage.

Opt-in: ``REPRO_SANITIZE=1`` (checked by ``Engine``), ``--sanitize`` on
``launch/serve.py``, or ``PagedKVCache(..., sanitize=True)`` directly.
The wrappers are pure host bookkeeping — no device work is added, and
nothing inside a captured CUDA graph calls the allocator: every page
transition and every ``set_pages``/``set_len``/``copy_page`` is a host
call between replays.
"""
from __future__ import annotations

import os
from typing import Dict, List, Set


class LedgerError(AssertionError):
    """A page-lifecycle invariant was violated (sanitizer finding)."""


def sanitize_enabled() -> bool:
    """True when the REPRO_SANITIZE env var opts into the shadow ledger."""
    return os.environ.get("REPRO_SANITIZE", "").lower() in (
        "1", "true", "yes", "on")


class PageLedger:
    """Shadow replica of a ``PageAllocator``'s page state machine.

    Mirrors the transitions of the real allocator (``_apply_*``) and
    cross-checks the full state after every outermost wrapped call
    (``verify``).  ``attach_ledger`` builds one and installs the method
    wrappers; the ledger itself never mutates the real allocator.
    """

    def __init__(self, alloc) -> None:
        self.alloc = alloc
        self.n_pages = int(alloc.n_pages)
        # shadow state, seeded from the allocator so mid-life attachment
        # works (page 0 scratch is excluded from all three partitions)
        self.free: Set[int] = set(alloc._free)
        self.ref: Dict[int, int] = dict(alloc._ref)
        self.cached: Set[int] = set(alloc._cached)
        self.cacheable: Set[int] = set(alloc._cacheable)
        self.ops = 0                     # validated operations
        self.checks = 0                  # full verify() passes
        self._depth = 0                  # reentrancy: verify outermost only

    # ---- failure -----------------------------------------------------------

    def _fail(self, msg: str) -> None:
        raise LedgerError(f"page ledger: {msg}")

    def _check_id(self, page: int, what: str) -> None:
        if not 1 <= page < self.n_pages:
            self._fail(f"{what} names page {page} outside the pool "
                       f"[1, {self.n_pages}) (page 0 is scratch)")

    # ---- shadow transitions (mirror PageAllocator semantics) ---------------

    def apply_alloc(self, pages: List[int]) -> None:
        for p in pages:
            self._check_id(p, "alloc")
            if p in self.free:
                self.free.discard(p)
            elif p in self.cached:       # LRU eviction path
                self.cached.discard(p)
                self.cacheable.discard(p)
            elif p in self.ref:
                self._fail(f"alloc handed out page {p} still held "
                           f"(ref {self.ref[p]})")
            else:
                self._fail(f"alloc handed out untracked page {p}")
            self.ref[p] = 1

    def apply_retain(self, page: int) -> None:
        self._check_id(page, "retain")
        if page in self.cached:          # revive from the LRU tier
            self.cached.discard(page)
            self.ref[page] = 1
            return
        if self.ref.get(page, 0) < 1:
            self._fail(f"retain of unheld page {page} "
                       "(free pages must go through alloc)")
        self.ref[page] += 1

    def apply_free(self, pages: List[int]) -> None:
        # validate the whole batch against a scratch copy first, so a
        # rejected free leaves the shadow (like the allocator) untouched
        ref = dict(self.ref)
        for p in reversed(pages):
            self._check_id(p, "free")
            if ref.get(p, 0) < 1:
                state = ("cached" if p in self.cached
                         else "free" if p in self.free else "untracked")
                self._fail(f"double/foreign free of page {p} "
                           f"(shadow state: {state})")
            ref[p] -= 1
        for p in reversed(pages):
            self.ref[p] -= 1
            if self.ref[p] == 0:
                del self.ref[p]
                if p in self.cacheable:
                    self.cached.add(p)
                else:
                    self.free.add(p)

    def apply_mark_cached(self, page: int) -> None:
        self._check_id(page, "mark_cached")
        self.cacheable.add(page)

    def apply_unmark_cached(self, page: int) -> None:
        self.cacheable.discard(page)
        if page in self.cached:
            self.cached.discard(page)
            self.free.add(page)

    # ---- device-surface validation (no state change) -----------------------

    def check_set_pages(self, pages: List[int]) -> None:
        for p in pages:
            if p == 0:
                continue                 # explicit scratch entries are fine
            self._check_id(p, "set_pages")
            if self.ref.get(p, 0) < 1:
                state = ("cached" if p in self.cached
                         else "free" if p in self.free else "untracked")
                self._fail(f"set_pages maps page {p} into a slot table but "
                           f"the slot does not own it (shadow: {state}) — "
                           "scatter would write another sequence's memory")

    def check_set_len(self, n: int, n_pages_set: int, page_size: int) -> None:
        if n < 0:
            self._fail(f"set_len to negative length {n}")
        if n > n_pages_set * page_size:
            self._fail(
                f"set_len to {n} tokens but the slot's page table holds "
                f"only {n_pages_set} pages ({n_pages_set * page_size} "
                "tokens) — gather would read the scratch page as data")

    def check_copy_page(self, src: int, dst: int) -> None:
        self._check_id(src, "copy_page src")
        self._check_id(dst, "copy_page dst")
        if self.ref.get(dst, 0) < 1:
            state = ("cached" if dst in self.cached
                     else "free" if dst in self.free else "untracked")
            self._fail(f"COW copy into page {dst} nobody owns "
                       f"(shadow: {state})")
        if self.ref.get(src, 0) < 1 and src not in self.cached:
            self._fail(f"COW copy from page {src} that is neither held "
                       "nor cached — contents are undefined")

    # ---- cross-check against the real allocator ----------------------------

    def verify(self) -> None:
        """Shadow == real, plus conservation.  Called after every
        outermost wrapped operation and once per engine step."""
        al = self.alloc
        if self.free != set(al._free):
            self._fail(f"free-list divergence: shadow {sorted(self.free)} "
                       f"vs allocator {sorted(al._free)}")
        if self.ref != al._ref:
            self._fail(f"refcount divergence: shadow {self.ref} "
                       f"vs allocator {dict(al._ref)}")
        if self.cached != set(al._cached):
            self._fail(f"cached-tier divergence: shadow "
                       f"{sorted(self.cached)} vs allocator "
                       f"{sorted(al._cached)}")
        n = len(self.free) + len(self.ref) + len(self.cached)
        if n != self.n_pages - 1:
            self._fail(
                f"conservation violated: free {len(self.free)} + held "
                f"{len(self.ref)} + cached {len(self.cached)} = {n} "
                f"!= n_pages - 1 = {self.n_pages - 1}")
        if (self.free & self.cached) or (self.free & set(self.ref)) \
                or (self.cached & set(self.ref)):
            self._fail("free/held/cached partitions overlap")
        self.checks += 1


def attach_ledger(kv) -> PageLedger:
    """Install a shadow ledger on a ``PagedKVCache`` (duck-typed: anything
    with ``alloc``/``ptab``/``page_size`` and the same method surface).

    Wrappers are instance attributes, so every caller holding the same
    allocator object (scheduler, prefix index via ``on_evict``) goes
    through them; nested calls (eviction inside ``alloc``) update the
    shadow but defer the full cross-check to the outermost call.
    """
    led = PageLedger(kv.alloc)
    al = kv.alloc

    def outermost(fn):
        def run(*a, **kw):
            led._depth += 1
            try:
                out = fn(*a, **kw)
            finally:
                led._depth -= 1
            if led._depth == 0:
                led.verify()
            led.ops += 1
            return out
        return run

    o_alloc, o_retain, o_free = al.alloc, al.retain, al.free
    o_mark, o_unmark = al.mark_cached, al.unmark_cached

    @outermost
    def alloc(n):
        pages = o_alloc(n)
        if pages is not None:
            led.apply_alloc(pages)
        return pages

    @outermost
    def retain(page):
        led.apply_retain(page)
        return o_retain(page)

    @outermost
    def free(pages):
        led.apply_free(pages)
        return o_free(pages)

    @outermost
    def mark_cached(page):
        led.apply_mark_cached(page)
        return o_mark(page)

    @outermost
    def unmark_cached(page):
        led.apply_unmark_cached(page)
        return o_unmark(page)

    al.alloc, al.retain, al.free = alloc, retain, free
    al.mark_cached, al.unmark_cached = mark_cached, unmark_cached

    o_set_pages, o_set_len = kv.set_pages, kv.set_len
    o_copy = kv.copy_page

    @outermost
    def set_pages(slot, pages):
        led.check_set_pages(list(pages))
        return o_set_pages(slot, pages)

    @outermost
    def set_len(slot, n):
        import numpy as np
        n_set = int(np.count_nonzero(kv.ptab[slot]))
        led.check_set_len(int(n), n_set, kv.page_size)
        return o_set_len(slot, n)

    @outermost
    def copy_page(src, dst):
        led.check_copy_page(int(src), int(dst))
        return o_copy(src, dst)

    kv.set_pages, kv.set_len, kv.copy_page = set_pages, set_len, copy_page
    kv.ledger = led
    return led
