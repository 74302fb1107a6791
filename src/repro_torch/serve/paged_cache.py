"""Host-side paged-KV management (port of ``repro/serve/paged_cache.py``):
the refcounted page allocator, the prefix index and the device-pool
wrapper.

  * ``PageAllocator`` — refcounted allocation over pool page ids with an
    LRU *cached* tier: a page whose refcount drops to zero while the
    prefix index holds its contents parks there, reusable but evictable.
    Page 0 is the reserved scratch page, so ids handed out are in
    ``[1, n_pages)``.
  * ``PrefixIndex`` — maps hash-chained full pages of prompt tokens to the
    pool page holding their K/V, so admission can map cached prefix pages
    into a new request's page table and skip prefilling those tokens.
  * ``PagedKVCache`` — the device pools plus per-slot page tables and
    lengths (numpy, written by the scheduler and copied into static device
    buffers before each step).  Under a data axis every rank keeps the
    whole allocator, index and tables and a data row reads its slots'
    rows (``rows_view``).
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import init_paged_cache, supports_paged_cache


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold n_tokens (at least one)."""
    return max(1, math.ceil(n_tokens / page_size))


class PageAllocator:
    """Refcounted LIFO allocator over pool pages [1, n_pages).

    ``alloc`` is all-or-nothing (None when the request can't be covered)
    and consumes free pages before evicting cached ones; ``free`` parks a
    page that reaches refcount 0 in the cached LRU if it was marked
    cacheable, else returns it to the free list."""

    def __init__(self, n_pages: int,
                 on_evict: Optional[Callable[[int], None]] = None):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.n_pages = n_pages
        self.on_evict = on_evict
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._cacheable = set()

    def state(self) -> tuple:
        """The whole allocator state: free list, refcounts, cached LRU
        order and cacheable pages (equal on every rank of a mesh)."""
        return (list(self._free), sorted(self._ref.items()),
                list(self._cached), sorted(self._cacheable))

    @property
    def n_free(self) -> int:
        """Allocatable pages: truly free + evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def n_free_strict(self) -> int:
        return len(self._free)

    @property
    def n_held(self) -> int:
        return len(self._ref)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= self.n_free

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > self.n_free:
            return None
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:                           # evict LRU cached page
                p, _ = self._cached.popitem(last=False)
                self._cacheable.discard(p)
                if self.on_evict is not None:
                    self.on_evict(p)
            self._ref[p] = 1
            out.append(p)
        return out

    def retain(self, page: int) -> None:
        """Add a reference: share a held page, or revive a cached one."""
        if page in self._cached:
            del self._cached[page]
            self._ref[page] = 1
            return
        if self._ref.get(page, 0) < 1:
            raise ValueError(f"retain of unheld page {page}")
        self._ref[page] += 1

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page, in reverse argument order (chain
        tails park in the LRU before heads)."""
        for p in reversed(pages):
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"double/foreign free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                if p in self._cacheable:
                    self._cached[p] = None
                else:
                    self._free.append(p)

    def mark_cached(self, page: int) -> None:
        self._cacheable.add(page)

    def unmark_cached(self, page: int) -> None:
        self._cacheable.discard(page)
        if page in self._cached:
            del self._cached[page]
            self._free.append(page)


class PrefixIndex:
    """Host-side prefix cache: full immutable pages of prompt tokens,
    keyed by a hash chain, mapped to the pool page holding their K/V.

    The chain key of page ``i`` is a SHA-256 digest over the parent digest
    and the page's raw int32 token bytes, so it commits to every token of
    pages ``0..i`` and is the same in every process.  ``match`` retains
    every page it returns (the caller frees them through the allocator)
    and always leaves at least one token unmatched, so the logits that
    seed decoding are recomputed."""

    WINDOW = 32                                 # admissions per hit window

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = page_size
        self._pages: Dict[bytes, int] = {}      # chain digest → page id
        self._keys: Dict[int, bytes] = {}       # page id → chain digest
        alloc.on_evict = self.drop_page
        self.hit_tokens = 0
        self.lookup_tokens = 0
        # (hit, lookup) token pairs of the latest admissions
        self._recent: "deque[tuple]" = deque(maxlen=self.WINDOW)

    def __len__(self) -> int:
        return len(self._pages)

    def chain_keys(self, tokens: np.ndarray) -> List[bytes]:
        """Chain digest of each full page of ``tokens`` (callers memoize it
        per request)."""
        ps = self.page_size
        keys: List[bytes] = []
        h = b""
        for i in range(len(tokens) // ps):
            blk = np.asarray(tokens[i * ps:(i + 1) * ps], np.int32).tobytes()
            h = hashlib.sha256(h + blk).digest()
            keys.append(h)
        return keys

    def match(self, tokens: np.ndarray, n_target: Optional[int] = None,
              keys: Optional[List[bytes]] = None) -> List[int]:
        """Longest cached page-chain prefix of ``tokens``, capped so at
        least one of the first ``n_target`` (default ``len(tokens)``)
        tokens remains to prefill.  Every returned page is retained; the
        hit counters are left to ``record``."""
        n_target = len(tokens) if n_target is None else n_target
        cap = max(0, (n_target - 1) // self.page_size)
        if keys is None:
            keys = self.chain_keys(tokens)
        out: List[int] = []
        for i, key in enumerate(keys):
            if i >= cap:
                break
            page = self._pages.get(key)
            if page is None:
                break
            self.alloc.retain(page)
            out.append(page)
        return out

    def record(self, n_hit_pages: int, n_target: int) -> None:
        """Commit one admission's hit and lookup token counts."""
        self.lookup_tokens += n_target
        self.hit_tokens += n_hit_pages * self.page_size
        self._recent.append((n_hit_pages * self.page_size, n_target))

    def insert(self, tokens: np.ndarray, pages: List[int],
               keys: Optional[List[bytes]] = None) -> int:
        """Register the full-page prefix of ``tokens`` held in ``pages``;
        the first writer of a key wins.  Returns the pages newly indexed."""
        added = 0
        if keys is None:
            keys = self.chain_keys(tokens)
        for i, key in enumerate(keys):
            if i >= len(pages):
                break
            if key in self._pages:
                continue
            page = pages[i]
            if page in self._keys:          # page already backs another key
                continue
            self._pages[key] = page
            self._keys[page] = key
            self.alloc.mark_cached(page)
            added += 1
        return added

    def drop_page(self, page: int) -> None:
        key = self._keys.pop(page, None)
        if key is not None:
            self._pages.pop(key, None)
        self.alloc.unmark_cached(page)

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0

    @property
    def windowed_hit_rate(self) -> float:
        """Hit rate over the last ``WINDOW`` admissions only."""
        lookup = sum(n for _, n in self._recent)
        return sum(h for h, _ in self._recent) / lookup if lookup else 0.0


class PagedKVCache:
    """Device page pools + host page tables for a fixed slot count.

    ``layers`` holds the per-layer pools, written in place by every step
    and never replaced (a captured CUDA graph holds their addresses);
    ``ptab``/``lens`` are numpy, written by the scheduler and copied by
    each step into its own device buffer with its other inputs
    (``serve/graphs.py:Step``).  Unassigned table entries stay 0 →
    scratch page.

    ``sanitize=True`` attaches the shadow page ledger
    (``repro_torch.analysis.ledger``): every allocator transition and
    every ``set_pages``/``set_len``/``copy_page`` call is validated
    against the page state machine and conservation is asserted after
    each operation.  Host-only overhead; the ``Engine`` enables it from
    ``REPRO_SANITIZE=1`` / ``--sanitize``."""

    def __init__(self, cfg, n_slots: int, n_pages: int, page_size: int,
                 max_seq_pages: int, *, device=None, sanitize: bool = False):
        if not supports_paged_cache(cfg):
            raise ValueError(f"arch {cfg.arch!r} has no paged-cache support")
        self.cfg = cfg
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_seq_pages = min(max_seq_pages, n_pages - 1)
        self.layers = init_paged_cache(cfg, n_pages, page_size,
                                       device=device)["layers"]
        self.device = self.layers[0]["pool_k"].device
        self.alloc = PageAllocator(n_pages)
        self.ptab = np.zeros((n_slots, self.max_seq_pages), np.int32)
        self.lens = np.zeros((n_slots,), np.int32)
        self.ledger = None
        if sanitize:
            from repro_torch.analysis.ledger import attach_ledger
            attach_ledger(self)          # sets self.ledger

    @property
    def max_seq_tokens(self) -> int:
        return self.max_seq_pages * self.page_size

    def set_pages(self, slot: int, pages: List[int]) -> None:
        row = np.zeros((self.max_seq_pages,), np.int32)
        row[:len(pages)] = pages
        self.ptab[slot] = row

    def set_len(self, slot: int, n: int) -> None:
        self.lens[slot] = n

    def rows_view(self, lo: int, hi: int) -> tuple:
        """A data row's view of the page table and lens: the rows of its
        slots ``[lo, hi)`` (numpy views; the scheduler writes the whole
        arrays)."""
        return self.ptab[lo:hi], self.lens[lo:hi]

    def reset_slot(self, slot: int) -> None:
        self.ptab[slot] = 0
        self.lens[slot] = 0

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write support: duplicate one pool page in place, in
        every layer's k and v pools and, for quantized pools, their scale
        rows (page axis first in all of them).  No tensor is replaced."""
        for st in self.layers:
            for t in st.values():
                t[dst].copy_(t[src])

    def pool_bytes(self) -> int:
        """Device pool bytes: every layer's k and v value pools and, for
        int8/int4, their f32 scale side pools."""
        return sum(t.numel() * t.element_size()
                   for st in self.layers for t in st.values())

    def mem_bytes(self) -> int:
        """Pool bytes plus the host page-table/lens buffers mirrored to
        the device each step."""
        return self.pool_bytes() + self.ptab.nbytes + self.lens.nbytes

    def kv_bytes_per_token(self) -> float:
        """Pool bytes one cached token costs across all layers: value
        bytes plus, for int8/int4, its f32 scale rows."""
        return self.pool_bytes() / (self.n_pages * self.page_size)
