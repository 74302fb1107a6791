"""Host-side paged-KV management (port of ``repro/serve/paged_cache.py``):
the refcounted page allocator and the device-pool wrapper.

  * ``PageAllocator`` — refcounted allocation over pool page ids with an
    LRU *cached* tier (the prefix index's parking lot; its state machine
    is kept whole even though the prefix index itself is not ported yet).
    Page 0 is the reserved scratch page, so ids handed out are in
    ``[1, n_pages)``.
  * ``PagedKVCache`` — the device pools plus per-slot page tables and
    lengths (numpy, mirrored to the device each engine step).
"""
from __future__ import annotations

import math
from collections import OrderedDict
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


class PagedKVCache:
    """Device page pools + host page tables for a fixed slot count.

    ``layers`` holds the per-layer pools, written in place by every
    prefill and decode step; ``ptab``/``lens`` are numpy, written by the
    scheduler and uploaded as small int32 tensors each step.  Unassigned
    table entries stay 0 → scratch page."""

    def __init__(self, cfg, n_slots: int, n_pages: int, page_size: int,
                 max_seq_pages: int, *, device=None):
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

    @property
    def max_seq_tokens(self) -> int:
        return self.max_seq_pages * self.page_size

    def set_pages(self, slot: int, pages: List[int]) -> None:
        row = np.zeros((self.max_seq_pages,), np.int32)
        row[:len(pages)] = pages
        self.ptab[slot] = row

    def set_len(self, slot: int, n: int) -> None:
        self.lens[slot] = n

    def reset_slot(self, slot: int) -> None:
        self.ptab[slot] = 0
        self.lens[slot] = 0

    def pages_dev(self) -> torch.Tensor:
        return torch.from_numpy(self.ptab.copy()).to(self.device)

    def lens_dev(self) -> torch.Tensor:
        return torch.from_numpy(self.lens.copy()).to(self.device)

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
