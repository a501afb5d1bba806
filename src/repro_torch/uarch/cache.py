"""Set-associative LRU caches and a small TLB for the detailed simulator."""
from __future__ import annotations

import numpy as np

__all__ = ["Cache", "TLB"]

LINE_BYTES = 64
PAGE_BYTES = 4096


class Cache:
    """Set-associative cache with true-LRU replacement.

    Implemented with numpy tag arrays + an LRU timestamp matrix; lookups are
    O(assoc) which is plenty fast for the trace lengths we simulate.
    """

    def __init__(self, size_bytes: int, assoc: int, line_bytes: int = LINE_BYTES):
        self.line_bytes = line_bytes
        self.assoc = assoc
        # Round the set count down for capacities not divisible by assoc*line
        # (e.g. 16KB 6-way); gem5 pads instead, the difference is immaterial.
        self.num_sets = max(1, size_bytes // (assoc * line_bytes))
        self.tags = np.full((self.num_sets, assoc), -1, dtype=np.int64)
        self.lru = np.zeros((self.num_sets, assoc), dtype=np.int64)
        self._tick = 0
        self.hits = 0
        self.misses = 0

    def access(self, byte_addr: int) -> bool:
        """Access `byte_addr`; returns True on hit. Fills the line on miss."""
        line = byte_addr // self.line_bytes
        s = line % self.num_sets
        tag = line // self.num_sets
        self._tick += 1
        tags = self.tags[s]
        for w in range(self.assoc):
            if tags[w] == tag:
                self.lru[s, w] = self._tick
                self.hits += 1
                return True
        # Miss: replace LRU way.
        w = int(np.argmin(self.lru[s]))
        self.tags[s, w] = tag
        self.lru[s, w] = self._tick
        self.misses += 1
        return False


class TLB:
    """Fully-associative LRU TLB over 4KB pages."""

    def __init__(self, entries: int = 64, page_bytes: int = PAGE_BYTES):
        self.entries = entries
        self.page_bytes = page_bytes
        self.pages = np.full(entries, -1, dtype=np.int64)
        self.lru = np.zeros(entries, dtype=np.int64)
        self._tick = 0
        self.hits = 0
        self.misses = 0

    def access(self, byte_addr: int) -> bool:
        page = byte_addr // self.page_bytes
        self._tick += 1
        hit = np.nonzero(self.pages == page)[0]
        if hit.size:
            self.lru[hit[0]] = self._tick
            self.hits += 1
            return True
        w = int(np.argmin(self.lru))
        self.pages[w] = page
        self.lru[w] = self._tick
        self.misses += 1
        return False
