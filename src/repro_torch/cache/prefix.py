"""Prefix registry: shared function-prompt pages.

The port's own copy of ``repro/cache/prefix.py``.  Invocations of a hot
function share its prompt, so the KV cache of that prompt is identical
across them; a dense pool re-prefills it every time (the LLM analogue of
a serverless cold start).  The registry keys the *pages* holding an
already-computed prompt by its exact token ids; a new request with the
same prompt references those pages (refcount + 1, copy-on-write past the
fork point) and skips prefill compute entirely: the cached
``first_token`` (the argmax the registering prefill produced) seeds its
decode stream.

The registry holds one reference on every page of every entry; LRU
eviction (bounded ``capacity``) drops those references, and the pool
frees a page once no table references it either.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch.cache.pages import PagePool


def prefix_key(tokens: np.ndarray) -> bytes:
    """Identity of a prompt: its exact int32 token bytes (a digest could
    collide and cross-wire two requests' caches)."""
    return np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()


@dataclasses.dataclass
class PrefixEntry:
    """One registered prompt resident in the pool."""
    page_ids: Tuple[int, ...]          # pages covering positions [0, length)
    length: int                        # prompt tokens covered
    first_token: int                   # argmax at the last prompt position


class PrefixRegistry:
    """LRU-bounded map: prompt -> resident prefix pages."""

    def __init__(self, pool: PagePool, capacity: int = 64):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.pool = pool
        self.capacity = capacity
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, tokens: np.ndarray) -> Optional[PrefixEntry]:
        """Exact-prompt hit or None; a hit refreshes its LRU order."""
        key = prefix_key(tokens)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def register(self, tokens: np.ndarray, page_ids, first_token: int
                 ) -> Optional[PrefixEntry]:
        """Pin ``page_ids`` as the resident cache of ``tokens`` (one
        reference per page).  A known prompt only refreshes its LRU order;
        a zero-capacity registry registers nothing.  May evict the LRU
        entry."""
        if self.capacity == 0:
            return None
        key = prefix_key(tokens)
        if key in self._entries:
            self._entries.move_to_end(key)
            return self._entries[key]
        entry = PrefixEntry(tuple(int(p) for p in page_ids),
                            int(len(tokens)), int(first_token))
        self.pool.retain(entry.page_ids)
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self.evict_lru()
        return entry

    def evict_lru(self) -> bool:
        """Drop the least recently used entry (and its references).
        Returns False when the registry is empty."""
        if not self._entries:
            return False
        _, old = self._entries.popitem(last=False)
        self.pool.release(old.page_ids)
        return True

    def flush(self) -> None:
        """Drop every entry."""
        while self.evict_lru():
            pass

    def pinned_pages(self) -> set:
        """Every page some entry holds a reference on."""
        return {p for e in self._entries.values() for p in e.page_ids}
