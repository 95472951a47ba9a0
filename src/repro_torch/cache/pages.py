"""Fixed-size page-pool allocator for the paged KV cache.

The port's own copy of ``repro/cache/pages.py`` (the port imports nothing
of the reference).  The pool is pure host-side bookkeeping: which pages
are free, how many references each allocated page carries, and how many
pages a request of a given size must reserve.  Page *contents* are
device tensors owned by the serving endpoint (``serving/engine.py``).

Sharing model (at page granularity):

  * a page referenced by exactly one page table is *private*: its owner
    may write new KV positions into it;
  * a page referenced by several tables (or by the
    :class:`~repro_torch.cache.prefix.PrefixRegistry`) is *shared* and
    immutable: a request about to write into a shared page first
    **copy-on-write forks** it (allocate a fresh page, copy the contents,
    swap its table entry, drop one reference on the original).

The pool enforces the refcount side of that contract; the engine does
the device-side copying.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_paged.py::test_page_formulas_match_reference holds this
# copy against repro.cache.pages.token_extent
def token_extent(prompt_len: int, max_new: int) -> int:
    """KV positions ``[0, extent)`` a request writes over its lifetime:
    prefill writes ``[0, prompt_len)``, decode writes
    ``prompt_len .. prompt_len + max_new - 2`` (the last generated token
    is never written back)."""
    return prompt_len + max(max_new, 1) - 1


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_paged.py::test_page_formulas_match_reference holds this
# copy against repro.cache.pages.pages_needed
def pages_needed(prompt_len: int, max_new: int, page_size: int,
                 max_len: int) -> int:
    """Pages a request must reserve to decode without mid-stream
    allocation: its :func:`token_extent` in pages, or the full row when
    the extent exceeds ``max_len`` (the rolling cache wraps and touches
    every page of the row)."""
    if page_size <= 0:
        raise ValueError(f"page_size must be > 0, got {page_size}")
    ppr = -(-max_len // page_size)              # pages per full row
    extent = token_extent(prompt_len, max_new)
    if extent > max_len:
        return ppr
    return min(ppr, max(1, -(-extent // page_size)))


# lint: ignore[parity-drift] -- the port imports nothing of repro;
# tests/test_torch_paged.py::test_page_formulas_match_reference holds this
# copy against repro.cache.pages.pages_for_tokens
def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """Pages covering positions ``[0, n_tokens)`` (0 tokens -> 0 pages)."""
    return -(-max(n_tokens, 0) // page_size)


class PagePool:
    """Free-list page allocator with per-page reference counts.

    ``num_pages`` usable pages, ids ``0..num_pages-1``.  Allocation pops
    from the free list (LIFO: recently freed pages are reused first);
    every allocated page carries a refcount, and :meth:`release` returns a
    page to the free list only when its last reference drops.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be > 0, got {num_pages}")
        if page_size <= 0:
            raise ValueError(f"page_size must be > 0, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._ref: List[int] = [0] * num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, pid: int) -> int:
        return self._ref[pid]

    def is_shared(self, pid: int) -> bool:
        return self._ref[pid] > 1

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` free pages (refcount 1 each), or None if the pool
        cannot satisfy the request: nothing is allocated partially."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            self._ref[pid] = 1
        return out

    def retain(self, pids: Iterable[int]) -> None:
        """Add one reference to each (already allocated) page."""
        for pid in pids:
            if self._ref[pid] <= 0:
                raise ValueError(f"retain of free page {pid}")
            self._ref[pid] += 1

    def release(self, pids: Iterable[int]) -> None:
        """Drop one reference per page; a page whose last reference drops
        returns to the free list."""
        for pid in pids:
            if self._ref[pid] <= 0:
                raise ValueError(f"release of free page {pid}")
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._free.append(pid)

    def check_balanced(self) -> bool:
        """True when refcounts and the free list agree."""
        live = sum(1 for r in self._ref if r > 0)
        return live + len(self._free) == self.num_pages
