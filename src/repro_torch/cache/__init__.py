"""``repro_torch.cache``: paged KV-cache bookkeeping (host side).

The port's copy of ``repro/cache``: :class:`PagePool` (free list and
refcounts over a fixed page pool), :func:`pages_needed` (the one formula
that sizes a request's page reservation) and :class:`PrefixRegistry`
(exact prompt -> resident prefix pages plus the cached first token, LRU).
Page contents live in the endpoint's device tensors.
"""

from repro_torch.cache.pages import (PagePool, pages_for_tokens,
                                     pages_needed, token_extent)
from repro_torch.cache.prefix import PrefixEntry, PrefixRegistry

__all__ = ["PagePool", "pages_needed", "pages_for_tokens", "token_extent",
           "PrefixEntry", "PrefixRegistry"]
