"""KV-cache page bookkeeping for the LLM engine (the port's own copy of
`ray_tpu/serve/llm/kv_cache.py`).

The device-side page tensors live in `ray_tpu_torch.models.decode`; this
module owns the host-side pool: which pages are free, which sequence
holds which pages, and how many pages a budget affords. Pure Python.
"""
from __future__ import annotations

from typing import List, Optional


def pages_needed(n_positions: int, page_size: int) -> int:
    """Pages that cover n_positions cache slots."""
    return max(0, -(-n_positions // page_size))


def pages_from_budget(config, page_size: int, budget_bytes: int,
                      tp_shards: int = 1, dtype=None) -> int:
    """Pool size a memory budget affords. The budget is per rank: a
    replica over `tp_shards` tensor-parallel ranks keeps each rank's kv
    heads in that rank's cache, so every rank holds the pool's pages in
    at most `budget_bytes`, and doubling tp doubles the pages the same
    per-card budget buys."""
    from ray_tpu_torch.models.decode import cache_page_bytes
    per_page = cache_page_bytes(config, page_size, tp_shards=tp_shards,
                                dtype=dtype)
    return max(0, budget_bytes // per_page)


class PageAllocator:
    """Free-list allocator over a fixed pool of cache pages.

    Allocation is all-or-nothing (a sequence that cannot get every
    page it needs stays in the waiting queue rather than holding a
    partial claim that deadlocks the pool). Double-free is an error:
    a page returned twice would be handed to two sequences and corrupt
    both contexts silently.
    """

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be > 0, got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._held = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim n pages, or None (and claim nothing) if short."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._held.update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._held:
                raise ValueError(
                    f"page {p} freed twice (or never allocated)")
            self._held.discard(p)
            self._free.append(p)
