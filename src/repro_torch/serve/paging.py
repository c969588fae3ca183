"""Host-side page allocator for the paged KV cache (DESIGN §14).

The port's own copy of ``repro/serve/paging.py``.  The device side is a
(n_pages, page_size, KV, hd) pool per attention layer plus a
(n_slots, max_pages) int32 page table handed to every decode step; which
physical pages a slot holds, and which are free, lives here on the host.

Page 0 is the SCRATCH page: a free (or page-stalled) slot's table entries
stay 0, so its write in the fused step lands there and is never read back
(the per-slot length masks exclude it).  The allocator only ever hands out
pages 1..n_pages-1.
"""
from __future__ import annotations


class OutOfPages(RuntimeError):
    """No free page in the pool (the caller should stall, not crash)."""


class PageAllocator:
    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least one real page beyond scratch")
        self.n_pages = n_pages
        # LIFO free list: recently freed (cache-hot) pages are reused first
        self._free = list(range(n_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages(f"pool of {self.n_pages - 1} pages exhausted")
        return self._free.pop()

    def free(self, pages) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"page {p} is not a real page of this pool")
            self._free.append(int(p))
