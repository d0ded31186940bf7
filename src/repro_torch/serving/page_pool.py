"""Block-pool KV allocator: fixed-size pages, ref-counted free list.

The pool is pure host-side bookkeeping — the actual KV bytes live in the
per-layer ``k_pages``/``v_pages`` device arrays (``lm.init_paged_cache``);
every layer shares ONE logical block table per sequence, so allocation is
done once per sequence here and reused across all layers.

Reference counting exists so pages can be *shared* between sequences
(prefix caching / beam forks): ``share()`` bumps the count, ``free()``
only returns a page to the free list when its last owner releases it.
Page 0 is reserved as the scratch page: inactive batch slots and padded
block-table entries point at it, so scatter/gather index maps always hit
resident memory without branching.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

SCRATCH_PAGE = 0


class PagePool:
    """Fixed-size page allocator with a ref-counted free list."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is scratch)")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # LIFO free list: recently-freed pages are re-used first (warm).
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refcount: Dict[int, int] = {}

    # -- capacity ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def num_allocated(self) -> int:
        with self._lock:
            return len(self._refcount)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens``."""
        return -(-max(0, int(n_tokens)) // self.page_size)

    def can_alloc(self, n_pages: int) -> bool:
        with self._lock:
            return len(self._free) >= n_pages

    # -- alloc / share / free ----------------------------------------------
    def alloc(self, n_pages: int) -> Optional[List[int]]:
        """Pop ``n_pages`` free pages (refcount 1 each), or None if the
        pool cannot satisfy the request — admission control, not an error."""
        if n_pages < 0:
            raise ValueError(f"alloc({n_pages})")
        with self._lock:
            if len(self._free) < n_pages:
                return None
            pages = [self._free.pop() for _ in range(n_pages)]
            for p in pages:
                self._refcount[p] = 1
            return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add an owner to already-allocated pages (prefix sharing)."""
        with self._lock:
            for p in pages:
                if p not in self._refcount:
                    raise ValueError(f"share() of unallocated page {p}")
                self._refcount[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Release one ownership of each page; pages return to the free
        list when their last owner lets go. Double-free raises."""
        with self._lock:
            for p in pages:
                count = self._refcount.get(p)
                if count is None:
                    raise ValueError(f"double free of page {p}")
                if count == 1:
                    del self._refcount[p]
                    self._free.append(p)
                else:
                    self._refcount[p] = count - 1

    # -- introspection (tests / invariants) --------------------------------
    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refcount.get(page, 0)

    def check_invariants(self) -> None:
        """Every non-scratch page is either free or allocated, never both —
        the no-leak / no-double-free property the tests drive."""
        with self._lock:
            free = set(self._free)
            allocated = set(self._refcount)
            assert SCRATCH_PAGE not in free and SCRATCH_PAGE not in allocated
            assert not (free & allocated), f"pages both free+allocated: " \
                                           f"{sorted(free & allocated)}"
            assert len(free) == len(self._free), "duplicate free-list entry"
            universe = set(range(1, self.num_pages))
            assert free | allocated == universe, \
                f"leaked pages: {sorted(universe - free - allocated)}"
            assert all(c >= 1 for c in self._refcount.values())
