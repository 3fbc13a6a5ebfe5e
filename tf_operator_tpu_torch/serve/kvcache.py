"""Paged KV cache bookkeeping: fixed-size pages in a preallocated pool.

The port's own copy of ``tf_operator_tpu/serve/kvcache.py`` (pure
Python, no framework). Decode K/V lives in PAGES of ``page_size`` token
slots, preallocated by the engine as one device pool per side, shape
[n_layers, num_pages + 1, page_size, n_kv_heads, head_dim]. A sequence
owns an ordered page table; completion returns its pages to a free list
with NO copying — the next owner overwrites them in place, and only its
seq_len mask hides what the previous owner left.

Page index ``num_pages`` (the +1) is the TRASH page: writes from inactive
batch slots and prefill padding go there; no live prefix ever names it.

The allocator is a LIFO free list, so ``free_count`` returning to
``num_pages`` after a run is an exact leak check.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


class PoolExhausted(Exception):
    """An allocation could not be satisfied — admission control catches
    this and holds the request, never the decode step."""


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` K/V positions (ceil, at least 1)."""
    return max(1, -(-int(tokens) // int(page_size)))


def pool_bytes(
    n_layers: int,
    num_pages: int,
    page_size: int,
    n_kv_heads: int,
    head_dim: int,
    dtype_bytes: int = 4,
) -> int:
    """Device bytes of the K+V pools, the trash page included."""
    per_side = n_layers * (num_pages + 1) * page_size * n_kv_heads * head_dim
    return 2 * per_side * dtype_bytes


@dataclass
class PagePool:
    """Free-list allocator over ``num_pages`` page ids (host-side only:
    the engine owns the device pool)."""

    num_pages: int
    _free: List[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.num_pages < 1:
            raise ValueError(f"page pool needs >= 1 page, got {self.num_pages}")
        # LIFO: pop from the tail, so page 0 is handed out first.
        self._free = list(range(self.num_pages - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def trash_page(self) -> int:
        """The masked-write sink: one past the allocatable range."""
        return self.num_pages

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` pages or raise PoolExhausted (all or nothing)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)}/{self.num_pages} free"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        """Return pages to the free list; the device pages are NOT cleared."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"free of page {p} outside pool")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)


@dataclass
class SequencePages:
    """One sequence's page table: the ordered page ids backing positions
    [0, len), grown on demand and freed wholesale at completion."""

    page_size: int
    pages: List[int] = field(default_factory=list)

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.page_size

    def ensure(self, length: int, pool: PagePool) -> None:
        """Grow to cover ``length`` positions (PoolExhausted propagates)."""
        need = pages_needed(length, self.page_size) - len(self.pages)
        if need > 0:
            self.pages.extend(pool.alloc(need))

    def release(self, pool: PagePool) -> None:
        pool.free(self.pages)
        self.pages = []
