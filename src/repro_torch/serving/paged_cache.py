"""Paged KV-cache: the shared page pool of the paged serving engine
(counterpart of ``repro.serving.paged_cache``, default layout only).

  pool        (n_pages * page_size, Hkv, W)   per layer, no batch dim
  page table  (n_slots, max_pages) int32      logical page -> physical page

A request's logical position ``p`` lives at pool row
``table[slot, p // page_size] * page_size + p % page_size``. Pages are
handed out as a request's context grows and released the moment it
finishes or is preempted, so memory follows the live token count.

Physical page 0 is the trash page: freed and idle slots point their whole
table at it, so the batched decode step's unconditional write lands there
instead of in pages reallocated to other requests.

Two layers, as in the reference: torch helpers over the pools (writes are
in place, where the JAX code returns an updated array), and the host-side
refcounted ``PagePool`` the scheduler drives. The reference's prefix
index, LRU, tiers and ``FetchQueue`` are not ported yet (ROADMAP queue 1
item 7), nor are quantized page codes (item 6).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

TRASH_PAGE = 0


def unscaled(k_scale, v_scale) -> None:
    """Refuse per-page scales: the quantized page layouts they belong to
    are not ported yet."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "per-page scales (quantized page layouts) are not ported yet "
            "(ROADMAP queue 1 item 6)")


# ---------------------------------------------------------- pool helpers

def logical_rows(page_table, page_size: int):
    """(B, max_pages) int32 -> (B, max_pages * page_size) pool row ids."""
    b, n = page_table.shape
    rows = (page_table.long()[:, :, None] * page_size
            + torch.arange(page_size, device=page_table.device))
    return rows.reshape(b, n * page_size)


def gather_logical(pool, page_table, page_size: int):
    """The logical per-slot view of a pooled cache: pool (R, Hkv, W),
    page_table (B, max_pages) -> (B, max_pages * page_size, Hkv, W), a
    copy. Rows past a slot's length hold whatever the trash or
    unallocated pages hold; callers mask them by length."""
    return pool[logical_rows(page_table.to(pool.device), page_size)]


def token_rows(page_table, pos, page_size: int):
    """Pool rows of one token per slot: page_table (B, max_pages), pos
    (B,) logical positions -> (B,) int64 rows. The page index clamps to
    the table, as the reference's gather clamps."""
    pos = pos.long()
    page = (pos // page_size).clamp(0, page_table.shape[1] - 1)
    pid = torch.gather(page_table.long(), 1, page[:, None])[:, 0]
    return pid * page_size + pos % page_size


def write_token_rows(pool, new, page_table, pos, page_size: int):
    """Decode-step write, in place: new (B, Hkv, W) at logical positions
    pos (B,). Returns the pool."""
    pool[token_rows(page_table, pos, page_size)] = new.to(pool.dtype)
    return pool


def write_chunk_rows(pool, new, table_row, pos_start: int, page_size: int,
                     *, n_valid: Optional[int] = None):
    """Chunked-prefill write, in place: new (C, Hkv, W) at logical
    positions ``pos_start + [0, C)`` of one request; table_row
    (max_pages,). Rows at or past ``n_valid`` (the zero padding of a
    fixed-size final chunk) go to the trash page, so a padded chunk never
    needs pages beyond its real tokens. Returns the pool."""
    c = new.shape[0]
    pos = pos_start + torch.arange(c, device=table_row.device)
    page = (pos // page_size).clamp(max=table_row.shape[0] - 1)
    rows = table_row.long()[page] * page_size + pos % page_size
    if n_valid is not None:
        rows = torch.where(torch.arange(c, device=rows.device) < n_valid,
                           rows, TRASH_PAGE * page_size)
    pool[rows.to(pool.device)] = new.to(pool.dtype)
    return pool


# ------------------------------------------------------------ allocator

class PagePool:
    """Host-side refcounted allocator over ``n_pages`` physical pages.

    Page 0 is reserved (the trash page), so ``n_pages - 1`` pages are
    usable. A page is free, or held with a refcount >= 1: ``alloc`` hands
    out free pages at refcount 1, ``acquire`` adds a reference to a held
    page, ``release`` drops one and returns the page to the free list at
    zero. The reference's prefix index and LRU of cached pages are not
    ported (ROADMAP queue 1 item 7), so a released page is free at once.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(1, n_pages))
        self._ref: Dict[int, int] = {}

    # ------------------------------------------------------- accounting

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """What ``alloc`` can produce (free pages; no cached ones here)."""
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Pages some request holds a reference to."""
        return (self.n_pages - 1) - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def free_page_ids(self) -> List[int]:
        return list(self._free)

    def holders(self) -> Dict[int, int]:
        """page -> refcount for every held page (a copy)."""
        return dict(self._ref)

    # ------------------------------------------------------- alloc/free

    def alloc(self, n: int) -> Optional[List[int]]:
        """n free pages at refcount 1, in free-list order, or None (and no
        allocation) when fewer are free. ``alloc(0)`` returns ``[]``."""
        if n == 0:
            return []
        if n > len(self._free):
            return None
        taken, self._free = self._free[:n], self._free[n:]
        for p in taken:
            self._ref[p] = 1
        return taken

    def acquire(self, pages: List[int]) -> List[int]:
        """One more reference on each of ``pages``, all held already.
        Raises on the trash page or a page nobody holds."""
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("acquire of the reserved trash page")
            if self._ref.get(p, 0) == 0:
                raise ValueError(f"acquire of unheld page {p}")
        for p in pages:
            self._ref[p] += 1
        return pages

    def release(self, pages: List[int]) -> None:
        """Drop one reference per listed page; a page at zero goes back to
        the end of the free list. Raises, before changing anything, on the
        trash page or a refcount underflow (a double free)."""
        seen: Dict[int, int] = {}
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("free() of the reserved trash page")
            seen[p] = seen.get(p, 0) + 1
            if self._ref.get(p, 0) < seen[p]:
                raise ValueError(
                    f"double-free of page {p} (refcount underflow)")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)

    @staticmethod
    def pages_for(n_tokens: int, page_size: int) -> int:
        """Pages needed to hold n_tokens."""
        return -(-max(n_tokens, 0) // page_size)
