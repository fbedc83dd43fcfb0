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

Quantized page layouts (int8, fp8-e4m3) store pool rows as codes with one
float32 amax scale per physical page, in (n_pages,) sidecars beside the
pools (K and V scales apart). Every write re-derives the page's scale from
its valid prefix and re-quantizes the page (read-modify-write), as the
reference does.

Two layers, as in the reference: torch helpers over the pools (writes are
in place, where the JAX code returns an updated array), and the host-side
refcounted ``PagePool`` the scheduler drives. The reference's prefix
index, LRU, tiers and ``FetchQueue`` are not ported yet (ROADMAP queue 1
item 7).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

TRASH_PAGE = 0

#: PageLayout.dtype -> torch storage dtype of the physical pool
STORAGE_DTYPE = {"fp32": torch.float32, "fp16": torch.float16,
                 "bf16": torch.bfloat16, "int8": torch.int8,
                 "fp8": torch.float8_e4m3fn}

#: scale floor: all-zero (fresh) pages divide safely
QUANT_EPS = 1e-8


def check_scales(pool, k_scale, v_scale, page_table, page_size: int, *,
                 need_v: bool = True) -> bool:
    """Check per-page scale arguments as the reference kernels assert them
    and return whether the call is scaled: scales only with a paged pool,
    ``k_scale`` and ``v_scale`` together (``need_v``; select_blocks takes
    ``k_scale`` alone), each a float32 vector of one entry per page of
    ``pool`` (R rows = n_pages * page_size)."""
    given = [s for s in (k_scale, v_scale) if s is not None]
    if not given:
        return False
    if page_table is None:
        raise ValueError("per-page scales require paged caches "
                         "(page_table and page_size)")
    if k_scale is None or (need_v and v_scale is None):
        raise ValueError("k_scale and v_scale come together "
                         "(a quantized layout scales both pools)")
    n_pages = pool.shape[0] // page_size
    for s in given:
        if s.shape != (n_pages,) or s.dtype != torch.float32:
            raise ValueError(f"a page scale must be ({n_pages},) float32, "
                             f"one entry per pool page; got "
                             f"{tuple(s.shape)} {s.dtype}")
    return True


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


def gather_scales(scales, page_table, page_size: int):
    """Per logical-row dequantization scale: scales (n_pages,) float32,
    page_table (B, max_pages) -> (B, max_pages * page_size)."""
    s = scales[page_table.to(scales.device).long()]
    return s.repeat_interleave(page_size, dim=1)


def gather_logical_dq(pool, scales, page_table, page_size: int):
    """``gather_logical`` and dequantization: the float32 logical view of
    a quantized pool, code -> float32 * page scale. ``scales=None`` is the
    plain gather, so callers hold one code path per layout."""
    rows = gather_logical(pool, page_table, page_size)
    if scales is None:
        return rows
    s = gather_scales(scales, page_table, page_size)
    return rows.float() * s[:, :, None, None]


def quantize_rows(x, scale, dtype, qmax: float):
    """float32 rows -> codes at a page scale (broadcast against x). Integer
    codes round half to even and clip to +-qmax, as the reference does;
    fp8 codes clip to +-qmax too (the reference's conversion turns stale
    rows past a page's valid prefix that overflow into NaN, which poisons
    the page's next scale; the port saturates them, PERF.md / ROADMAP
    queue 3). Valid rows never exceed qmax, so their codes agree."""
    y = x / scale
    if not dtype.is_floating_point:
        y = torch.round(y)
    return y.clamp(-qmax, qmax).to(dtype)


def _page_scale(rows_f32, n_valid, qmax: float):
    """amax / qmax over each page's valid prefix: rows_f32 (N, ps, H, W),
    n_valid (N,) -> (N,) float32."""
    ps = rows_f32.shape[1]
    m = torch.arange(ps, device=rows_f32.device)[None] < n_valid[:, None]
    amax = torch.where(m[:, :, None, None], rows_f32.abs(),
                       0.0).amax(dim=(1, 2, 3))
    # times the reciprocal (a Python scalar multiplies a float32 tensor at
    # float32), as the reference's compiled write computes amax / qmax; no
    # device tensor is built from the host, so a decode step stays free of
    # host syncs
    return amax.clamp(min=QUANT_EPS) * (1.0 / qmax)


def _rmw_pages(pool, scales, page, new_rows, take, n_valid, page_size,
               qmax):
    """Read-modify-write of N whole pages at once: page (N,) physical ids;
    new_rows (N, ps, H, W) and take (N, ps) the rows to overlay; n_valid
    (N,) the valid prefix each new scale covers. Pages are dequantized at
    their old scale, overlaid, re-scaled and re-quantized. Entries that
    share a page (dead slots on the trash page) leave it undefined; no
    live read touches the trash page."""
    rows = page[:, None] * page_size + torch.arange(page_size,
                                                    device=page.device)
    dq = pool[rows].float() * scales[page][:, None, None, None]
    dq = torch.where(take[:, :, None, None], new_rows.float(), dq)
    scale = _page_scale(dq, n_valid, qmax)
    pool[rows] = quantize_rows(dq, scale[:, None, None, None], pool.dtype,
                               qmax)
    scales[page] = scale


def write_token_rows_q(pool, scales, new, page_table, pos, page_size: int,
                       *, qmax: float):
    """Quantized decode-step write, in place: new (B, Hkv, W) at logical
    positions pos (B,). Each slot's current page is read-modified-written
    with its scale re-derived over the valid prefix [0, pos % ps + 1); all
    slots at once (the reference loops over them, and its dead slots
    rewrite the trash page in turn). Returns (pool, scales)."""
    ps = page_size
    pos = pos.to(pool.device).long()
    table = page_table.to(pool.device).long()
    lpage = (pos // ps).clamp(0, table.shape[1] - 1)
    page = torch.gather(table, 1, lpage[:, None])[:, 0]
    off = pos % ps
    take = torch.arange(ps, device=pool.device)[None] == off[:, None]
    new_rows = new[:, None].expand(-1, ps, -1, -1)
    _rmw_pages(pool, scales, page, new_rows, take, off + 1, ps, qmax)
    return pool, scales


def write_chunk_rows_q(pool, scales, new, table_row, pos_start: int,
                       page_size: int, *, n_valid: Optional[int] = None,
                       qmax: float):
    """Quantized chunked-prefill write (one request), in place: new (C,
    Hkv, W) at logical ``pos_start + [0, C)``; rows at or past ``n_valid``
    (final-chunk padding) are never written. Every page the chunk spans is
    read-modified-written at once; a spanned page that receives no valid
    row (or lies past the table) is diverted to the trash page, so live
    pages are never re-quantized for nothing. Returns (pool, scales)."""
    ps = page_size
    c = new.shape[0]
    nv = c if n_valid is None else n_valid
    dev = pool.device
    table_row = table_row.to(dev).long()
    max_pages = table_row.shape[0]
    span = (c + ps - 1) // ps + 1                # the reference's bound
    lpage = pos_start // ps + torch.arange(span, device=dev)
    g0 = lpage * ps                              # each page's logical start
    ci = g0[:, None] + torch.arange(ps, device=dev) - pos_start
    take = (ci >= 0) & (ci < nv)                 # (span, ps) page row -> chunk
    in_range = lpage < max_pages
    page = torch.where(take.any(1) & in_range,
                       table_row[lpage.clamp(max=max_pages - 1)],
                       TRASH_PAGE)
    new_rows = new.to(dev)[ci.clamp(0, c - 1)]   # (span, ps, H, W)
    n_page = (pos_start + nv - g0).clamp(0, ps)
    _rmw_pages(pool, scales, page, new_rows, take, n_page, ps, qmax)
    return pool, scales


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
