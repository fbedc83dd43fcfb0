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

Tiered pool (``device_pages``): logical pages stay the unit of the page
tables, refcounts and the prefix index, but only ``device_pages`` frames
of full-D K/V rows live on the card. Every logical page also owns a row
range of the always-resident latent-K sidecar (``lm.init_paged_cache``),
which is all Loki's score pass reads. A page is in one tier state:

  RESIDENT   its full-D rows live in a device frame (``frame_of(page)``)
  HOST       its full-D rows live in the engine's pinned host buffers
  IN_FLIGHT  a host-to-device copy owns a frame but has not landed yet

``demote`` / ``promote_begin`` / ``promote_complete`` move pages between
the states with double-free-style guards; ``FetchQueue`` wraps the promote
pair into a bounded queue of copies (default 2 in flight).

Two layers, as in the reference: torch helpers over the pools (writes are
in place, where the JAX code returns an updated array), and the host-side
refcounted ``PagePool`` the scheduler drives, with its prefix-cache index
over full prompt pages, the LRU of cached pages, the tier state and the
fault seams (``set_faults``), and the private entries the StateSlot
families' preemption retains a hybrid request's own pages under
(``register_private`` / ``reclaim_private``).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

TRASH_PAGE = 0

# tier states of a logical page in a tiered pool
RESIDENT = "resident"
HOST = "host"
IN_FLIGHT = "in_flight"

#: chain-hash parent of a prompt's first page
ROOT_KEY = b""

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


def copy_page_rows(pool, src_page: int, dst_page: int, page_size: int):
    """Copy-on-write, in place: duplicate one physical page's rows inside
    a pool (R, Hkv, W), or in every layer of a stacked pool (L, R, Hkv,
    W). A request sharing a cached tail page copies it to a page of its
    own before its first write, so the original stays intact for its
    other readers and the index. Returns the pool."""
    s, d = src_page * page_size, dst_page * page_size
    pool[..., d:d + page_size, :, :] = pool[..., s:s + page_size, :, :]
    return pool


def copy_page_scale(scales, src_page: int, dst_page: int):
    """COW of a quantized page's scale, in place ((n_pages,) or stacked
    (L, n_pages)): the codes are copied verbatim, so the copy dequantizes
    as its donor only if the scale rides along. Returns the scales."""
    scales[..., dst_page] = scales[..., src_page]
    return scales


# ------------------------------------------------------------ allocator

def page_key(parent: bytes, tokens) -> bytes:
    """Chain hash of a full page of prompt tokens in its context:
    ``parent`` is the preceding pages' key (ROOT_KEY for page 0), so equal
    keys mean equal token prefixes end to end and position-dependent K/V
    (rotary, the PCA storage basis) can be shared."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


@dataclasses.dataclass
class CacheEntry:
    """One registered (immutable, full) prompt page."""
    page: int
    key: bytes                 # chain hash including this page's tokens
    parent: bytes              # chain hash of the preceding pages
    tokens: np.ndarray         # this page's page_size token ids


class PagePool:
    """Host-side refcounted allocator over ``n_pages`` physical pages,
    with a prefix-cache index over full prompt pages.

    Page 0 is reserved (the trash page), so ``n_pages - 1`` pages are
    usable. A usable page's life:

      free -> alloc() -> held (ref 1) -> acquire()/release() ref +-1
        release to ref 0:  unregistered -> free
                           registered   -> cached (LRU, evictable)
      cached -> match_prefix() hit -> held again
      cached -> eviction (alloc finds the free list short) -> free
      held -> register_private() -> released: cached, reachable by its
              private key only -> reclaim_private() -> held again

    ``free_pages`` counts the free list, ``cached_pages`` the registered
    pages no request holds, ``available_pages`` both: what ``alloc`` can
    produce. ``used_pages`` counts pages some request holds.

    ``device_pages`` makes the pool tiered: frames 1 .. device_pages - 1
    hold full-D rows (frame 0 is the trash frame), and each allocated or
    cached page carries a tier state. ``max_inflight`` bounds the fetches
    in flight. The pool is bookkeeping only: the engine owns the device
    pools and the host buffers and makes the copies, copy-then-demote and
    promote_begin, copy, promote_complete.
    """

    def __init__(self, n_pages: int, page_size: int,
                 device_pages: Optional[int] = None,
                 max_inflight: int = 2):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        if device_pages is not None and not 2 <= device_pages <= n_pages:
            raise ValueError(
                f"device_pages must be in [2, n_pages={n_pages}], "
                f"got {device_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        # the serving/faults.py FaultPlan consulted at alloc and
        # available_pages; None: no faults
        self._faults = None
        self._free: List[int] = list(range(1, n_pages))
        # tier state (device_pages None: single tier, every page its own
        # frame and always RESIDENT)
        self.device_pages = device_pages
        self.max_inflight = max_inflight
        self._free_frames: List[int] = (
            list(range(1, device_pages)) if device_pages else [])
        self._frame_of: Dict[int, int] = {}   # RESIDENT | IN_FLIGHT pages
        self._tier: Dict[int, str] = {}       # allocated or cached pages
        self._pinned: Dict[int, int] = {}     # page -> pin count
        self._inflight: Dict[int, int] = {}   # page -> staging frame
        self.n_demoted = 0
        self.n_promoted = 0
        self._ref: Dict[int, int] = {}
        # the prefix index over full prompt pages, three views of it
        self._index: Dict[bytes, CacheEntry] = {}
        self._children: Dict[bytes, List[CacheEntry]] = {}
        self._by_page: Dict[int, CacheEntry] = {}
        self._priv_ctr = 0             # private entries' key counter
        # registered pages at refcount 0, least recently released first
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.n_lookups = 0
        self.n_hits = 0
        self.n_hit_tokens = 0
        self.n_evicted = 0

    # -------------------------------------------------- fault injection

    def set_faults(self, plan) -> None:
        """Attach a serving/faults.py FaultPlan, consulted at ``alloc``
        (alloc_fail), ``available_pages`` (pool_exhaustion) and
        ``promote_begin`` (hbm_oom_on_promote). The engine advances the
        plan's tick."""
        self._faults = plan

    def _fault(self, site: str, unit: int = 0) -> bool:
        return self._faults is not None and self._faults.hit(site, unit)

    # ------------------------------------------------------- accounting

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Registered pages no request holds: prefix hits to be, and
        reclaimable by ``alloc`` without preempting anyone."""
        return len(self._lru)

    @property
    def available_pages(self) -> int:
        """What ``alloc`` can produce: free plus cached pages. An injected
        ``pool_exhaustion`` reads 0 for the tick, without touching the
        accounting."""
        if self._fault("pool_exhaustion"):
            return 0
        return len(self._free) + len(self._lru)

    @property
    def used_pages(self) -> int:
        """Pages some request holds a reference to."""
        return (self.n_pages - 1) - len(self._free) - len(self._lru)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def is_registered(self, page: int) -> bool:
        return page in self._by_page

    def is_private(self, page: int) -> bool:
        """Is this page a ``register_private`` retained entry (never
        shareable: the auditor's invariant D checks that no two slots
        reference one)?"""
        e = self._by_page.get(page)
        return e is not None and e.key.startswith(b"priv:")

    # read-only views for the auditor (serving/faults.py)
    def free_page_ids(self) -> List[int]:
        return list(self._free)

    def lru_page_ids(self) -> List[int]:
        return list(self._lru)

    def holders(self) -> Dict[int, int]:
        """page -> refcount for every held page (a copy)."""
        return dict(self._ref)

    # ------------------------------------------------------- tier state

    @property
    def tiered(self) -> bool:
        return self.device_pages is not None

    @property
    def free_frames(self) -> int:
        return len(self._free_frames)

    def tier_of(self, page: int) -> str:
        """Tier state of an allocated or cached page (single-tier pools
        and the trash page are RESIDENT by definition)."""
        if not self.tiered or page == TRASH_PAGE:
            return RESIDENT
        state = self._tier.get(page)
        if state is None:
            raise ValueError(f"tier_of() of free page {page}")
        return state

    def frame_of(self, page: int) -> Optional[int]:
        """The device frame of a page's full-D rows: the page itself in a
        single-tier pool, the mapped frame of a RESIDENT or IN_FLIGHT page,
        None for a HOST page."""
        if not self.tiered:
            return page
        if page == TRASH_PAGE:
            return TRASH_PAGE
        return self._frame_of.get(page)

    def pin(self, page: int) -> None:
        """Pin a RESIDENT page against demotion (tail pages receiving
        decode writes)."""
        if not self.tiered or page == TRASH_PAGE:
            return
        if self._tier.get(page) != RESIDENT:
            raise ValueError(f"pin of non-resident page {page}")
        self._pinned[page] = self._pinned.get(page, 0) + 1

    def unpin(self, page: int) -> None:
        if not self.tiered or page == TRASH_PAGE:
            return
        if self._pinned.get(page, 0) <= 0:
            raise ValueError(f"unpin of unpinned page {page}")
        self._pinned[page] -= 1
        if self._pinned[page] == 0:
            del self._pinned[page]

    def is_pinned(self, page: int) -> bool:
        return self._pinned.get(page, 0) > 0

    def demote(self, page: int) -> int:
        """Surrender a RESIDENT page's frame (its rows must already be in
        the host buffers: the engine copies first) and return the frame.
        Raises like a double free on a HOST, in-flight, pinned or trash
        page."""
        if not self.tiered:
            raise ValueError("demote() on a single-tier pool")
        if page == TRASH_PAGE:
            raise ValueError("demote of the reserved trash page")
        state = self._tier.get(page)
        if state == HOST:
            raise ValueError(f"double-demote of page {page}")
        if state != RESIDENT:
            raise ValueError(f"demote of {state or 'free'} page {page}")
        if self._pinned.get(page, 0):
            raise ValueError(f"demote of pinned page {page}")
        frame = self._frame_of.pop(page)
        self._free_frames.append(frame)
        self._tier[page] = HOST
        self.n_demoted += 1
        return frame

    def promote_begin(self, page: int, faultable: bool = True
                      ) -> Optional[int]:
        """Claim a staging frame for a HOST page's fetch and return it
        (the page turns IN_FLIGHT; the engine copies, then
        ``promote_complete``), or None when no frame is free, the
        in-flight budget is spent or ``hbm_oom_on_promote`` fires.
        Promoting a RESIDENT or IN_FLIGHT page raises."""
        if not self.tiered:
            raise ValueError("promote_begin() on a single-tier pool")
        state = self._tier.get(page)
        if state in (RESIDENT, IN_FLIGHT):
            raise ValueError(f"promote of {state} page {page}")
        if state != HOST:
            raise ValueError(f"promote of free page {page}")
        if faultable and self._fault("hbm_oom_on_promote", page):
            return None
        if not self._free_frames or len(self._inflight) >= self.max_inflight:
            return None
        frame = self._free_frames.pop()
        self._frame_of[page] = frame
        self._tier[page] = IN_FLIGHT
        self._inflight[page] = frame
        return frame

    def promote_complete(self, page: int) -> int:
        """The fetch landed: IN_FLIGHT -> RESIDENT. Returns the frame."""
        if self._tier.get(page) != IN_FLIGHT:
            raise ValueError(
                f"promote_complete of page {page} with no fetch in flight")
        del self._inflight[page]
        self._tier[page] = RESIDENT
        self.n_promoted += 1
        return self._frame_of[page]

    def promote_abort(self, page: int) -> None:
        """A fetch that never landed (dma_timeout): the staging frame goes
        back and the page to HOST, so a retry can claim a fresh fetch."""
        if self._tier.get(page) != IN_FLIGHT:
            raise ValueError(
                f"promote_abort of page {page} with no fetch in flight")
        del self._inflight[page]
        self._free_frames.append(self._frame_of.pop(page))
        self._tier[page] = HOST

    def _tier_free(self, page: int) -> None:
        """Clear a page's tier state as it returns to the free list. The
        in-flight check comes before any change: a refused free leaves the
        tier partition as it was (the fetch still owns its frame)."""
        if not self.tiered:
            return
        state = self._tier.get(page)
        if state == IN_FLIGHT:
            raise ValueError(f"free of in-flight page {page}")
        self._tier.pop(page, None)
        if state == RESIDENT:
            self._free_frames.append(self._frame_of.pop(page))
        self._pinned.pop(page, None)

    # auditor views over the tier partition (invariants G, H, I)
    def resident_page_ids(self) -> List[int]:
        return [p for p, st in self._tier.items() if st == RESIDENT]

    def host_page_ids(self) -> List[int]:
        return [p for p, st in self._tier.items() if st == HOST]

    def inflight_page_ids(self) -> List[int]:
        return list(self._inflight)

    def free_frame_ids(self) -> List[int]:
        return list(self._free_frames)

    def pinned_page_ids(self) -> List[int]:
        return [p for p, n in self._pinned.items() if n > 0]

    def frame_map(self) -> Dict[int, int]:
        """page -> frame for every RESIDENT or IN_FLIGHT page (a copy)."""
        return dict(self._frame_of)

    # ------------------------------------------------------- alloc/free

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, in free-list order, evicting cached
        pages (least recently released first) when the free list is
        short; None (and no allocation, no eviction) when fewer are
        available or ``alloc_fail`` fires. In a tiered pool fresh pages
        are born RESIDENT and each takes a frame: when the free frames
        and the cached pages' frames cannot cover them, None too (the
        caller demotes cold pages first). ``alloc(0)`` returns ``[]``."""
        if n == 0:
            return []
        if self._fault("alloc_fail", n):
            return None
        if n > self.available_pages:
            return None
        if self.tiered:
            lru_frames = sum(1 for p in self._lru
                             if self._tier.get(p) == RESIDENT)
            if n > len(self._free_frames) + lru_frames:
                return None
            while len(self._free_frames) < n:
                self._evict_one()
        while len(self._free) < n:
            self._evict_one()
        taken, self._free = self._free[:n], self._free[n:]
        for p in taken:
            self._ref[p] = 1
            if self.tiered:
                self._tier[p] = RESIDENT
                self._frame_of[p] = self._free_frames.pop()
        return taken

    def acquire(self, pages: List[int]) -> List[int]:
        """One more reference on each of ``pages``, held or cached. Raises
        on the trash page or a page nobody holds and the index does not
        know."""
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("acquire of the reserved trash page")
            if self._ref.get(p, 0) == 0 and p not in self._by_page:
                raise ValueError(f"acquire of unheld page {p}")
        for p in pages:
            self._acquire_one(p)
        return pages

    def _acquire_one(self, page: int) -> None:
        self._ref[page] = self._ref.get(page, 0) + 1
        self._lru.pop(page, None)

    def release(self, pages: List[int]) -> None:
        """Drop one reference per listed page. At zero a page goes back to
        the end of the free list, or, when registered, to the MRU end of
        the LRU (still a hit, evicted on demand). Raises, before changing
        anything, on the trash page, a refcount underflow (a double free)
        or a free that would drop an IN_FLIGHT page to the free list (its
        fetch still owns the frame)."""
        seen: Dict[int, int] = {}
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("free() of the reserved trash page")
            seen[p] = seen.get(p, 0) + 1
            if self._ref.get(p, 0) < seen[p]:
                raise ValueError(
                    f"double-free of page {p} (refcount underflow)")
        for p, c in seen.items():
            if self.tiered and self._ref.get(p, 0) == c \
                    and p not in self._by_page \
                    and self._tier.get(p) == IN_FLIGHT:
                raise ValueError(f"free of in-flight page {p}")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                if p in self._by_page:
                    self._lru[p] = None
                else:
                    self._tier_free(p)
                    self._free.append(p)

    # release is free under refcounts (ref 1 -> 0): the reference's name
    free = release

    def _evict_one(self) -> None:
        """Reclaim the least recently released cached page: drop its index
        entry and hand the page (and its frame) back."""
        page, _ = self._lru.popitem(last=False)
        self._drop_entry(self._by_page[page])
        self._tier_free(page)
        self._free.append(page)
        self.n_evicted += 1

    # ------------------------------------------------------ prefix cache

    def register(self, page: int, parent: bytes, tokens) -> bytes:
        """Publish a held, fully written prompt page under its chain hash
        and return the key (the next page's ``parent``). A key already
        indexed keeps its page (first writer wins); the caller's copy
        stays private. Registered pages are immutable: the engine never
        writes a row of one again (copy-on-write first)."""
        toks = np.ascontiguousarray(tokens, np.int32)
        if toks.shape[0] != self.page_size:
            raise ValueError("register() needs exactly one full page of "
                             f"tokens ({self.page_size}), got {toks.shape}")
        key = page_key(parent, toks)
        if key in self._index or page in self._by_page:
            return key
        if self._ref.get(page, 0) <= 0:
            raise ValueError(f"register of unheld page {page}")
        e = CacheEntry(page, key, parent, toks)
        self._index[key] = e
        self._children.setdefault(parent, []).append(e)
        self._by_page[page] = e
        return key

    def match_prefix(self, tokens, max_tokens: int
                     ) -> Tuple[List[int], int, bool, bytes]:
        """The longest cached prefix of ``tokens[:max_tokens]``, acquired.

        Walks the chain hash over full pages, then tries a partial tail:
        the registered child of the last full hit whose first rows match
        the most remaining tokens (a shared system prompt that ends inside
        a page). Returns (pages, tokens matched, whether the last page is
        a partial tail, the chain hash after the full matches: the parent
        the caller registers its own next page under)."""
        ps = self.page_size
        toks = np.ascontiguousarray(tokens, np.int32)
        pages: List[int] = []
        n, parent = 0, ROOT_KEY
        while n + ps <= max_tokens:
            key = page_key(parent, toks[n:n + ps])
            e = self._index.get(key)
            if e is None:
                break
            self._acquire_one(e.page)
            pages.append(e.page)
            parent = key
            n += ps
        tail = False
        rem = min(max_tokens - n, ps)
        if rem > 0:
            best, best_j = None, 0
            for e in self._children.get(parent, ()):
                j = int((e.tokens[:rem] == toks[n:n + rem]).cumprod().sum())
                if j > best_j:
                    best, best_j = e, j
            if best is not None:
                self._acquire_one(best.page)
                pages.append(best.page)
                n += best_j
                tail = True
        self.n_lookups += 1
        if pages:
            self.n_hits += 1
        self.n_hit_tokens += n
        return pages, n, tail, parent

    def deregister(self, page: int) -> None:
        """Drop a held page's index entry (no-op when unregistered): the
        sole reader of a shared tail takes it over in place, since it is
        about to overwrite rows of it."""
        e = self._by_page.get(page)
        if e is None:
            return
        if self._ref.get(page, 0) <= 0:
            raise ValueError(f"deregister of unheld page {page}")
        self._drop_entry(e)

    def _drop_entry(self, e: CacheEntry) -> None:
        """Remove an entry from the three views of the index."""
        del self._by_page[e.page]
        del self._index[e.key]
        sibs = self._children[e.parent]
        sibs.remove(e)
        if not sibs:
            del self._children[e.parent]

    # ---------------------------------------------------- private entries

    def register_private(self, page: int) -> bytes:
        """Index a held page under a unique private key and return it.

        A private entry gives a page the cached page's life (release puts
        it in the LRU, evictable under pressure, reclaimable by key) but
        is never shared: the key is a counter tag, never a chain hash, so
        ``match_prefix`` cannot reach it. Preemption retains a hybrid
        request's own K/V pages this way (their contents depend on the
        request's recurrent state, not on its tokens alone): a state
        snapshot and the reclaimed pages resume it without recompute."""
        if self._ref.get(page, 0) <= 0:
            raise ValueError(f"register_private of unheld page {page}")
        if page in self._by_page:
            raise ValueError(f"page {page} is already registered")
        self._priv_ctr += 1
        key = b"priv:%d" % self._priv_ctr
        e = CacheEntry(page, key, key, np.empty(0, np.int32))
        self._index[key] = e
        self._children.setdefault(key, []).append(e)
        self._by_page[page] = e
        return key

    def reclaim_private(self, keys) -> Optional[List[int]]:
        """All-or-nothing reclaim of ``register_private`` entries. When
        every key survived eviction: each page is held again (refcount 0
        -> 1, out of the LRU), its private entry dropped (a plain held
        page again), and the pages come back in key order. When any was
        evicted the set is useless (the snapshot's state covers exactly
        the whole prefix): the survivors leave the index and go back to
        the free list, and the answer is None (the caller recomputes)."""
        if any(k not in self._index for k in keys):
            for k in keys:
                e = self._index.get(k)
                if e is None:
                    continue
                self._drop_entry(e)
                if e.page in self._lru:
                    self._lru.pop(e.page)
                    self._tier_free(e.page)
                    self._free.append(e.page)
            return None
        pages = []
        for k in keys:
            e = self._index[k]
            self._acquire_one(e.page)
            self._drop_entry(e)
            pages.append(e.page)
        return pages

    @staticmethod
    def pages_for(n_tokens: int, page_size: int) -> int:
        """Pages needed to hold n_tokens."""
        return -(-max(n_tokens, 0) // page_size)


# ------------------------------------------------------------ fetch queue

class FetchQueue:
    """Bounded queue of host-to-device page fetches over a tiered
    PagePool.

    ``request(page)`` claims a staging frame (``promote_begin``) and
    starts the engine's copy, ``copy_fn(page, frame)``, which returns an
    event recorded after the copy on the engine's copy stream (None where
    the copy is done on return, on the CPU). The queue holds at most
    ``pool.max_inflight`` fetches; requesting past it completes the oldest
    first, so issue order is landing order. Completing a fetch makes the
    caller's (compute) stream wait on its event, so every later step reads
    the frame after the copy landed, then marks the page RESIDENT.

    ``drain()`` completes every outstanding fetch: the barrier before the
    frame table is rebuilt for the next step. Under an injected
    ``dma_timeout`` the fetch is aborted and copied again (not faultable:
    this is the fallback), counted in ``n_sync_fallback``.
    """

    def __init__(self, pool: PagePool, copy_fn, faults=None):
        self.pool = pool
        self._copy = copy_fn            # copy_fn(page, frame) -> event
        self._faults = faults
        self._pending: "collections.deque[Tuple[int, object]]" = \
            collections.deque()
        self.n_issued = 0
        self.n_sync_fallback = 0

    def request(self, page: int) -> bool:
        """Start fetching a HOST page; False when no staging frame could be
        claimed (frame pressure or hbm_oom_on_promote): the caller runs
        its demote, retry or defer ladder."""
        if self._pending and len(self._pending) >= self.pool.max_inflight:
            self._complete(*self._pending.popleft())
        frame = self.pool.promote_begin(page)
        if frame is None:
            return False
        self._pending.append((page, self._copy(page, frame)))
        self.n_issued += 1
        return True

    @staticmethod
    def land(event) -> None:
        """Order the current stream's later work after a copy's event."""
        if event is not None:
            event.wait()

    def _complete(self, page: int, event) -> None:
        # the copy was issued whatever the fault says: its frame may go
        # back to the free list below, so later writes to it must come
        # after it
        self.land(event)
        if self._faults is not None and self._faults.hit("dma_timeout",
                                                         page):
            self.pool.promote_abort(page)
            frame = self.pool.promote_begin(page, faultable=False)
            if frame is None:       # the abort above freed budget
                raise RuntimeError(
                    f"sync fallback could not claim a frame for {page}")
            self.land(self._copy(page, frame))
            self.n_sync_fallback += 1
        self.pool.promote_complete(page)

    def drain(self) -> None:
        """Complete every outstanding fetch."""
        while self._pending:
            self._complete(*self._pending.popleft())

    @property
    def in_flight(self) -> int:
        return len(self._pending)
