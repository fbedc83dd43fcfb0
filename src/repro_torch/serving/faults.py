"""Deterministic fault injection and the per-tick invariant auditor
(counterpart of ``repro.serving.faults``, kept as the port's own copy).

The serving stack consults a **seeded FaultPlan** at fixed sites, so every
failure mode the engine claims to survive reproduces bit for bit:

  pool_exhaustion  PagePool.available_pages reads 0 this tick: admission
                   and growth see a full pool and run their pressure paths.
  alloc_fail       PagePool.alloc returns None although pages exist.
  nan_logits       one slot's decode logits row is poisoned to NaN; the
                   engine must quarantine (FAIL) that slot alone.
  slot_corrupt     one live slot's host page list is silently corrupted
                   (its tail entry repointed at another slot's page); the
                   auditor must turn it into an AuditError.
  kernel_fail      the kernel decode step raises this tick; on a CPU engine
                   the scheduler steps down to the plain gathered path
                   (core/dispatch.py). A CUDA engine has no floor to fall
                   to and refuses a plan that can fire this site.
  dma_timeout      an in-flight host->device page fetch never lands; the
                   fetch queue repairs it with a second copy, counted, and
                   the decode stream must not change.
  hbm_oom_on_promote
                   PagePool.promote_begin finds no frame although the
                   accounting says one exists; the engine walks its
                   demote-retry-defer ladder.

A site fires from ``blake2b(seed, site, tick, unit)`` against its rate (no
RNG state: two runs with the same plan inject the same faults), or from an
explicit ``at={site: {tick | (tick, unit), ...}}`` schedule.
``FaultPlan.parse`` reads the CLI spec, e.g.
``"seed=3,nan_logits=0.05,alloc_fail=0.1,slot_corrupt@17"``.

The **auditor** (:func:`audit_engine`) re-derives the pool's accounting
every tick and checks it against the scheduler's slots and page table:

  A. partition      every non-trash page is in exactly one of {free list,
                    cached LRU, held (refcount >= 1)}
  B. holder balance a held page's refcount equals the slot references
                    (pages retained private across a preemption sit in
                    the LRU at refcount 0)
  C. no wild refs   no slot references the trash page, an out-of-range
                    page or a free page
  D. share safety   a page two slots reference is publicly registered,
                    never a private retained entry
  E. table mirror   the host page table rows equal the slot page lists
  F. LRU sanity     every LRU page is registered and unreferenced

and for tiered pools:

  G. tier partition every non-free page is in exactly one of {RESIDENT,
                    HOST, IN_FLIGHT}; frames partition into free and
                    mapped, none mapped twice, all in [1, device_pages)
  H. tier safety    pinned pages are RESIDENT; each recorded tail pin is
                    that slot's tail and a real pin; the engine holds host
                    bytes for every HOST and IN_FLIGHT page
  I. fetch budget   the in-flight set stays within the queue's budget

A violation raises :class:`AuditError` naming the invariant.
"""
from __future__ import annotations

import hashlib
from collections import Counter
from typing import Dict, Iterable, Optional, Set, Tuple

import numpy as np


class FaultInjected(RuntimeError):
    """Raised by injection shims standing in for a real failure (a kernel
    step that aborts) so recovery paths can be driven in tests."""


class AuditError(AssertionError):
    """A serving invariant does not hold. AssertionError subclass so test
    harnesses that expect assertion semantics treat it naturally, but it
    is raised unconditionally (``python -O`` keeps the guard)."""


class FaultPlan:
    """Seeded, deterministic fault schedule.

    rates  {site: probability in [0, 1]} — site fires at a tick/unit when
           the hash of (seed, site, tick, unit) falls below the rate.
    at     {site: {tick, ... | (tick, unit), ...}} — point schedule; a
           bare tick fires for every unit that consults the site then.

    ``advance(tick)`` is called by the engine at the top of each tick;
    ``hit(site, unit)`` is what the instrumented sites consult. Each
    distinct (site, tick, unit) is counted at most once in ``counts`` no
    matter how often it is consulted within the tick, so the counters
    read as "faults injected", not "times asked".
    """

    SITES = ("pool_exhaustion", "alloc_fail", "nan_logits",
             "slot_corrupt", "kernel_fail", "dma_timeout",
             "hbm_oom_on_promote")

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 at: Optional[Dict[str, Iterable]] = None):
        rates = dict(rates or {})
        at = {k: set(v) for k, v in (at or {}).items()}
        for site in list(rates) + list(at):
            if site not in self.SITES:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"have {self.SITES}")
        self.seed = int(seed)
        self.rates = rates
        self.at = at
        self.counts: Counter = Counter()
        self._tick = 0
        self._fired: Set[Tuple[str, int, int]] = set()

    def advance(self, tick: int) -> None:
        self._tick = int(tick)

    def _u(self, site: str, tick: int, unit: int) -> float:
        h = hashlib.blake2b(
            f"{self.seed}:{site}:{tick}:{unit}".encode(), digest_size=8)
        return int.from_bytes(h.digest(), "big") / 2.0 ** 64

    def hit(self, site: str, unit: int = 0) -> bool:
        """Does ``site`` fire for ``unit`` at the current tick?"""
        tick = self._tick
        fires = False
        sched = self.at.get(site)
        if sched and (tick in sched or (tick, unit) in sched):
            fires = True
        rate = self.rates.get(site, 0.0)
        if not fires and rate > 0.0:
            fires = self._u(site, tick, unit) < rate
        if fires:
            key = (site, tick, unit)
            if key not in self._fired:
                self._fired.add(key)
                self.counts[site] += 1
        return fires

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """CLI spec -> plan. Comma-separated terms: ``seed=N``,
        ``site=rate`` and/or ``site@tick`` (repeatable)."""
        seed, rates, at = 0, {}, {}
        for term in (t.strip() for t in spec.split(",") if t.strip()):
            if term.startswith("seed="):
                seed = int(term[5:])
            elif "@" in term:
                site, tick = term.split("@", 1)
                at.setdefault(site, set()).add(int(tick))
            elif "=" in term:
                site, rate = term.split("=", 1)
                rates[site] = float(rate)
            else:
                raise ValueError(f"bad fault term {term!r} in {spec!r}")
        return cls(seed, rates, at)

    def describe(self) -> str:
        parts = [f"seed={self.seed}"]
        parts += [f"{s}={r}" for s, r in sorted(self.rates.items())]
        parts += [f"{s}@{t}" for s, ts in sorted(self.at.items())
                  for t in sorted(ts, key=str)]
        return ",".join(parts)


# ----------------------------------------------------------------- audit

def _fail(invariant: str, msg: str):
    raise AuditError(f"[invariant {invariant}] {msg}")


def audit_pool(pool) -> None:
    """Invariants A + F on the pool alone (no scheduler context)."""
    n = pool.n_pages
    free = set(pool.free_page_ids())
    lru = set(pool.lru_page_ids())
    held = pool.holders()
    for name, s in (("free list", free), ("LRU", lru), ("held", held)):
        bad = [p for p in s if not 1 <= p < n]
        if bad:
            _fail("A", f"{name} contains out-of-range pages {bad}")
    if free & lru or free & set(held) or lru & set(held):
        _fail("A", "free/LRU/held page sets overlap: "
                   f"free&lru={free & lru} free&held={free & set(held)} "
                   f"lru&held={lru & set(held)}")
    every = free | lru | set(held)
    missing = set(range(1, n)) - every
    if missing:
        _fail("A", f"pages {sorted(missing)} leaked: neither free, "
                   "cached, nor held")
    zero = [p for p, r in held.items() if r <= 0]
    if zero:
        _fail("A", f"held pages with non-positive refcount {zero}")
    for p in lru:
        if not pool.is_registered(p):
            _fail("F", f"LRU page {p} is not registered")

    # G: tier partition (tiered pools only)
    if getattr(pool, "tiered", False):
        resident = set(pool.resident_page_ids())
        host = set(pool.host_page_ids())
        inflight = set(pool.inflight_page_ids())
        live = lru | set(held)
        if resident & host or resident & inflight or host & inflight:
            _fail("G", "tier sets overlap: "
                       f"r&h={resident & host} r&i={resident & inflight} "
                       f"h&i={host & inflight}")
        untiered = live - (resident | host | inflight)
        if untiered:
            _fail("G", f"pages {sorted(untiered)} are held or cached but "
                       "in no tier")
        ghosts = (resident | host | inflight) - live
        if ghosts:
            _fail("G", f"pages {sorted(ghosts)} carry tier state but are "
                       "neither held nor cached")
        fmap = pool.frame_map()
        frames = list(fmap.values())
        free_frames = set(pool.free_frame_ids())
        if len(frames) != len(set(frames)):
            dup = [f for f, c in Counter(frames).items() if c > 1]
            _fail("G", f"frames {dup} mapped by more than one page")
        for p, f in fmap.items():
            if not 1 <= f < pool.device_pages:
                _fail("G", f"page {p} mapped to out-of-range frame {f}")
            if f in free_frames:
                _fail("G", f"page {p} mapped to frame {f} which is on "
                           "the free-frame list")
        if set(fmap) != resident | inflight:
            _fail("G", "frame map keys != RESIDENT ∪ IN_FLIGHT: "
                       f"{sorted(set(fmap) ^ (resident | inflight))}")
        missing_f = set(range(1, pool.device_pages)) - free_frames \
            - set(frames)
        if missing_f:
            _fail("G", f"frames {sorted(missing_f)} leaked: neither free "
                       "nor mapped")


def audit_engine(engine) -> None:
    """Full per-tick audit of a PagedServingEngine: pool invariants plus
    the scheduler's slot bookkeeping and its page table, which lives in
    host memory. O(pages + slots * max_pages) host work, no device
    transfer."""
    pool = engine.pool
    audit_pool(pool)
    n = pool.n_pages
    held = pool.holders()
    free = set(pool.free_page_ids())

    # B + C: slot references of every page-table group, counted against
    # refcounts
    holders: Counter = Counter()
    for gi in range(engine.n_groups):
        for slot, pages in enumerate(engine._group_pages(gi)):
            for p in pages:
                if p is None:
                    continue
                if not isinstance(p, (int, np.integer)) or not 1 <= p < n:
                    _fail("C", f"slot {slot} group {gi} references wild "
                               f"page {p!r}")
                if p in free:
                    _fail("C", f"slot {slot} group {gi} references page "
                               f"{p} which is on the free list")
                holders[int(p)] += 1
    for p, cnt in holders.items():
        if held.get(p, 0) != cnt:
            _fail("B", f"page {p}: refcount {held.get(p, 0)} != "
                       f"{cnt} slot reference(s)")
    unheld = [p for p in held if holders.get(p, 0) == 0]
    if unheld:
        _fail("B", f"pages {sorted(unheld)} hold references but no slot "
                   "lists them")

    # D: multi-slot pages must be publicly registered (prefix-shareable)
    for p, cnt in holders.items():
        if cnt > 1:
            if not pool.is_registered(p):
                _fail("D", f"page {p} shared by {cnt} slots but not "
                           "registered in the prefix index")
            if pool.is_private(p):
                _fail("D", f"page {p} shared by {cnt} slots is a "
                           "*private* retained entry")

    # E: every group's table mirrors its host bookkeeping (recycled
    # entries read the trash page)
    for gi, tbl in enumerate(engine._group_tables()):
        table = np.asarray(tbl)
        for slot, pages in enumerate(engine._group_pages(gi)):
            want = np.zeros((engine.max_pages,), np.int32)
            for i, p in enumerate(pages):
                want[i] = 0 if p is None else p
            if not np.array_equal(table[slot], want):
                _fail("E", f"slot {slot} group {gi} table "
                           f"{table[slot].tolist()} != host pages "
                           f"{want.tolist()}")

    # H + I: tiered-engine safety (tail residency, host bytes, budget)
    if getattr(pool, "tiered", False):
        host_bytes = getattr(engine, "_host_kv", {})
        for p in set(pool.host_page_ids()) | set(pool.inflight_page_ids()):
            if p not in host_bytes:
                _fail("H", f"page {p} is off-device but the engine holds "
                           "no host bytes for it")
        for p in pool.pinned_page_ids():
            if pool.tier_of(p) != "resident":
                _fail("H", f"pinned page {p} is {pool.tier_of(p)}, "
                           "not RESIDENT")
        # pins are best-effort under frame starvation (the decode phase
        # re-ensures residency and defers frame-starved slots), so the
        # invariant is *ledger consistency*, not universal coverage: every
        # pin the engine records must name that slot's current tail and
        # be a real pin in the pool
        for slot, page in getattr(engine, "_pinned_tail", {}).items():
            live = [p for p in engine.slot_pages[slot] if p is not None]
            tail = int(live[-1]) if live else None
            if tail != page:
                _fail("H", f"slot {slot} pins page {page} but its tail "
                           f"is {tail} — a stale pin blocks demotion "
                           "forever")
            if not pool.is_pinned(page):
                _fail("H", f"slot {slot} records a pin on page {page} "
                           "the pool does not hold")
        inflight = pool.inflight_page_ids()
        if len(inflight) > pool.max_inflight:
            _fail("I", f"{len(inflight)} fetches in flight exceeds the "
                       f"budget of {pool.max_inflight}")
