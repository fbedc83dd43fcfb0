"""Paged serving engine: continuous batching over a refcounted page pool
(counterpart of ``repro.serving.scheduler.PagedServingEngine``, the
attention families' engine).

The dense engine's ``(n_slots, Smax, ...)`` cache becomes the shared pool
of serving/paged_cache.py, and a tick runs three policy-driven phases
(serving/policy.py):

  admission  waiting requests take free slots in policy order (FIFO or
             priority classes); under the priority policy a strictly more
             urgent waiter may preempt the least urgent running request
             for its slot
  prefill    mid-prefill slots advance by fixed-size chunks until the
             per-tick prefill token budget is spent
  decode     one batched ``lm.decode_step`` over the selected live slots
             (at most the decode token budget). Gather-packed by default:
             the live slots are compacted into a batch padded to a power
             of two (``slot_idx``), so a tick at low occupancy runs the
             kernels at fewer rows; when the bucket would not be narrower
             than ``n_slots`` the step runs full width, masked: unselected
             rows get all-zero table rows and so read and write only the
             trash page

Prefix caching (on by default, for configs whose components are all
``shareable``): full prompt pages are registered in the pool's chain-hash
index as prefill writes them. A later request whose prompt starts with
the same tokens acquires those pages and starts prefill at its first
uncached token. When the match ends inside a page, that tail page is
shared read-only and copied on write (``lm.copy_cache_page``) right before
this request's first write lands in it, unless the request is its only
reader, which then takes it over. Registered pages are never written
again. Unreferenced cached pages form an LRU that ``alloc`` reclaims
before the scheduler preempts anyone.

Under memory pressure the scheduler preempts the least urgent request
(vLLM's recompute policy: under FIFO an older request is never evicted
for a younger one): its references are released (shared pages survive
for their other readers) and it is requeued with its generated tokens
folded into the prompt; greedy decoding then reproduces its continuation.
With ``shed_after`` a request preempted that many times ends SHED with a
retry-after hint instead. ``n_pages - 1 >=`` the per-request page bound is
checked at construction, so a lone request can always finish and
preemption cannot livelock.

Host state: page tables, positions and last tokens live in host numpy and
change in place between ticks. Each decode tick uploads the (packed or
masked) table, the tokens, the positions and the slot ids in one
non-blocking copy from pinned memory (a synchronous copy from pageable
memory would make the host wait for the card), and reads back the sampled
tokens and the finite mask in one device-to-host copy: one host sync per
tick, counted in ``n_host_syncs``. A copy-on-write is an in-place copy on
the card at host page ids: no sync.

Not ported yet, and refused when asked for (ROADMAP queue 1 item 7):
fault injection and the auditor, the trace guard (it seals compiled
programs, which the eager port has none of), the tiered pool, page-table
groups, and state snapshots and retention (these two come with the
window and state families, ROADMAP queue 1 item 8). The reference's
degradation ladder (re-running a failed kernel step on the XLA path) is
deliberately absent: on the card a failed kernel raises.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serving import cache_spec as CS
from repro_torch.serving import lifecycle as LC
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import (Request, context_cap,
                                        oversized_reason, sample_next)
from repro_torch.serving.lifecycle import Status
from repro_torch.serving.paged_cache import PagePool
from repro_torch.serving.policy import SchedulerPolicy, TickBudget, make_policy

PAGED_POLICIES = ("full", "exact_topk", "loki", "loki_block")


class PagedServingEngine:
    """Continuous-batching engine over a paged KV-cache (dense family).

    n_slots        decode batch width (concurrent running requests)
    smax           logical context cap per request (rounded up to pages)
    page_size      tokens per page; defaults to ``cfg.loki.block_size`` so
                   pages coincide with the kernels' blocks
    n_pages        physical pool size incl. the trash page; defaults to
                   every slot at its page bound (pass less to exercise
                   pressure and preemption)
    prefill_chunk  prompt tokens per chunk (fixed size, padded)
    policy         'fifo' | 'priority' | a SchedulerPolicy instance
    prefill_budget prompt tokens computed per tick (default: one chunk)
    decode_budget  live slots decoded per tick (default: all of them)
    prefix_cache   share identical prompt-prefix pages across requests
                   (bypassed, with ``prefix_cache_reason``, for configs
                   with unshareable components)
    admission      'strict' (default) FAILs requests whose prompt +
                   max_new can never fit smax at submit(); 'lenient'
                   truncates the prompt and caps generation
    clock          zero-arg wall clock stamping request times and driving
                   deadline expiry
    shed_after     preemptions a request survives before it is shed
                   (terminal SHED with a retry-after hint) instead of
                   requeued; None (default) never sheds
    nan_guard      FAIL a request whose decode logits go non-finite, alone
    packed         gather-packed decode: the tick's live slots compacted
                   into a batch padded to a power-of-two bucket; False
                   always runs full width, masked
    device         where the pool lives: the card unless "cpu" is asked
                   for; ``params`` must be on the same device

    The reference's ``faults``, ``audit``, ``trace_guard`` and
    ``device_pages`` are taken at their off values and raise otherwise
    (ROADMAP queue 1 item 7). ``donate`` has no effect: the port always
    updates the pools in place. ``max_inflight`` belongs to the tiered
    pool.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 smax: int = 512, page_size: Optional[int] = None,
                 n_pages: Optional[int] = None, prefill_chunk: int = 32,
                 eos_id: Optional[int] = None, greedy: bool = True,
                 backend: Optional[str] = None,
                 policy="fifo", prefill_budget: Optional[int] = None,
                 decode_budget: Optional[int] = None,
                 prefix_cache: bool = True, admission: str = "strict",
                 clock=None, shed_after: Optional[int] = None,
                 faults=None, audit: bool = False, nan_guard: bool = True,
                 trace_guard=None, donate: bool = True,
                 device_pages: Optional[int] = None,
                 max_inflight: int = 2, packed: bool = True, device=None):
        del donate, max_inflight
        unported = [name for name, on in (
            ("faults", faults is not None), ("audit", audit),
            ("trace_guard", trace_guard is not None),
            ("device_pages", device_pages is not None)) if on]
        if unported:
            raise NotImplementedError(
                f"PagedServingEngine: {', '.join(unported)} not ported yet "
                "(ROADMAP queue 1 item 7)")
        if backend is not None:
            cfg = cfg.replace(
                loki=dataclasses.replace(cfg.loki, backend=backend))
        lm.check_family(cfg)
        CS.assert_pageable(cfg)
        if cfg.attn_policy() not in PAGED_POLICIES:
            raise ValueError(
                f"policy {cfg.attn_policy()!r} cannot serve from a paged "
                f"cache (supported: {PAGED_POLICIES}); use ServingEngine")
        if admission not in ("strict", "lenient"):
            raise ValueError(f"admission={admission!r}; "
                             "use 'strict' or 'lenient'")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.page_size = page_size or cfg.loki.block_size
        self.max_pages = -(-smax // self.page_size)
        self.smax = self.max_pages * self.page_size      # logical cap
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.eos_id, self.greedy = eos_id, greedy
        self.nan_guard = nan_guard
        self.admission = admission
        self.shed_after = shed_after
        self.packed = bool(packed)
        self._clock = clock or time.time
        self.policy: SchedulerPolicy = make_policy(policy)
        self.budget = TickBudget(
            prefill_tokens=prefill_budget or prefill_chunk,
            decode_tokens=decode_budget or n_slots)
        shareable, why = CS.prefix_shareable(cfg)
        self.prefix_caching = bool(prefix_cache and shareable)
        # why the cache is bypassed although asked for ("" otherwise)
        self.prefix_cache_reason = why if prefix_cache else ""
        self.req_budget = CS.request_page_budget(cfg, self.smax,
                                                 self.page_size)
        if n_pages is None:
            n_pages = 1 + max(n_slots * self.req_budget, 1)
        if n_pages - 1 < self.req_budget:
            raise ValueError(
                f"pool of {n_pages} pages cannot hold one full request "
                f"({self.req_budget} pages); raise n_pages or lower smax")

        self.pool = PagePool(n_pages, self.page_size)
        self.cache = lm.init_paged_cache(cfg, n_pages, self.page_size,
                                         torch.float32, n_slots=n_slots,
                                         device=self.device)
        self.page_table = np.zeros((n_slots, self.max_pages), np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.live = np.zeros((n_slots,), bool)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        # slot -> logical index of a shared tail page the slot must copy
        # on write before its first write lands there (full-page hits need
        # none: the slot never writes below its first uncached token)
        self._cow_pending: Dict[int, int] = {}
        # prefix-cache registration cursor per slot: the next full prompt
        # page to publish and the chain hash of everything before it
        self._reg_next: Dict[int, int] = {}
        self._reg_parent: Dict[int, bytes] = {}
        # slots mid-prefill: slot -> index of the next prompt token to feed
        self._prefill_at: Dict[int, int] = {}
        # admission order, oldest first; the policy key decides urgency
        self._admit_order: List[int] = []
        self._queue: Deque[Request] = collections.deque()
        # generated tokens already folded into req.prompt by preemptions
        self._folded: Dict[int, int] = {}
        # submission order, kept across preemption: the tie-break inside
        # a policy class
        self._arrival: Dict[int, int] = {}
        self._arrival_seq = 0
        self._last_decoded = np.zeros((n_slots,), np.int64)
        self.lifecycle_counts: Dict[str, int] = {}
        self.ticks = 0
        self.n_decode_steps = 0
        self.n_prefill_chunks = 0
        self.n_prefill_computed_tokens = 0
        self.n_preempted = 0
        self.n_quarantined = 0
        self.n_shed = 0
        self.n_cow_copies = 0
        self.n_host_syncs = 0
        self.n_packed_ticks = 0
        self.n_masked_ticks = 0
        self.n_packed_rows_saved = 0       # (n_slots - bucket) summed
        self.peak_slot_pages = 0
        self.n_stalled = 0
        self.stalled_rids: List[int] = []

    # ------------------------------------------------------------ host->card

    def _upload(self, flat: np.ndarray):
        """One int32 host array on the engine's device: from pinned memory
        without blocking on the card (PyTorch's pinned allocator keeps the
        buffer until the copy has run), a private copy on the CPU."""
        t = torch.from_numpy(flat)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # ------------------------------------------------------------ lifecycle

    def _key(self, req: Request):
        return self.policy.sort_key(req, self._arrival[id(req)])

    def _terminal(self, req: Request, status: Status, detail: str = "",
                  retry_after: float = 0.0) -> None:
        LC.transition(req, status, detail)
        req.t_done = self._clock()
        req.retry_after = retry_after
        self.lifecycle_counts[str(status)] = \
            self.lifecycle_counts.get(str(status), 0) + 1
        self._folded.pop(id(req), None)
        self._arrival.pop(id(req), None)

    def _retry_after_hint(self) -> float:
        """SHED hint: ticks to drain the current backlog at the decode
        budget, about when resubmitting stops being hopeless."""
        live = [r for r in self.slot_req if r is not None]
        rem = sum(max(r.max_new - len(r.out), 1)
                  for r in list(self._queue) + live)
        return float(-(-rem // max(self.budget.decode_tokens, 1)))

    def cancel(self, rid: int, detail: str = "client cancel") -> bool:
        """Terminate a request by id, queued or running: its references
        are released as a finished request's are (shared prefix pages
        survive for their other readers). False when no live request
        carries this rid."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                self._terminal(req, Status.CANCELLED, detail)
                return True
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is not None and req.rid == rid:
                self._terminal(req, Status.CANCELLED, detail)
                self._release_slot(slot)
                return True
        return False

    def _expire_deadlines(self) -> None:
        now = self._clock()
        for req in list(self._queue):
            why = LC.breach(req.deadline, now, req.t_submit, bool(req.out))
            if why:
                self._queue.remove(req)
                self._terminal(req, Status.TIMED_OUT, why)
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None:
                continue
            why = LC.breach(req.deadline, now, req.t_submit, bool(req.out))
            if why:
                self._terminal(req, Status.TIMED_OUT, why)
                self._release_slot(slot)

    # ---------------------------------------------------------------- admin

    def submit(self, req: Request) -> None:
        req.t_submit = self._clock()
        if self.admission == "strict":
            why = oversized_reason(len(req.prompt), req.max_new, self.smax)
            if why:
                self._terminal(req, Status.FAILED, f"oversized: {why}")
                return
        self._arrival[id(req)] = self._arrival_seq
        self._arrival_seq += 1
        self._queue.append(req)

    def _pop_next(self) -> Request:
        """Most urgent waiting request; a re-admission keeps its arrival,
        so under FIFO a preempted request resumes ahead of later ones."""
        qi = min(range(len(self._queue)),
                 key=lambda i: self._key(self._queue[i]))
        req = self._queue[qi]
        del self._queue[qi]
        return req

    def _admit_into(self, slot: int, req: Request) -> None:
        LC.transition(req, Status.PREFILL)
        toks = req.prompt.astype(np.int32)
        if not req.out:
            cap = context_cap(self.smax, req.max_new)
            if len(toks) > cap:
                toks = toks[-cap:]
        # else: re-admission after a preemption; the folded prompt was all
        # cached once, so truncating it again would drop kept context
        req.prompt = toks
        self.slot_req[slot] = req
        self.slot_pages[slot] = []
        self._cow_pending.pop(slot, None)
        self._admit_order.append(slot)
        self.pos[slot] = 0
        n_pre = len(toks) - 1              # the last token goes to decode
        start = 0
        self._reg_next[slot] = 0
        self._reg_parent[slot] = PC.ROOT_KEY
        if self.prefix_caching and n_pre > 0:
            pages, cov, tail, parent = self.pool.match_prefix(toks, n_pre)
            if pages:
                self.page_table[slot, :len(pages)] = pages
                self.slot_pages[slot] = list(pages)
                if tail:
                    # a shared partial tail: read-only until this slot's
                    # first write into it forces a copy
                    self._cow_pending[slot] = len(pages) - 1
                self._reg_next[slot] = len(pages) - (1 if tail else 0)
                self._reg_parent[slot] = parent
                self.peak_slot_pages = max(self.peak_slot_pages,
                                           len(pages))
                start = cov
        if n_pre > start:
            self._prefill_at[slot] = start
        else:
            self._ready(slot)

    def _ready(self, slot: int) -> None:
        """Prefill finished: the slot joins the decode batch."""
        req = self.slot_req[slot]
        LC.transition(req, Status.DECODE)
        self._prefill_at.pop(slot, None)
        self.pos[slot] = len(req.prompt) - 1
        self.last_tok[slot] = int(req.prompt[-1])
        self.live[slot] = True

    def _release_slot(self, slot: int) -> None:
        """Drop a slot's page references (a shared page survives for its
        other readers, a registered one parks in the LRU) and point its
        table at the trash page, so the batched step's unconditional write
        cannot touch reallocated pages. No status change (callers own
        that)."""
        self.pool.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self._cow_pending.pop(slot, None)
        self._reg_next.pop(slot, None)
        self._reg_parent.pop(slot, None)
        self.page_table[slot] = 0
        self.pos[slot] = 0
        self.live[slot] = False
        self.slot_req[slot] = None
        self._prefill_at.pop(slot, None)
        self._admit_order.remove(slot)

    def _preempt(self, slot: int) -> None:
        """Recompute preemption: fold the tokens generated since the last
        fold into the prompt, release the slot's references and requeue
        the request at the front; greedy decoding reproduces the rest.
        With ``shed_after``, a request preempted that many times is shed
        instead: terminal SHED with a retry-after hint, its references
        released, so sustained pressure ends in an answer to the client
        rather than in recompute churn."""
        req = self.slot_req[slot]
        req.n_preempts += 1
        if (self.shed_after is not None
                and req.n_preempts >= self.shed_after):
            self.n_preempted += 1
            self.n_shed += 1
            self._terminal(req, Status.SHED,
                           f"pool pressure: preempted {req.n_preempts}x",
                           retry_after=self._retry_after_hint())
            self._release_slot(slot)
            return
        folded = self._folded.get(id(req), 0)
        fresh = req.out[folded:]
        if fresh:
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(fresh, np.int32)])
            self._folded[id(req)] = len(req.out)
        LC.transition(req, Status.QUEUED, "preempted")
        self._release_slot(slot)
        self._queue.appendleft(req)
        self.n_preempted += 1

    def _make_room(self, need: int, protect: int) -> bool:
        """Preempt strictly less urgent requests holding pages (the least
        urgent first) until ``need`` pages are available. Cached pages
        count as available and ``alloc`` evicts them first, so eviction
        always comes before preemption. True iff the pages are there."""
        while self.pool.available_pages < need:
            mine = self._key(self.slot_req[protect])
            candidates = [s for s in self._admit_order
                          if s != protect and self.slot_pages[s]
                          and self._key(self.slot_req[s]) > mine]
            if not candidates:
                return False
            # prefer victims whose release frees pages (sole holders)
            gainful = [s for s in candidates
                       if any(self.pool.refcount(p) == 1
                              for p in self.slot_pages[s])]
            self._preempt(max(
                gainful or candidates,
                key=lambda s: self.policy.shed_key(
                    self.slot_req[s], self._arrival[id(self.slot_req[s])],
                    self.slot_req[s].n_preempts)))
        return True

    def _grow_to(self, slot: int, n_tokens: int) -> bool:
        """Ensure the slot's table covers logical positions
        [0, n_tokens), preempting less urgent requests if the pool is
        short. False when it cannot."""
        want = PagePool.pages_for(n_tokens, self.page_size)
        need = want - len(self.slot_pages[slot])
        if need <= 0:
            return True
        if not self._make_room(need, protect=slot):
            return False
        pages = self.pool.alloc(need)
        base = len(self.slot_pages[slot])
        self.page_table[slot, base:base + need] = pages
        self.slot_pages[slot].extend(pages)
        self.peak_slot_pages = max(self.peak_slot_pages,
                                   len(self.slot_pages[slot]))
        return True

    def _resolve_cow(self, slot: int) -> bool:
        """Copy-on-write of a shared tail page, right before this slot's
        first write could land in it. The page's only reader takes it over
        in place (its index entry goes: the write is about to change it);
        a page another request still reads is copied to a fresh page, the
        table entry repointed and the old page released to its other
        readers. False when the pool cannot give the copy a page."""
        idx = self._cow_pending.get(slot)
        if idx is None:
            return True
        old = self.slot_pages[slot][idx]
        if self.pool.refcount(old) > 1 and not self._make_room(
                1, protect=slot):
            return False
        # (making room may have preempted the co-reader)
        if self.pool.refcount(old) == 1:
            self.pool.deregister(old)
        else:
            new = self.pool.alloc(1)[0]
            lm.copy_cache_page(self.cfg, self.cache, old, new,
                               self.page_size)
            self.page_table[slot, idx] = new
            self.slot_pages[slot][idx] = new
            self.pool.release([old])
            self.n_cow_copies += 1
        del self._cow_pending[slot]
        return True

    def _register_ready_pages(self, slot: int) -> None:
        """Publish the full prompt pages prefill has written completely.
        Only pages wholly covered by prefilled prompt tokens register; the
        page that receives decode writes never does, so registered pages
        are immutable and safe to share."""
        if not self.prefix_caching:
            return
        toks = self.slot_req[slot].prompt
        written = self._prefill_at.get(slot, len(toks) - 1)
        ps = self.page_size
        i = self._reg_next[slot]
        while (i + 1) * ps <= written:
            self._reg_parent[slot] = self.pool.register(
                self.slot_pages[slot][i], self._reg_parent[slot],
                toks[i * ps:(i + 1) * ps])
            i += 1
        self._reg_next[slot] = i

    # --------------------------------------------------------------- phases

    def _admission_phase(self) -> None:
        """Fill free slots in policy order; then, where the policy allows
        it, let a strictly more urgent waiter preempt the least urgent
        running request for its slot (the running keys strictly decrease
        at every swap, so this ends)."""
        while self._queue:
            free = [s for s in range(self.n_slots)
                    if self.slot_req[s] is None]
            if not free:
                break
            self._admit_into(free[0], self._pop_next())
        if not self.policy.preempt_for_admission:
            return
        while self._queue:
            qi = min(range(len(self._queue)),
                     key=lambda i: self._key(self._queue[i]))
            cand = self._queue[qi]
            worse = [s for s in self._admit_order
                     if self._key(self.slot_req[s]) > self._key(cand)]
            if not worse:
                return
            del self._queue[qi]
            self._preempt(max(worse,
                              key=lambda s: self._key(self.slot_req[s])))
            slot = next(s for s in range(self.n_slots)
                        if self.slot_req[s] is None)
            self._admit_into(slot, cand)

    def _prefill_phase(self) -> None:
        """Advance mid-prefill slots, most urgent first, spending at most
        ``budget.prefill_tokens`` real prompt tokens this tick."""
        budget = self.budget.prefill_tokens
        slots = sorted([s for s in self._admit_order
                        if s in self._prefill_at],
                       key=lambda s: self._key(self.slot_req[s]))
        for slot in slots:
            while budget > 0 and slot in self._prefill_at:
                n = self._prefill_slot_chunk(slot)
                if n < 0:
                    break              # this slot is pool-contended; a
                budget -= max(n, 1)    # later one may still fit
            if budget <= 0:
                return

    def _prefill_slot_chunk(self, slot: int) -> int:
        """One fixed-size chunk of one slot's prompt. Returns the number
        of real tokens computed, or -1 when the pool is contended."""
        req = self.slot_req[slot]
        toks = req.prompt
        n_pre = len(toks) - 1              # the last token goes to decode
        start = self._prefill_at[slot]
        c = self.prefill_chunk
        n_valid = min(c, n_pre - start)
        # a shared tail page is copied before this chunk's first write
        # lands in it (start is the first uncached token)
        if not (self._resolve_cow(slot)
                and self._grow_to(slot, start + n_valid)):
            return -1
        chunk = np.zeros((c,), np.int32)
        chunk[:n_valid] = toks[start:start + n_valid]
        dev = self._upload(np.concatenate([chunk, self.page_table[slot]]))
        lm.prefill_chunk(self.params, self.cfg, self.cache, dev[:c][None],
                         start, n_valid, dev[c:], self.page_size)
        self.n_prefill_chunks += 1
        self._prefill_at[slot] = start + n_valid
        self.n_prefill_computed_tokens += n_valid
        self._register_ready_pages(slot)
        if start + n_valid >= n_pre:
            self._ready(slot)
        return n_valid

    def _decode_phase(self, rng: Optional[torch.Generator]) -> bool:
        if not self.live.any():
            return False
        # decode-budget selection: the policy's decode key picks the batch
        chosen = [int(s) for s in np.flatnonzero(self.live)]
        if len(chosen) > self.budget.decode_tokens:
            chosen.sort(key=lambda s: self.policy.decode_key(
                self.slot_req[s], self._arrival[id(self.slot_req[s])],
                int(self._last_decoded[s])))
            chosen = chosen[: self.budget.decode_tokens]
        sel = np.zeros((self.n_slots,), bool)
        sel[chosen] = True
        # each selected slot writes its new token this step: its target
        # page must exist and be its own (copy on write first); a slot
        # that cannot grow is the least urgent under pressure and preempts
        # itself
        for slot in chosen:
            if not self.live[slot]:
                continue                   # preempted by an earlier grow
            if not (self._resolve_cow(slot)
                    and self._grow_to(slot, int(self.pos[slot]) + 1)):
                self._preempt(slot)
        sel &= self.live
        if not sel.any():
            return False
        sidx = self._packed_order(sel)
        packed = sidx is not None
        if packed:
            self.n_packed_ticks += 1
            self.n_packed_rows_saved += self.n_slots - len(sidx)
        else:
            self.n_masked_ticks += 1
            sidx = np.arange(self.n_slots, dtype=np.int32)
        # rows not selected this step (idle, mid-prefill or over budget
        # slots, the packed batch's pad rows) get all-zero table rows, so
        # they read and write only the trash page
        rows, mp = len(sidx), self.max_pages
        pt = self.page_table[sidx] * sel[sidx, None].astype(np.int32)
        # the tick's one upload: table, tokens, positions (and slot ids)
        dev = self._upload(np.concatenate(
            [pt.ravel(), self.last_tok[sidx], self.pos[sidx]]
            + ([sidx] if packed else [])))
        o = rows * mp
        logits, self.cache = self._run_decode(
            dev[:o].view(rows, mp), dev[o:o + rows],
            dev[o + rows:o + 2 * rows], dev[o + 2 * rows:] if packed else None)
        nxt = sample_next(logits, greedy=self.greedy, rng=rng,
                          ticks=self.ticks)
        if self.nan_guard:
            nxt = torch.stack([nxt, torch.isfinite(logits).all(-1).to(
                torch.int32)])
        # the one device->host copy of the tick: the sampled tokens (and
        # the finite mask) drive every request's lifecycle on the host,
        # scattered back to their slots (pad rows land on unselected
        # slots, which nothing reads)
        host = nxt.cpu().numpy()
        self.n_host_syncs += 1
        nxt_np = np.zeros((self.n_slots,), host.dtype)
        nxt_np[sidx] = host[0] if self.nan_guard else host
        finite = None
        if self.nan_guard:
            finite = np.ones((self.n_slots,), host.dtype)
            finite[sidx] = host[1]
        self.n_decode_steps += 1
        self.pos += sel.astype(np.int32)
        self._last_decoded[sel] = self.ticks
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None or not sel[slot]:
                continue
            if finite is not None and not finite[slot]:
                self.n_quarantined += 1
                self._terminal(req, Status.FAILED,
                               "non-finite logits (slot quarantined)")
                self._release_slot(slot)
                continue
            tok = int(nxt_np[slot])
            req.out.append(tok)
            if len(req.out) == 1:
                req.t_first = self._clock()
            finished = (len(req.out) >= req.max_new
                        or (self.eos_id is not None and tok == self.eos_id)
                        or int(self.pos[slot]) >= self.smax - 1)
            if finished:
                self._terminal(req, Status.DONE)
                self._release_slot(slot)
            else:
                self.last_tok[slot] = tok
        return True

    def _packed_order(self, sel: np.ndarray):
        """This tick's gather-packed batch: its slot ids, the selected
        ones first, or None when it runs full width, masked: packing is
        off, or the bucket (the live count rounded up to a power of two,
        so a few batch shapes serve every occupancy) would not be narrower
        than ``n_slots``. Pad rows take distinct non-selected slot ids."""
        if not self.packed:
            return None
        live_idx = np.flatnonzero(sel)
        n_live = int(live_idx.size)
        bucket = 1 << max(n_live - 1, 0).bit_length()
        if bucket >= self.n_slots:
            return None
        pad = np.setdiff1d(np.arange(self.n_slots), live_idx)
        return np.concatenate([live_idx, pad[:bucket - n_live]]).astype(
            np.int32)

    def _run_decode(self, pt, tok, pos, sidx):
        """One batched decode step over the masked or packed table. No
        fallback: a kernel that fails on the card raises out of the
        tick."""
        return lm.decode_step(self.params, self.cfg, self.cache, tok, pos,
                              page_table=pt, page_size=self.page_size,
                              slot_idx=sidx)

    # ----------------------------------------------------------------- tick

    def tick(self, rng: Optional[torch.Generator] = None) -> None:
        self._expire_deadlines()
        self._admission_phase()
        self._prefill_phase()
        self._decode_phase(rng)
        self.ticks += 1

    @property
    def n_prefix_hit_tokens(self) -> int:
        """Prompt tokens served from cached pages (every match goes
        through the pool's ``match_prefix``, so its counter is the
        truth)."""
        return self.pool.n_hit_tokens

    def prefix_hit_rate(self) -> float:
        """Share of prefill-eligible prompt tokens served from cached
        pages instead of being computed."""
        total = self.n_prefix_hit_tokens + self.n_prefill_computed_tokens
        return self.n_prefix_hit_tokens / total if total else 0.0

    def run_until_done(self, max_ticks: int = 10_000,
                       rng: Optional[torch.Generator] = None) -> None:
        """Drive ticks to completion. Hitting ``max_ticks`` with work
        pending is a stall: every remaining request is TIMED_OUT and
        listed in ``stats()['stalled_rids']``."""
        for _ in range(max_ticks):
            if not self._queue and not self._admit_order:
                return
            self.tick(rng)
        detail = f"stalled: drain hit max_ticks={max_ticks}"
        for req in list(self._queue):
            self._queue.remove(req)
            self._terminal(req, Status.TIMED_OUT, detail)
            self.n_stalled += 1
            self.stalled_rids.append(req.rid)
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None:
                continue
            self._terminal(req, Status.TIMED_OUT, detail)
            self._release_slot(slot)
            self.n_stalled += 1
            self.stalled_rids.append(req.rid)

    def drain(self, max_ticks: int = 10_000,
              rng: Optional[torch.Generator] = None) -> None:
        self.run_until_done(max_ticks, rng)

    @property
    def bytes_per_page(self) -> int:
        """K and V bytes of one page of one layer under the layout (the
        per-page scales of a quantized layout aside)."""
        return CS.layer_specs(self.cfg)[0].attn.bytes_per_page(
            self.page_size)

    @property
    def pool_bytes(self) -> int:
        """Device bytes of every layer's pools and scale sidecars."""
        return sum(t.numel() * t.element_size()
                   for t in self.cache["layers"]["attn"].values())

    def stats(self) -> Dict[str, Any]:
        return {"engine": "paged", "ticks": self.ticks,
                "layout": self.cfg.page_layout.describe(),
                "bytes_per_page": self.bytes_per_page,
                "n_decode_steps": self.n_decode_steps,
                "n_prefill_chunks": self.n_prefill_chunks,
                "n_prefill_computed_tokens": self.n_prefill_computed_tokens,
                "n_preempted": self.n_preempted,
                "n_cow_copies": self.n_cow_copies,
                "n_prefix_hit_tokens": self.n_prefix_hit_tokens,
                "prefix_hit_rate": self.prefix_hit_rate(),
                "n_quarantined": self.n_quarantined,
                "n_shed": self.n_shed,
                "n_host_syncs": self.n_host_syncs,
                "peak_slot_pages": self.peak_slot_pages,
                "lifecycle": dict(self.lifecycle_counts),
                "n_stalled": self.n_stalled,
                "stalled_rids": list(self.stalled_rids),
                # n_sealed_fallbacks: the reference's trace guard may
                # send an unwarmed bucket to the masked program; the
                # eager port has no guard to seal, so it stays 0
                "packed": {"enabled": self.packed,
                           "n_packed_ticks": self.n_packed_ticks,
                           "n_masked_ticks": self.n_masked_ticks,
                           "n_rows_saved": self.n_packed_rows_saved,
                           "n_sealed_fallbacks": 0}}
