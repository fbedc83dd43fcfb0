"""Paged serving engine: continuous batching over a refcounted page pool
(counterpart of ``repro.serving.scheduler.PagedServingEngine``; every
family of the JAX package).

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

Tiered pool (``device_pages``): only ``device_pages`` frames of full-D
K/V rows stay on the card; the rest of the pages live in pinned host
buffers, while the latent-K sidecar of every page stays on the card, so
Loki's score pass reads every page. A tiered decode step runs the score
pass over the sidecar and exact attention over the frames (HOST pages
read the trash frame 0); a slot whose winners were all RESIDENT commits
its token, a slot that attended a HOST page has its misses promoted and
runs again (at most ``_TIERED_MAX_RUNS`` runs), and a slot whose misses
cannot be promoted this tick defers whole. Frame shortage demotes cold
pages and never preempts. Ordering on the card, made explicit where the
reference leans on JAX's dispatch order:

  demotion   synchronous: the frame's rows go to a pinned host buffer
             from a free list (copy-then-demote), then one host sync,
             counted in ``n_demote_syncs`` apart from the decode syncs
  promotion  the host-to-frame copy runs on a copy stream that first
             waits on the compute stream (the frame's old contents are
             done with); an event recorded after it is what the fetch
             queue lands: the compute stream waits on it before any step
             that reads the frame. A host buffer returns to the free list
             only once its page is RESIDENT again, after that wait
  a run      one upload (page table, frame table, tokens, positions) and
             one device-to-host copy (tokens, finite mask, winners)

Faults (``faults``, a serving/faults.py FaultPlan advanced each tick):
the pool's seams (``alloc_fail``, ``pool_exhaustion``,
``hbm_oom_on_promote``), the fetch queue's ``dma_timeout``, ``nan_logits``
on the masked, packed and tiered steps, ``slot_corrupt`` after the decode
phase, and ``kernel_fail``. The reference's ladder for a failed kernel
step (disable the kernel backend, re-run the step on the plain path) runs
on a CPU engine only, where the plain gathered path is the floor; a CUDA
engine has no floor, refuses a plan that can fire ``kernel_fail``, and a
real kernel failure raises out of the tick (ROADMAP §3). ``audit=True``
runs the invariant auditor after every tick.

The spec table (serving/cache_spec.py) drives the families' lifecycles:

  WindowPagedAttn  pages every future query's window has passed are
                   recycled (released, their entries pointed at the trash
                   page) before each prefill chunk and each decode step,
                   so a window request holds a bounded set of pages
  groups           layers whose windows differ read separate page tables
                   (``aux_tables`` beside ``page_table``): every group
                   grows in lockstep, each recycles at its own window,
                   and a step's upload carries the rank-3 table
  CrossAttnStatic  at admission the encoder runs once over the request's
                   frames and each layer's cross K/V lands in its slot
                   (quantized layouts: one scale per layer and slot)
  StateSlot        the slot's recurrent state is reset at admission and
                   advances only for the slots a decode step selects (the
                   step's ``live`` mask). Preemption snapshots it to
                   pinned host memory (``cache_spec.snapshot_slot_state``,
                   a copy ordered on the stream, so no host sync) and,
                   for the hybrid (state beside paged K/V, hymba), parks
                   the slot's own pages as private pool entries; a
                   re-admission whose whole retained set survived
                   restores both and resumes where it stopped, anything
                   less recomputes the folded prompt from a fresh state.
                   A multi-group hybrid always recomputes; the ssm family
                   (xlstm) holds no pages and restores from the snapshot
                   alone. On the tier, a re-run slot's state rewinds to a
                   snapshot taken before the phase, so each stream's
                   state advances once a step

Refused when asked for: the trace guard (it seals compiled programs; it
comes with the captured decode step, ROADMAP, the note after queue 1) and
tiered pools with page-table groups (the reference refuses them too).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch
from repro_torch.models import lm
from repro_torch.serving import cache_spec as CS
from repro_torch.serving import faults as FI
from repro_torch.serving import lifecycle as LC
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import (Request, context_cap,
                                        oversized_reason, sample_next)
from repro_torch.serving.lifecycle import Status
from repro_torch.serving.paged_cache import PagePool
from repro_torch.serving.policy import SchedulerPolicy, TickBudget, make_policy

PAGED_POLICIES = ("full", "exact_topk", "loki", "loki_block")

# runs of one tiered decode step before it gives up: run 1 finds the first
# off-device winners, run 2 can still move deeper layers' selections (their
# run-1 scores read trash rows), run 3 is resident in practice; 4 leaves
# one run of slack before calling it promotion/selection ping-pong
_TIERED_MAX_RUNS = 4


def _can_fire(plan, site: str) -> bool:
    """Can a FaultPlan fire ``site`` at all (a rate or a point)?"""
    return plan.rates.get(site, 0.0) > 0.0 or bool(plan.at.get(site))


class PagedServingEngine:
    """Continuous-batching engine over a paged KV-cache.

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
    faults         serving/faults.py FaultPlan consulted by the pool, the
                   fetch queue and this scheduler; None: off. A CUDA
                   engine refuses a plan that can fire ``kernel_fail``
    audit          run the invariant auditor after every tick (raises
                   AuditError on a violation)
    nan_guard      FAIL a request whose decode logits go non-finite, alone
    device_pages   tiered pool: frames of full-D K/V rows kept on the card
                   (with the trash frame); the other pages live in pinned
                   host buffers, scored through the resident latent
                   sidecar and promoted when the selection attends them.
                   Needs a Loki policy over a non-quantized layout. None:
                   single tier
    max_inflight   fetches the tiered pool's queue holds at once
    packed         gather-packed decode: the tick's live slots compacted
                   into a batch padded to a power-of-two bucket, its
                   kernels planned for the full width (bit-identical to
                   the masked step); False always runs full width,
                   masked. Off under the tier (its
                   re-runs and winner bookkeeping are slot-indexed)
    device         where the pool lives: the card unless "cpu" is asked
                   for; ``params`` must be on the same device

    The reference's ``trace_guard`` raises (ROADMAP, the note after queue
    1). ``donate`` has no effect: the port updates the pools in place.
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
        del donate
        if trace_guard is not None:
            raise NotImplementedError(
                "PagedServingEngine: trace_guard seals compiled programs; "
                "it comes with the captured decode step (ROADMAP, the note "
                "after queue 1)")
        if backend is not None:
            cfg = cfg.replace(
                loki=dataclasses.replace(cfg.loki, backend=backend))
        CS.assert_pageable(cfg)
        self.has_pages = CS.has_paged_attn(cfg)
        self.has_state = CS.has_state_slots(cfg)
        if self.has_pages and cfg.attn_policy() not in PAGED_POLICIES:
            raise ValueError(
                f"policy {cfg.attn_policy()!r} cannot serve from a paged "
                f"cache (supported: {PAGED_POLICIES}); use ServingEngine")
        if admission not in ("strict", "lenient"):
            raise ValueError(f"admission={admission!r}; "
                             "use 'strict' or 'lenient'")
        self.device = resolve_device(device)
        if (faults is not None and self.device.type == "cuda"
                and _can_fire(faults, "kernel_fail")):
            raise ValueError(
                "PagedServingEngine: kernel_fail needs a plain floor to "
                "fall back to, which a CUDA engine does not have: a real "
                "kernel failure raises out of the tick (ROADMAP §3)")
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
        self.packed = bool(packed) and device_pages is None
        self._clock = clock or time.time
        self.policy: SchedulerPolicy = make_policy(policy)
        self.budget = TickBudget(
            prefill_tokens=prefill_budget or prefill_chunk,
            decode_tokens=decode_budget or n_slots)
        shareable, why = CS.prefix_shareable(cfg)
        self.prefix_caching = bool(prefix_cache and shareable)
        # why the cache is bypassed although asked for ("" otherwise)
        self.prefix_cache_reason = why if prefix_cache else ""
        self.is_encdec = cfg.is_encoder_decoder
        # page accounting from the spec table: ``req_budget`` bounds a
        # request's pages while it decodes (summed over its page-table
        # groups); ``_group_pages_hard`` also covers a prefill chunk,
        # whose pages cannot be recycled before its earliest query has
        # passed them. Group 0 owns the primary table and the prefix
        # cache and copy-on-write; groups 1.. are window groups that grow
        # in lockstep with it and recycle at their own window
        self.window = CS.recycle_window(cfg)
        self.group_windows = CS.group_windows(cfg)
        self.n_groups = max(len(self.group_windows), 1)
        self.req_budget = CS.request_page_budget(cfg, self.smax,
                                                 self.page_size)

        def hard(w: int) -> int:
            if w:
                return min(self.max_pages, CS.window_page_budget(
                    w + prefill_chunk - 1, self.page_size))
            return self.max_pages
        self._group_pages_hard = [hard(w) for w in self.group_windows]
        self._req_pages_hard = sum(self._group_pages_hard)
        if n_pages is None:
            n_pages = 1 + max(n_slots * self._req_pages_hard, 1)
        if n_pages - 1 < self._req_pages_hard:
            raise ValueError(
                f"pool of {n_pages} pages cannot hold one full request "
                f"({self._req_pages_hard} pages); raise n_pages or lower "
                "smax")

        self.tiered = device_pages is not None
        if self.tiered:
            if not self.has_pages:
                raise ValueError("tiered KV pool needs paged attention "
                                 "layers")
            if cfg.attn_policy() not in ("loki", "loki_block"):
                raise ValueError(
                    "tiered KV pool needs a Loki policy (its latent "
                    f"sidecar drives the score pass), not "
                    f"{cfg.attn_policy()!r}")
            if cfg.page_layout.quantized:
                raise ValueError(
                    "tiered KV pool requires a non-quantized page layout: "
                    "quantized row writes re-derive per-page scales, so "
                    "the miss-repair replay would not be bit-idempotent")
            if self.n_groups > 1:
                raise ValueError(
                    "tiered KV pool does not compose with per-layer "
                    "page-table groups (cfg.window_layers): the frame "
                    "table and pin ledger are single-table")
            if device_pages - 1 < self._req_pages_hard:
                raise ValueError(
                    f"device pool of {device_pages} frames cannot hold "
                    f"one full request ({self._req_pages_hard} pages); "
                    "raise device_pages or lower smax")
        self._faults = faults
        self.audit = audit

        self.pool = PagePool(n_pages, self.page_size,
                             device_pages=device_pages,
                             max_inflight=max_inflight)
        if faults is not None:
            self.pool.set_faults(faults)
        self.cache = lm.init_paged_cache(cfg, n_pages, self.page_size,
                                         torch.float32, n_slots=n_slots,
                                         device_pages=device_pages,
                                         device=self.device)
        self._scan = CS.uses_scan(cfg)
        self._fresh_state = CS.fresh_state_tree(cfg, torch.float32,
                                                self.device)
        self.page_table = np.zeros((n_slots, self.max_pages), np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.live = np.zeros((n_slots,), bool)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        # logical page index -> physical page id, or None once recycled
        # (window slide): ``len`` is the logical coverage, the non-None
        # entries what the slot holds
        self.slot_pages: List[List[Optional[int]]] = [
            [] for _ in range(n_slots)]
        # page-table groups 1..n-1: tables and page lists shaped like the
        # primary ones. Their pages are never prefix-shared (a config with
        # groups has a window component, which bypasses prefix caching),
        # so copy-on-write and registration never apply to them
        self.aux_tables: List[np.ndarray] = [
            np.zeros((n_slots, self.max_pages), np.int32)
            for _ in range(self.n_groups - 1)]
        self.aux_pages: List[List[List[Optional[int]]]] = [
            [[] for _ in range(n_slots)] for _ in range(self.n_groups - 1)]
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
        # preempted StateSlot requests: id(req) -> (prompt tokens the
        # state has folded in, its host snapshot); a hybrid's retained
        # pages: id(req) -> (its page list, their private keys). A restore
        # needs both whole; anything less recomputes
        self._state_snap: Dict[int, Tuple[int, Any]] = {}
        self._page_snap: Dict[int, Tuple[List[Optional[int]],
                                         List[bytes]]] = {}
        self.n_state_restores = 0
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
        self.peak_slot_pages = 0           # most pages a slot held at once
        self.n_recycled_pages = 0          # pages freed by window slides
        self.n_stalled = 0
        self.stalled_rids: List[int] = []
        self.n_backend_fallbacks = 0
        # tiered pool: host buffers of HOST and IN_FLIGHT pages (k, v) and
        # a free list of buffers to reuse, the pinned write target per
        # slot, the last tick each page was used (demotion order), the
        # copy stream and the fetch queue
        self._host_kv: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._host_free: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._n_host_buffers = 0
        self._pinned_tail: Dict[int, int] = {}
        self._page_last_use: Dict[int, int] = {}
        self._page_bytes = 0
        if self.has_pages:
            attn = self.cache["layers"]["attn"]
            self._page_bytes = self.page_size * sum(
                attn[n][0, 0].numel() * attn[n].element_size()
                for n in ("k", "v")) * cfg.n_layers
        self.n_prefetch_hits = 0
        self.n_prefetch_misses = 0
        self.n_sync_fetches = 0
        self.n_decode_reruns = 0
        self.n_decode_runs = 0
        self.n_deferred = 0
        self.n_demote_syncs = 0
        self.n_h2d_bytes = 0
        self.n_d2h_bytes = 0
        # winner pages and live pages summed over the slots of each step's
        # first run: how much of its context a slot's selection touches
        self.n_winner_pages = 0
        self.n_live_pages = 0
        self.n_winner_slots = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.tiered and self.device.type == "cuda"
                             else None)
        self._fetch = (PC.FetchQueue(self.pool, self._promote_copy,
                                     faults=faults)
                       if self.tiered else None)

    # ------------------------------------------------------------ host->card

    def _upload(self, flat: np.ndarray):
        """One int32 host array on the engine's device: from pinned memory
        without blocking on the card (PyTorch's pinned allocator keeps the
        buffer until the copy has run), a private copy on the CPU."""
        t = torch.from_numpy(flat)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # --------------------------------------------------- per-slot state

    def _group_tables(self) -> List[np.ndarray]:
        """Every group's host page table, the primary (group 0) first."""
        return [self.page_table] + self.aux_tables

    def _group_pages(self, g: int) -> List[List[Optional[int]]]:
        """Group ``g``'s per-slot logical page lists."""
        return self.slot_pages if g == 0 else self.aux_pages[g - 1]

    def _held(self, slot: int) -> List[int]:
        """The primary table's pages the slot holds (recycled entries
        left out)."""
        return [p for p in self.slot_pages[slot] if p is not None]

    def _slot_tables(self, sidx: np.ndarray) -> np.ndarray:
        """The tables of slots ``sidx``: (n, max_pages), or (n, n_groups,
        max_pages) with page-table groups."""
        if self.n_groups == 1:
            return self.page_table[sidx]
        return np.stack([t[sidx] for t in self._group_tables()], axis=1)

    def _reset_slot_state(self, slot: int) -> None:
        """(Re-)admission: the slot's recurrent state back to its fresh
        values, so no earlier occupant leaks into this request (and a
        recompute starts from the fresh state)."""
        if self.has_state:
            CS.reset_slot_state(self.cache["layers"], self._fresh_state,
                                slot, self._scan)

    def _drop_page_snap(self, psnap) -> None:
        """Discard a retained page set: reclaim the private entries that
        still exist and return their pages to the free list."""
        if psnap is None:
            return
        pages = self.pool.reclaim_private(psnap[1])
        if pages:
            self.pool.release(pages)
            if self.tiered:
                self._prune_host()

    def _try_restore_state(self, slot: int, req: Request,
                           n_pre: int) -> Optional[int]:
        """Snapshot restore at re-admission: the host snapshot back into
        the slot, and the number of prompt tokens it folded in; None when
        the prompt must be recomputed. The ssm family needs the snapshot
        only; a hybrid also reclaims its retained K/V pages, all or
        nothing, since a state over a partial K/V prefix would attend
        garbage."""
        snap = self._state_snap.get(id(req))
        psnap = self._page_snap.pop(id(req), None)
        if snap is None:
            self._drop_page_snap(psnap)
            return None
        consumed, tree = snap
        if not 1 <= consumed <= n_pre:
            self._drop_page_snap(psnap)
            return None
        if self.has_pages:
            if psnap is None:
                return None
            pages, keys = psnap
            if self.pool.reclaim_private(keys) is None:
                # pressure evicted part of the retained set while the
                # request was queued: recompute instead
                return None
            self.slot_pages[slot] = list(pages)
            self.page_table[slot] = 0
            for i, pg in enumerate(pages):
                if pg is not None:
                    self.page_table[slot, i] = pg
            self.peak_slot_pages = max(self.peak_slot_pages,
                                       len(self._held(slot)))
        CS.reset_slot_state(self.cache["layers"], tree, slot, self._scan)
        self.n_state_restores += 1
        return consumed

    def _install_cross(self, slot: int, frames) -> None:
        """The CrossAttnStatic lifecycle: at admission the encoder runs
        once over the request's frames and each layer's cross K/V lands
        in its slot (``lm.install_cross_kv``)."""
        fr = torch.as_tensor(np.asarray(frames, np.float32)[None],
                             device=self.device)
        ck, cv = lm.encode_cross_kv(self.params, self.cfg, fr)
        lm.install_cross_kv(self.cfg, self.cache, slot, ck, cv)

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
        # nothing keyed to the request outlives it: fold bookkeeping,
        # arrival order, its state snapshot and retained pages
        self._folded.pop(id(req), None)
        self._arrival.pop(id(req), None)
        self._state_snap.pop(id(req), None)
        self._drop_page_snap(self._page_snap.pop(id(req), None))

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
        if self.is_encdec and req.frames is None:
            raise ValueError("encoder-decoder serving needs Request.frames "
                             "(enc_seq, d_model)")
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
        for g in range(1, self.n_groups):
            self.aux_pages[g - 1][slot] = []
            self.aux_tables[g - 1][slot] = 0
        self._cow_pending.pop(slot, None)
        self._admit_order.append(slot)
        self.pos[slot] = 0
        n_pre = len(toks) - 1              # the last token goes to decode
        restored = self._try_restore_state(slot, req, n_pre)
        if restored is None:
            self._reset_slot_state(slot)
        if self.is_encdec:
            self._install_cross(slot, req.frames)
        start = 0
        self._reg_next[slot] = 0
        self._reg_parent[slot] = PC.ROOT_KEY
        if restored is not None:
            start = restored
        elif self.prefix_caching and n_pre > 0:
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
        held = self._held(slot)
        if self.tiered and held:
            # pin the decode write target now if a frame allows it; the
            # decode phase makes it resident again before every step
            if self._ensure_resident([held[-1]]):
                self._repin_tail(slot)

    def _release_slot(self, slot: int) -> None:
        """Drop a slot's page references (a shared page survives for its
        other readers, a registered one parks in the LRU) and point its
        table at the trash page, so the batched step's unconditional write
        cannot touch reallocated pages. No status change (callers own
        that)."""
        if self.tiered:
            old = self._pinned_tail.pop(slot, None)
            if old is not None:
                self.pool.unpin(old)
        # recycled (None) entries were released when they slid out of the
        # window; the rest drop one reference each
        self.pool.release(self._held(slot))
        for g in range(1, self.n_groups):
            self.pool.release([p for p in self.aux_pages[g - 1][slot]
                               if p is not None])
            self.aux_pages[g - 1][slot] = []
            self.aux_tables[g - 1][slot] = 0
        if self.tiered:
            self._prune_host()
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

    def _retain_slot_pages(self, slot: int, req: Request) -> None:
        """Hybrid preemption: park the slot's own K/V pages as private
        pool entries, so re-admission can apply the state snapshot instead
        of recomputing the folded prompt. Once the slot releases them they
        sit unreferenced in the LRU, and pressure evicts them like any
        cached page; the restore then recomputes (it is all or nothing).
        A page already published (shared) cannot be made private: then
        nothing is retained."""
        keys = []
        for p in self._held(slot):
            try:
                keys.append(self.pool.register_private(p))
            except ValueError:
                self._drop_page_snap(([], keys))
                return
        if keys:
            self._page_snap[id(req)] = (list(self.slot_pages[slot]), keys)

    def _preempt(self, slot: int) -> None:
        """Preemption: fold the tokens generated since the last fold into
        the prompt, release the slot's references and requeue the request
        at the front; greedy decoding reproduces the rest. A StateSlot
        family also snapshots the slot's state to the host, and a hybrid
        parks its pages beside it, so re-admission can skip what the
        state has folded in; the others recompute. With ``shed_after``, a
        request preempted that many times is shed instead: terminal SHED
        with a retry-after hint, its references released, so sustained
        pressure ends in an answer to the client rather than in recompute
        churn."""
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
        consumed = self._prefill_at.get(slot)
        folded = self._folded.get(id(req), 0)
        fresh = req.out[folded:]
        if fresh:
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(fresh, np.int32)])
            self._folded[id(req)] = len(req.out)
        if consumed is None:
            # live mid-decode: the state has folded in every token of the
            # (just folded) prompt but the last, which re-admission feeds
            # through its first decode step
            consumed = len(req.prompt) - 1 if self.live[slot] else 0
        if self.has_state and consumed >= 1:
            self._state_snap[id(req)] = (consumed, CS.snapshot_slot_state(
                self.cache["layers"], self._fresh_state, slot, self._scan))
            if self.has_pages and self.n_groups == 1:
                # a multi-group hybrid recomputes: retention parks the
                # primary table's pages only, and a restore over missing
                # aux pages would attend garbage
                self._retain_slot_pages(slot, req)
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
                              for p in self._held(s))]
            self._preempt(max(
                gainful or candidates,
                key=lambda s: self.policy.shed_key(
                    self.slot_req[s], self._arrival[id(self.slot_req[s])],
                    self.slot_req[s].n_preempts)))
        return True

    def _grow_to(self, slot: int, n_tokens: int) -> bool:
        """Ensure every group's table covers logical positions
        [0, n_tokens), preempting less urgent requests if the pool is
        short. False when it cannot. The groups grow in lockstep (their
        layers write the same token rows); only recycling, at each
        group's own window, makes them differ. A model without pages (the
        ssm family) has nothing to grow."""
        if not self.has_pages:
            return True
        want = PagePool.pages_for(n_tokens, self.page_size)
        needs = [max(want - len(self._group_pages(g)[slot]), 0)
                 for g in range(self.n_groups)]
        need = sum(needs)
        if need <= 0:
            return True
        if not self._make_room(need, protect=slot):
            return False
        # fresh pages are born RESIDENT: a tiered pool frees their frames
        # by demotion, never by preemption (``_make_room`` above answers a
        # shortage of logical pages, which frames cannot)
        if self.tiered and not self._demote_for_frames(
                need, protect=frozenset(self._held(slot))):
            return False
        for g, (n_g, table) in enumerate(zip(needs, self._group_tables())):
            if not n_g:
                continue
            pages = self.pool.alloc(n_g)
            if pages is None:
                # injected alloc_fail: contended. Groups grown so far keep
                # their pages; a retry asks only for what is missing
                return False
            plist = self._group_pages(g)[slot]
            base = len(plist)
            table[slot, base:base + n_g] = pages
            plist.extend(pages)
        if self.tiered and slot in self._pinned_tail:
            # the tail moved to a fresh (RESIDENT) page: the pin follows at
            # once, so a caller that defers after growing (a prefill chunk
            # whose older pages cannot all be promoted this tick) leaves no
            # stale pin behind (invariant H); the reference moves it only
            # once the caller goes on
            self._repin_tail(slot)
        self.peak_slot_pages = max(self.peak_slot_pages,
                                   len(self._held(slot)))
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
            del self._cow_pending[slot]
            return True
        if self.tiered:
            # the copy reads the source frame and writes a fresh one: the
            # source is promoted first (it may take a free frame), the
            # destination's frame is claimed after
            prot = frozenset(self._held(slot))
            if not (self._ensure_resident([old], prot)
                    and self._demote_for_frames(1, prot | {old})):
                return False
        got = self.pool.alloc(1)
        if got is None:
            return False               # injected alloc_fail: contended
        new = got[0]
        frames = {}
        if self.tiered:
            frames = dict(src_frame=self.pool.frame_of(old),
                          dst_frame=self.pool.frame_of(new))
        lm.copy_cache_page(self.cfg, self.cache, old, new, self.page_size,
                           **frames)
        self.page_table[slot, idx] = new
        self.slot_pages[slot][idx] = new
        if self.tiered:
            # the old page may have been this slot's pinned tail: move the
            # pin to the copy before the reference goes
            self._repin_tail(slot)
        self.pool.release([old])
        if self.tiered:
            self._prune_host()
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

    def _recycle_window(self, slot: int, next_q: int) -> None:
        """The WindowPagedAttn lifecycle: pages every future query's
        window has passed are dead. Each is released once, its entry set
        to None and its table entry pointed at the trash page (whose rows
        the window mask hides, as the dense cache's dead rows are).
        ``next_q``: the earliest position a future query of this slot can
        have; it attends positions >= next_q - window + 1."""
        for g, w in enumerate(self.group_windows):
            if not w:
                continue            # a full-attention group pins its pages
            first_live = max(0, next_q - w + 1) // self.page_size
            pages = self._group_pages(g)[slot]
            freed = [p for p in pages[:first_live] if p is not None]
            if not freed:
                continue
            pages[:first_live] = [None] * min(first_live, len(pages))
            self.pool.release(freed)
            if self.tiered:
                self._prune_host()
            self.n_recycled_pages += len(freed)
            self._group_tables()[g][slot, :first_live] = 0
            live = sum(p is not None for p in pages)
            if live > self._group_pages_hard[g]:
                raise RuntimeError(
                    f"slot {slot} group {g} holds {live} pages after "
                    "recycling, above the spec-table bound "
                    f"{self._group_pages_hard[g]}")

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
        # recycle before growing: the chunk's earliest query is at
        # ``start``, so the pages its window has passed go first and the
        # slot's bound holds at every instant
        self._recycle_window(slot, start)
        # a shared tail page is copied before this chunk's first write
        # lands in it (start is the first uncached token)
        if not (self._resolve_cow(slot)
                and self._grow_to(slot, start + n_valid)):
            return -1
        chunk = np.zeros((c,), np.int32)
        chunk[:n_valid] = toks[start:start + n_valid]
        table = self._slot_tables(np.array([slot]))[0]
        rows = [chunk, table.ravel()]
        if self.tiered:
            # prefill is exact attention over the whole prefix and writes
            # the chunk's pages: every page the slot holds must be resident
            if not self._ensure_resident(self._held(slot)):
                return -1              # frame-starved this tick
            self._repin_tail(slot)
            rows.append(self._frame_table(self.page_table[slot]))
        dev = self._upload(np.concatenate(rows))
        o = c + table.size
        lm.prefill_chunk(self.params, self.cfg, self.cache, dev[:c][None],
                         start, n_valid, dev[c:o].view(table.shape),
                         self.page_size, slot=slot,
                         frame_row=dev[o:] if self.tiered else None)
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
        # itself, unless only device frames are short (tier)
        prepped: set = set()
        for slot in chosen:
            if not self.live[slot]:
                continue                   # preempted by an earlier grow
            # window slots first free the pages this step's query no
            # longer sees, so they stay within their spec-table bound
            self._recycle_window(slot, int(self.pos[slot]))
            if not (self._resolve_cow(slot)
                    and self._grow_to(slot, int(self.pos[slot]) + 1)):
                if self.tiered and self._frame_starved(slot):
                    # demote before preempting: the pool has the pages and
                    # only frames are short. Pins are best effort, so drop
                    # those of slots not prepped this tick and retry; still
                    # short, the slot defers one tick
                    self._unpin_tails(keep=prepped | {slot})
                    if not (self._resolve_cow(slot) and self._grow_to(
                            slot, int(self.pos[slot]) + 1)):
                        sel[slot] = False
                        continue
                else:
                    self._preempt(slot)
                    continue
            if self.tiered:
                # this step writes the slot's K/V row into its tail page:
                # promote it if demoted and pin it, so no demotion in the
                # repair loop diverts the write to the trash frame; frame-
                # starved, the slot defers (nothing of its stream moves)
                held = self._held(slot)
                if held:
                    if not self._ensure_resident([held[-1]],
                                                 frozenset(held)):
                        sel[slot] = False
                        continue
                    self._repin_tail(slot)
                    self._page_last_use[held[-1]] = self.ticks
                prepped.add(slot)
        sel &= self.live
        if not sel.any():
            return False
        if self.tiered:
            nxt_np, finite, sel = self._decode_tiered(sel, rng)
            if not sel.any():
                return False           # every stream deferred a tick
        else:
            nxt_np, finite = self._decode_step(sel, rng)
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

    def _decode_step(self, sel: np.ndarray, rng):
        """One packed or masked decode step over the selected slots ->
        (sampled tokens, finite mask or None), both over the full slot
        axis (entries of unselected slots are not read)."""
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
        rows = len(sidx)
        keep = sel[sidx].astype(np.int32)
        pt = self._slot_tables(sidx)
        pt = pt * keep.reshape((rows,) + (1,) * (pt.ndim - 1))
        # the step's one upload: table (rank 3 with page-table groups),
        # tokens, positions, the rows' live mask (state families) and the
        # slot ids (packed)
        dev = self._upload(np.concatenate(
            [pt.ravel(), self.last_tok[sidx], self.pos[sidx]]
            + ([keep] if self.has_state else [])
            + ([sidx] if packed else [])))
        o = pt.size
        tok, pos = dev[o:o + rows], dev[o + rows:o + 2 * rows]
        o += 2 * rows
        live = None
        if self.has_state:
            live = dev[o:o + rows].bool()
            o += rows
        logits, self.cache = self._run_decode(
            dev[:pt.size].view(pt.shape), tok, pos,
            dev[o:] if packed else None, live)
        # nan_logits poisons the row that carries the slot (a packed row
        # on a packed step)
        self._poison(logits, [i for i in range(rows) if sel[sidx[i]]],
                     sidx)
        nxt = sample_next(logits, greedy=self.greedy, rng=rng,
                          ticks=self.ticks)
        if self.nan_guard:
            nxt = torch.stack([nxt, torch.isfinite(logits).all(-1).to(
                torch.int32)])
        # the one device->host copy of the step: the sampled tokens (and
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
        return nxt_np, finite

    def _poison(self, logits, rows, slots) -> None:
        """The ``nan_logits`` site: each of ``rows`` (carrying slot
        ``slots[row]``) whose slot the plan hits is set to NaN on the
        card, one row at a time (no index tensor crosses from the host)."""
        if self._faults is None:
            return
        for i in rows:
            if self._faults.hit("nan_logits", int(slots[i])):
                logits[i] = float("nan")

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

    def _ladder(self, step):
        """Run one decode step through the reference's degradation ladder,
        on a CPU engine only: when the kernel path (the plain versions
        standing in for the kernels) fails with ``kernel_fail``, the
        kernel backend is disabled process-wide and the same step re-runs
        on the plain gathered path, which later steps keep. The injected
        failure raises before the step touches the pools. A CUDA engine
        has no floor (``resolve_backend`` raises for a disabled kernel
        backend there): it never consults the site, and a kernel that
        fails on the card raises out of the tick."""
        on_kernels = (self.device.type == "cpu"
                      and dispatch.resolve_backend(
                          self.cfg.loki.backend, "cpu") == "pallas")
        try:
            if (on_kernels and self._faults is not None
                    and self._faults.hit("kernel_fail")):
                raise FI.FaultInjected("injected kernel-step abort")
            return step()
        except FI.FaultInjected as e:
            if not on_kernels:
                raise
            dispatch.disable_backend("pallas", f"decode step failed: {e}")
            self.n_backend_fallbacks += 1
            return step()

    def _run_decode(self, pt, tok, pos, sidx, live):
        """One batched decode step over the masked or packed table. The
        kernels are planned for the engine's full width (``plan_slots``),
        so a packed step rounds each slot as the masked step does.
        ``live``: the rows whose recurrent state may advance (state
        families; None otherwise)."""
        return self._ladder(lambda: lm.decode_step(
            self.params, self.cfg, self.cache, tok, pos, page_table=pt,
            page_size=self.page_size, slot_idx=sidx, live=live,
            plan_slots=self.n_slots))

    # ------------------------------------------------------- tiered pool

    def _frame_table(self, pt: np.ndarray) -> np.ndarray:
        """A logical page table resolved to device frames: RESIDENT pages
        to their frame; HOST pages and frames still in flight to the trash
        frame 0, whose rows are finite garbage. A slot whose selection
        attended such a page is re-run, never committed."""
        lut = np.zeros((self.pool.n_pages,), np.int32)
        for p, f in self.pool.frame_map().items():
            lut[p] = f
        for p in self.pool.inflight_page_ids():
            lut[p] = 0
        return lut[pt]

    def _prune_host(self) -> None:
        """Return the host buffers no off-device page needs to the free
        list. A page leaves HOST and IN_FLIGHT only once its copy has
        landed (the compute stream waited on its event), and a buffer is
        reused only by a demotion's copy on that stream, so no unfinished
        copy still reads a buffer it lets go."""
        keep = set(self.pool.host_page_ids()) \
            | set(self.pool.inflight_page_ids())
        for p in [p for p in self._host_kv if p not in keep]:
            self._host_free.append(self._host_kv.pop(p))

    def _host_buffers(self):
        """A (k, v) pair of page-sized host buffers, pinned on a CUDA
        engine: from the free list, else new."""
        if self._host_free:
            return self._host_free.pop()
        self._n_host_buffers += 1
        attn = self.cache["layers"]["attn"]
        pin = self.device.type == "cuda"
        return tuple(torch.empty(
            (attn[n].shape[0], self.page_size) + tuple(attn[n].shape[2:]),
            dtype=attn[n].dtype, pin_memory=pin) for n in ("k", "v"))

    def _promote_copy(self, page: int, frame: int):
        """FetchQueue's copy: a page's host bytes into its staging frame.
        On the card the copy runs on the copy stream, after the compute
        stream's work so far (the frame's old contents are done with), and
        returns the event recorded after it; on the CPU it is done on
        return (None)."""
        k_host, v_host = self._host_kv[page]
        self.n_h2d_bytes += self._page_bytes
        if self._copy_stream is None:
            lm.promote_page_rows(self.cfg, self.cache, k_host, v_host, frame,
                                 self.page_size)
            return None
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy_stream):
            lm.promote_page_rows(self.cfg, self.cache, k_host, v_host, frame,
                                 self.page_size)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return event

    def _demote(self, pages) -> None:
        """Copy-then-demote: each page's full-D rows leave its frame for a
        host buffer, one host sync waits for the copies, then the frames
        go back. The latent sidecar rows stay on the card, so the pages
        keep scoring; only exact attention needs them back."""
        attn = self.cache["layers"]["attn"]
        ps = self.page_size
        # take back the buffers of pages promoted since the last prune
        # (their copies have landed) before any new one is allocated
        self._prune_host()
        for p in pages:
            f = self.pool.frame_of(p)
            bufs = self._host_buffers()
            for buf, n in zip(bufs, ("k", "v")):
                buf.copy_(attn[n][:, f * ps:(f + 1) * ps], non_blocking=True)
            self._host_kv[p] = bufs
            self.n_d2h_bytes += self._page_bytes
        if pages and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
            self.n_demote_syncs += 1
        for p in pages:
            self.pool.demote(p)

    def _demote_for_frames(self, need: int, protect=frozenset()) -> bool:
        """Free device frames by demoting victims in the policy's
        ``demote_key`` order: cached pages no slot holds first, then cold
        resident pages by last-use tick. Pinned tails and ``protect`` are
        never victims. True iff ``need`` frames are now free."""
        short = need - self.pool.free_frames
        if short <= 0:
            return True
        lru_pos = {p: i for i, p in enumerate(self.pool.lru_page_ids())}
        cands = [p for p in self.pool.resident_page_ids()
                 if p not in protect and not self.pool.is_pinned(p)]
        cands.sort(key=lambda p: self.policy.demote_key(
            p, p in lru_pos, lru_pos.get(p, 0),
            self._page_last_use.get(p, -1)))
        self._demote(cands[:short])
        return self.pool.free_frames >= need

    def _promote_sync(self, page: int, protect=frozenset()) -> bool:
        """Promote one page outside the queue, counted: the repair path of
        reads that no trash-frame masking may hide (prefill's prefix, a
        copy-on-write source, a decode write target). Claims a frame
        (demoting a victim if none is free), copies and lands the copy.
        False when no frame could be claimed this tick (hbm_oom_on_promote,
        or every frame pinned or protected): the caller defers."""
        state = self.pool.tier_of(page)
        if state == PC.IN_FLIGHT:
            self._fetch.drain()
            self._prune_host()
            state = self.pool.tier_of(page)
        if state == PC.RESIDENT:
            return True
        frame = self.pool.promote_begin(page)
        if frame is None:
            self._demote_for_frames(1, protect | {page})
            frame = self.pool.promote_begin(page)
        if frame is None:
            return False
        PC.FetchQueue.land(self._promote_copy(page, frame))
        self.pool.promote_complete(page)
        self.n_sync_fetches += 1
        self._prune_host()
        return True

    def _ensure_resident(self, pages, protect=frozenset()) -> bool:
        """Promote every off-device page of ``pages`` outside the queue."""
        if not self.tiered:
            return True
        prot = frozenset(protect) | set(pages)
        return all(self._promote_sync(p, prot) for p in pages)

    def _repin_tail(self, slot: int) -> None:
        """Pin the slot's write target (tail page), unpinning the previous
        one once the tail moves: a pinned tail is never demoted, so a
        decode write never lands in the trash frame by mistake."""
        tail = self.slot_pages[slot][-1] if self.slot_pages[slot] else None
        old = self._pinned_tail.get(slot)
        if old == tail:
            return
        if old is not None:
            self.pool.unpin(old)
            self._pinned_tail.pop(slot, None)
        if tail is not None:
            self.pool.pin(tail)
            self._pinned_tail[slot] = tail

    def _frame_starved(self, slot: int) -> bool:
        """Did this slot's decode prep fail for frames rather than pages?
        True when free and cached pages could cover its growth (and a
        pending copy-on-write): then only the device tier is short, which
        is demotion's and deferral's job, never preemption's."""
        need = PagePool.pages_for(int(self.pos[slot]) + 1, self.page_size) \
            - len(self.slot_pages[slot])
        if slot in self._cow_pending:
            need += 1
        return self.pool.available_pages >= max(need, 0)

    def _unpin_tails(self, keep) -> None:
        """Drop the tail pins of every slot not in ``keep``. Safe once that
        slot's last write landed: a demotion copies the frame's rows out
        first, so unpinning loses nothing; the slot re-pins in its own
        prep or defers."""
        for t in [t for t in self._pinned_tail if t not in keep]:
            self.pool.unpin(self._pinned_tail.pop(t))

    def _winner_pages(self, pt: np.ndarray, win: np.ndarray,
                      sel: np.ndarray) -> Dict[int, set]:
        """slot -> the physical pages this run's selection attended."""
        return {int(s): {int(p) for p in pt[s][win[s]] if p != 0}
                for s in np.flatnonzero(sel)}

    def _repair_misses(self, miss: Dict[int, List[int]],
                       winners: Dict[int, set], todo: np.ndarray) -> None:
        """Promote the missed pages of as many slots as the frames allow,
        most urgent first; a slot whose misses cannot all fit defers
        (dropped from ``todo``; it runs again next tick, identically).
        Each repaired slot's winners join the protected set, so a later
        slot never demotes an earlier one's pages and re-runs make
        progress. When even the head of the line cannot fit, every other
        stream defers and unpins so it can claim the whole tier (the
        constructor makes one request always fit)."""
        order = sorted(miss, key=lambda s: self.policy.decode_key(
            self.slot_req[s], self._arrival[id(self.slot_req[s])],
            int(self._last_decoded[s])))

        def claim(pages, trial):
            for p in pages:
                if self.pool.tier_of(p) != PC.HOST:
                    continue           # in flight or just promoted
                if not self._fetch.request(p):
                    self._demote_for_frames(1, frozenset(trial))
                    if not self._fetch.request(p):
                        return False
            return True

        protect = set(self._pinned_tail.values())
        head_took_all = False
        for i, s in enumerate(order):
            if head_took_all:
                todo[s] = False
                continue
            trial = protect | winners[s]
            if claim(miss[s], trial):
                protect = trial
                continue
            if i == 0:
                # head-of-line starvation: every other stream defers and
                # its pin lifts (next tick's prep promotes and pins again)
                self._unpin_tails(keep={s})
                head_took_all = True
                trial = winners[s] | {self._pinned_tail.get(s)} - {None}
                if claim(miss[s], trial):
                    continue
            todo[s] = False            # defer this stream

    def _decode_tiered(self, sel: np.ndarray, rng):
        """A tiered decode step: an optimistic run whose score pass reads
        only the resident latent sidecar and whose exact attention reads
        the frames. Slots whose winners were all RESIDENT commit: their
        run was exact. Slots that attended an off-device page read trash
        rows: their misses are promoted through the fetch queue and only
        they run again. The re-run is exact: a slot's K/V row write
        depends only on its token and position, and positions advance
        after the phase. A slot whose misses cannot be promoted this tick
        defers whole. Returns (tokens, finite mask or None, committed)
        over the full slot axis, ``committed`` within ``sel``.

        State families: a run advances the state of its own slots only
        (``live``), and every slot that ran without committing (re-run or
        deferred: its state advanced on trash rows) rewinds to a snapshot
        of the state taken before the phase, in one masked copy, so each
        stream's state advances once a step however many runs it took."""
        n, mp = self.n_slots, self.max_pages
        todo = sel.copy()
        done = np.zeros_like(sel)
        nxt_out = np.zeros((n,), np.int64)
        fin_out = np.ones((n,), bool) if self.nan_guard else None
        snap = None
        if self.has_state:
            snap = lm.tree_map(torch.clone, self.cache["layers"]["ssm"])
        for attempt in range(_TIERED_MAX_RUNS):
            ran = todo.copy()
            keep = todo.astype(np.int32)
            pt = self.page_table * keep[:, None]
            ft = self._frame_table(pt)
            # the run's one upload: page table, frame table, tokens,
            # positions and (state families) the live mask
            dev = self._upload(np.concatenate(
                [pt.ravel(), ft.ravel(), self.last_tok, self.pos]
                + ([keep] if self.has_state else [])))
            o = n * mp
            logits, win = self._run_decode_t(
                dev[:o].view(n, mp), dev[o:2 * o].view(n, mp),
                dev[2 * o:2 * o + n], dev[2 * o + n:2 * o + 2 * n],
                dev[2 * o + 2 * n:].bool() if self.has_state else None)
            self._poison(logits, np.flatnonzero(todo), np.arange(n))
            parts = [sample_next(logits, greedy=self.greedy, rng=rng,
                                 ticks=self.ticks)]
            if self.nan_guard:
                parts.append(torch.isfinite(logits).all(-1).to(torch.int32))
            parts.append(win.to(torch.int32).ravel())
            # the run's one device->host copy: tokens, the finite mask and
            # the winners together
            host = torch.cat(parts).cpu().numpy()
            self.n_host_syncs += 1
            self.n_decode_runs += 1
            nxt_np = host[:n]
            finite = host[n:2 * n] if self.nan_guard else None
            winners = self._winner_pages(pt, host[-o:].reshape(n, mp) > 0,
                                         todo)
            miss = {s: [p for p in sorted(pages)
                        if self.pool.tier_of(p) != PC.RESIDENT]
                    for s, pages in winners.items()}
            miss = {s: m for s, m in miss.items() if m}
            if attempt == 0:
                uniq = set().union(*winners.values()) if winners else set()
                n_miss = sum(self.pool.tier_of(p) != PC.RESIDENT
                             for p in uniq)
                self.n_prefetch_misses += n_miss
                self.n_prefetch_hits += len(uniq) - n_miss
                for s, pages in winners.items():
                    self.n_winner_pages += len(pages)
                    self.n_live_pages += len(self._held(s))
                    self.n_winner_slots += 1
            # commit every fully resident slot: its token is exact and its
            # K/V row write is input-only (valid even beside trash reads)
            for s in winners:
                if s in miss:
                    continue
                done[s] = True
                todo[s] = False
                nxt_out[s] = nxt_np[s]
                if fin_out is not None:
                    fin_out[s] = bool(finite[s])
                for p in winners[s]:
                    self._page_last_use[p] = self.ticks
            if todo.any():
                self.n_decode_reruns += 1
                self._repair_misses(miss, winners, todo)
                self._fetch.drain()
                self._prune_host()
            stale = ran & ~done
            if snap is not None and stale.any():
                self._rewind(snap, stale)
            if not todo.any():
                self.n_deferred += int((sel & ~done).sum())
                return nxt_out, fin_out, done
        raise RuntimeError(
            f"tiered decode did not converge in {_TIERED_MAX_RUNS} runs "
            "(promotion/selection ping-pong; raise device_pages)")

    def _run_decode_t(self, pt, ft, tok, pos, live):
        """The tiered twin of ``_run_decode``: the same ladder around the
        frame-table decode step -> (logits, winners)."""
        def step():
            logits, win, self.cache = lm.decode_step(
                self.params, self.cfg, self.cache, tok, pos, page_table=pt,
                page_size=self.page_size, frame_table=ft, live=live)
            return logits, win
        return self._ladder(step)

    def _rewind(self, snap, stale: np.ndarray) -> None:
        """One masked copy of the pre-phase state ``snap`` over every
        ``stale`` slot (slot axis 1 of the stacked state leaves)."""
        mask = self._upload(stale.astype(np.int32)).bool()

        def one(cur, old):
            m = mask.reshape((1, -1) + (1,) * (cur.ndim - 2))
            cur.copy_(torch.where(m, old, cur))

        def walk(cur, old):
            for k in cur:
                if isinstance(cur[k], dict):
                    walk(cur[k], old[k])
                else:
                    one(cur[k], old[k])
        walk(self.cache["layers"]["ssm"], snap)

    def _inject_corruption(self) -> None:
        """The ``slot_corrupt`` site: silently repoint one live slot's tail
        page entry at a page another slot holds, the bookkeeping bug that
        would alias two requests' caches. Nothing fails here by design:
        the auditor must catch it (invariants B, E)."""
        if self._faults is None:
            return
        for slot in range(self.n_slots):
            pages = self.slot_pages[slot]
            if (self.slot_req[slot] is None or not pages
                    or not self._faults.hit("slot_corrupt", slot)):
                continue
            mine = set(pages)
            foreign = sorted({p for s in range(self.n_slots) if s != slot
                              for p in self.slot_pages[s]
                              if p is not None and p not in mine})
            pages[-1] = foreign[0] if foreign else 0

    # ----------------------------------------------------------------- tick

    def tick(self, rng: Optional[torch.Generator] = None) -> None:
        if self._faults is not None:
            self._faults.advance(self.ticks)
        self._expire_deadlines()
        self._admission_phase()
        self._prefill_phase()
        self._decode_phase(rng)
        self._inject_corruption()
        self.ticks += 1
        if self.audit:
            FI.audit_engine(self)

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
        per-page scales of a quantized layout aside); 0 without pages."""
        attn = CS.layer_specs(self.cfg)[0].attn
        return attn.bytes_per_page(self.page_size) if attn else 0

    @property
    def pool_bytes(self) -> int:
        """Device bytes of every layer's pools and scale sidecars."""
        if not self.has_pages:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in self.cache["layers"]["attn"].values())

    def stats(self) -> Dict[str, Any]:
        out = {"engine": "paged", "ticks": self.ticks,
                "layout": self.cfg.page_layout.describe(),
                "bytes_per_page": self.bytes_per_page,
                "n_decode_steps": self.n_decode_steps,
                "n_prefill_chunks": self.n_prefill_chunks,
                "n_prefill_computed_tokens": self.n_prefill_computed_tokens,
                "n_preempted": self.n_preempted,
                "n_cow_copies": self.n_cow_copies,
                "n_state_restores": self.n_state_restores,
                "n_prefix_hit_tokens": self.n_prefix_hit_tokens,
                "prefix_hit_rate": self.prefix_hit_rate(),
                "n_quarantined": self.n_quarantined,
                "n_shed": self.n_shed,
                "n_backend_fallbacks": self.n_backend_fallbacks,
                "n_host_syncs": self.n_host_syncs,
                "n_recycled_pages": self.n_recycled_pages,
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
        if self.n_groups > 1:
            out["table_groups"] = {
                "n_groups": self.n_groups,
                "group_windows": list(self.group_windows),
                "group_pages_hard": list(self._group_pages_hard)}
        if self.tiered:
            looked = self.n_prefetch_hits + self.n_prefetch_misses
            out["tiered"] = {
                # the reference's counters
                "device_pages": self.pool.device_pages,
                "n_demoted": self.pool.n_demoted,
                "n_promoted": self.pool.n_promoted,
                "n_prefetch_hits": self.n_prefetch_hits,
                "n_prefetch_misses": self.n_prefetch_misses,
                "prefetch_hit_rate": (self.n_prefetch_hits / looked
                                      if looked else 1.0),
                "n_sync_fetches": self.n_sync_fetches,
                "n_fetches_issued": self._fetch.n_issued,
                "n_sync_fallbacks": self._fetch.n_sync_fallback,
                "n_decode_reruns": self.n_decode_reruns,
                # the port's: runs, deferred slots, demotion syncs, bytes
                # each way, host buffers at their peak, winner and live
                # pages over the slots of each step's first run
                "n_decode_runs": self.n_decode_runs,
                "n_deferred": self.n_deferred,
                "n_demote_syncs": self.n_demote_syncs,
                "h2d_bytes": self.n_h2d_bytes,
                "d2h_bytes": self.n_d2h_bytes,
                "peak_host_bytes": self._n_host_buffers * self._page_bytes,
                "winner_pages": self.n_winner_pages,
                "live_pages": self.n_live_pages,
                "winner_slots": self.n_winner_slots}
        if self._faults is not None:
            out["faults"] = dict(self._faults.counts)
        return out
