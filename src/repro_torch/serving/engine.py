"""Slot-based batched serving engine (counterpart of
``repro.serving.engine``).

The cache is preallocated (L, n_slots, Smax, ...) storage and decode writes
in place, so no step re-allocates it. Requests join free slots; every tick
runs one batched decode step over all slots; finished requests free their
slot. Per-slot positions make ragged batches exact.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Dict, List, Optional, Protocol,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serving import lifecycle as LC
from repro_torch.serving.lifecycle import Deadline, Status


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S_p,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False            # finished *normally* (== status DONE)
    t_submit: float = 0.0         # set by submit(); for latency reporting
    t_first: float = 0.0          # first generated token (TTFT reporting)
    t_done: float = 0.0           # set at any terminal status
    status: Status = Status.QUEUED
    detail: str = ""
    deadline: Optional[Deadline] = None
    # times this request lost its slot to preemption (paged engine)
    n_preempts: int = 0


def context_cap(smax: int, gen_tokens: int) -> int:
    """Prompt rows a fresh admission may occupy: reserve headroom for the
    generation, capped at half the context."""
    return max(smax - min(gen_tokens, smax // 2), 1)


@runtime_checkable
class Engine(Protocol):
    """What a serving engine looks like to harnesses: submit requests,
    advance ticks, cancel mid-flight, drain to completion, report."""

    def submit(self, req: "Request") -> None: ...

    def tick(self, rng: Optional[torch.Generator] = None) -> None: ...

    def cancel(self, rid: int, detail: str = "client cancel") -> bool: ...

    def drain(self, max_ticks: int = 10_000,
              rng: Optional[torch.Generator] = None) -> None: ...

    def stats(self) -> Dict[str, Any]: ...


def oversized_reason(prompt_len: int, max_new: int,
                     smax: int) -> Optional[str]:
    """Why a request can never be held whole in an ``smax``-row context,
    or None if it fits (prompt + max_new == smax exactly fills it)."""
    if prompt_len < 1:
        return "empty prompt"
    if max_new < 1:
        return f"max_new={max_new} < 1"
    if prompt_len + max_new > smax:
        return (f"prompt ({prompt_len}) + max_new ({max_new}) exceeds "
                f"context capacity {smax}; shorten one or raise smax")
    return None


def sample_next(logits, *, greedy: bool, rng, ticks: int):
    """Greedy argmax (first index on ties, as ``jnp.argmax``), or a
    categorical draw from the caller's generator (falling back to one
    seeded with the tick)."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if rng is None:
        rng = torch.Generator(device=logits.device).manual_seed(ticks)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=rng)[:, 0].to(torch.int32)


class ServingEngine:
    """Dense slot engine.

    admission  'strict' (default) FAILs requests whose prompt + max_new
               can never fit the smax-row context at ``submit()``;
               'lenient' truncates the prompt to the most recent context
               and caps generation at capacity
    clock      zero-arg wall clock stamping t_submit/t_first/t_done and
               driving Request.deadline expiry
    device     where the cache lives: the card unless ``"cpu"`` is asked
               for; ``params`` must be on the same device
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 smax: int = 512, eos_id: Optional[int] = None,
                 greedy: bool = True, backend: Optional[str] = None,
                 admission: str = "strict", clock=None, device=None):
        if backend is not None:
            cfg = cfg.replace(
                loki=dataclasses.replace(cfg.loki, backend=backend))
        if admission not in ("strict", "lenient"):
            raise ValueError(f"admission={admission!r}; "
                             "use 'strict' or 'lenient'")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.n_slots, self.smax = n_slots, smax
        self.eos_id, self.greedy = eos_id, greedy
        self.admission = admission
        self._clock = clock or time.time
        self.lifecycle_counts: Dict[str, int] = {}
        self.n_stalled = 0
        self.stalled_rids: List[int] = []
        self.cache = lm.init_cache(cfg, n_slots, smax, torch.float32,
                                   device=self.device)
        # positions / last tokens live on the host: per-slot bookkeeping
        # stays in numpy and crosses to the device once per step. On the
        # CPU torch.as_tensor aliases these arrays; the step runs eagerly,
        # so it is done before tick() updates them in place
        self.pos = np.zeros((n_slots,), np.int32)
        self.live = np.zeros((n_slots,), bool)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.last_tok = np.zeros((n_slots,), np.int32)
        self._queue: List[Request] = []
        self.ticks = 0

    # -------------------------------------------------------- lifecycle

    def _terminal(self, req: Request, status: Status,
                  detail: str = "") -> None:
        LC.transition(req, status, detail)
        req.t_done = self._clock()
        self.lifecycle_counts[str(status)] = \
            self.lifecycle_counts.get(str(status), 0) + 1

    def _evict_slot(self, slot: int) -> None:
        """Drop a slot's occupant: stale cache rows beyond a future
        occupant's position are unreachable."""
        self.live[slot] = False
        self.slot_req[slot] = None

    def cancel(self, rid: int, detail: str = "client cancel") -> bool:
        """Terminate a request by id, queued or mid-generation. False when
        no live request has this rid."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                self._terminal(req, Status.CANCELLED, detail)
                return True
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is not None and req.rid == rid:
                self._terminal(req, Status.CANCELLED, detail)
                self._evict_slot(slot)
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
                self._evict_slot(slot)

    # ------------------------------------------------------------ admin

    def submit(self, req: Request) -> None:
        req.t_submit = self._clock()
        if self.admission == "strict":
            why = oversized_reason(len(req.prompt), req.max_new, self.smax)
            if why:
                self._terminal(req, Status.FAILED, f"oversized: {why}")
                return
        self._queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.live[slot] or not self._queue:
                continue
            self._prefill_slot(slot, self._queue.pop(0))

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """One causal-attention pass over the prompt (all but its last
        token), written straight into this slot's cache rows; live slots
        are untouched."""
        LC.transition(req, Status.PREFILL)
        toks = req.prompt.astype(np.int32)
        cap = context_cap(self.smax, req.max_new)
        if len(toks) > cap:
            toks = toks[-cap:]
        self.pos[slot] = 0
        if len(toks) > 1:
            view = {"layers": {"attn": {
                n: a[:, slot:slot + 1]
                for n, a in self.cache["layers"]["attn"].items()}}}
            lm.prefill(self.params, self.cfg,
                       torch.as_tensor(toks[None, :-1], device=self.device),
                       self.smax, cache=view)
            self.pos[slot] = len(toks) - 1
        self.last_tok[slot] = int(toks[-1])
        self.slot_req[slot] = req
        self.live[slot] = True
        LC.transition(req, Status.DECODE)

    # ------------------------------------------------------------- tick

    def tick(self, rng: Optional[torch.Generator] = None) -> None:
        self._expire_deadlines()
        self._admit()
        if not self.live.any():
            return
        logits, self.cache = lm.decode_step(
            self.params, self.cfg, self.cache,
            torch.as_tensor(self.last_tok, device=self.device),
            torch.as_tensor(self.pos, device=self.device))
        self.pos += self.live.astype(np.int32)
        nxt = sample_next(logits, greedy=self.greedy, rng=rng,
                          ticks=self.ticks)
        # the one device->host transfer of the tick: the sampled tokens
        # must reach Python to drive per-request lifecycle
        nxt_np = nxt.cpu().numpy()
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None or not self.live[slot]:
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
                self._evict_slot(slot)
            else:
                self.last_tok[slot] = tok
        self.ticks += 1

    def run_until_done(self, max_ticks: int = 10_000,
                       rng: Optional[torch.Generator] = None) -> None:
        """Drive ticks to completion. Hitting ``max_ticks`` with work still
        pending is a stall: every queued or running request is marked
        TIMED_OUT and counted in ``stats()['n_stalled']``."""
        for _ in range(max_ticks):
            if not self._queue and not self.live.any():
                return
            self.tick(rng)
        self._report_stall()

    def _report_stall(self) -> None:
        detail = "stalled: drain hit max_ticks"
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
            self._evict_slot(slot)
            self.n_stalled += 1
            self.stalled_rids.append(req.rid)

    # ------------------------------------------- Engine protocol surface

    def drain(self, max_ticks: int = 10_000,
              rng: Optional[torch.Generator] = None) -> None:
        self.run_until_done(max_ticks, rng)

    def stats(self) -> Dict[str, Any]:
        return {"engine": "dense", "ticks": self.ticks,
                "lifecycle": dict(self.lifecycle_counts),
                "n_stalled": self.n_stalled,
                "stalled_rids": list(self.stalled_rids)}
