"""Request lifecycle: status machine, deadlines, and injectable clocks.

Until PR 7 a request either finished or silently vanished: ``Request.done``
was the only observable outcome, there was no way to cancel a running
request, no deadline could expire it, and a stalled drain returned without
a trace. This module makes the lifecycle explicit:

    QUEUED --> PREFILL --> DECODE --> DONE
      |            |          |
      |            +--<-------+        (preemption requeues: --> QUEUED)
      |            |          |
      +------------+----------+-----> CANCELLED   client cancel(rid)
                                      TIMED_OUT   deadline / stalled drain
                                      FAILED      submit reject, NaN slot
                                      SHED        load shed under pressure

Every transition goes through :func:`transition`, which validates the edge
against ``ALLOWED`` — an illegal move (resurrecting a terminal request,
skipping admission) raises :class:`LifecycleError` instead of silently
corrupting scheduler bookkeeping. Terminal statuses are sticky; the only
backward edge is preemption (PREFILL/DECODE -> QUEUED).

Deadlines are wall-clock budgets measured on the **engine's injected
clock** (``clock=`` constructor argument, default ``time.time``), so tests
drive them deterministically with :class:`ManualClock` instead of
sleeping. ``Deadline.ttft`` bounds submit -> first generated token,
``Deadline.total`` bounds submit -> terminal; either may be None
(unbounded). Expiry is checked at the top of every engine tick —
a breached request is released (all pages / snapshots freed) and marked
TIMED_OUT with the breached budget in ``Request.detail``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Optional


class LifecycleError(RuntimeError):
    """An illegal status transition (engine bookkeeping bug, or a caller
    trying to resurrect a terminal request)."""


class Status(enum.Enum):
    """Where a request is in its life. Values are the wire/stats names."""
    QUEUED = "queued"          # submitted, waiting for a slot
    PREFILL = "prefill"        # holds a slot, prompt being absorbed
    DECODE = "decode"          # in the batched decode set
    DONE = "done"              # finished normally (max_new / eos / cap)
    CANCELLED = "cancelled"    # client cancel(rid)
    TIMED_OUT = "timed_out"    # deadline breached, or drain stalled
    FAILED = "failed"          # rejected at submit, or quarantined (NaN)
    SHED = "shed"              # load-shed under sustained pool pressure

    def __str__(self) -> str:           # stats()/logs read naturally
        return self.value


#: statuses a request can never leave
TERMINAL = frozenset(
    {Status.DONE, Status.CANCELLED, Status.TIMED_OUT, Status.FAILED,
     Status.SHED})

#: legal edges; anything else raises LifecycleError. Terminal statuses
#: (FAILED etc.) are reachable from any live status: a request can be
#: rejected while queued, quarantined while decoding, shed while requeued.
_LIVE = frozenset({Status.QUEUED, Status.PREFILL, Status.DECODE})
ALLOWED = {
    Status.QUEUED: frozenset({Status.PREFILL}) | TERMINAL,
    Status.PREFILL: frozenset({Status.DECODE, Status.QUEUED}) | TERMINAL,
    Status.DECODE: frozenset({Status.QUEUED}) | TERMINAL,
    Status.DONE: frozenset(),
    Status.CANCELLED: frozenset(),
    Status.TIMED_OUT: frozenset(),
    Status.FAILED: frozenset(),
    Status.SHED: frozenset(),
}


def transition(req, to: Status, detail: str = "") -> None:
    """Move ``req`` to ``to``, validating the edge. ``detail`` explains
    terminal statuses ("ttft deadline", "non-finite logits", ...); it is
    kept on the request for stats and error reporting. ``req.done`` stays
    the legacy "finished normally" flag: True only for DONE."""
    cur = req.status
    if to not in ALLOWED[cur]:
        raise LifecycleError(
            f"illegal lifecycle transition {cur} -> {to} for request "
            f"{req.rid}" + (f" ({detail})" if detail else ""))
    req.status = to
    if detail:
        req.detail = detail
    if to is Status.DONE:
        req.done = True


def is_terminal(req) -> bool:
    return req.status in TERMINAL


def summarize(requests: Iterable) -> dict:
    """status-name -> count over a request collection (stats helper)."""
    out: dict = {}
    for r in requests:
        out[str(r.status)] = out.get(str(r.status), 0) + 1
    return out


# ------------------------------------------------------------- deadlines

@dataclasses.dataclass(frozen=True)
class Deadline:
    """Per-request wall budgets in seconds of the engine's clock.

    ttft   submit -> first generated token (queue wait + prefill). A
           request still waiting past it is hopeless for the client even
           if it would eventually run, so it times out in place.
    total  submit -> terminal. Bounds the whole request including decode.
    """
    ttft: Optional[float] = None
    total: Optional[float] = None


def breach(deadline: Optional[Deadline], now: float, t_submit: float,
           has_first_token: bool) -> Optional[str]:
    """Which budget ``now`` violates, or None. ``ttft`` stops mattering
    once the first token has been produced."""
    if deadline is None:
        return None
    waited = now - t_submit
    if deadline.total is not None and waited > deadline.total:
        return "total deadline"
    if (deadline.ttft is not None and not has_first_token
            and waited > deadline.ttft):
        return "ttft deadline"
    return None


# ---------------------------------------------------------------- clocks

class ManualClock:
    """Deterministic clock for tests: time only moves when advanced.

    Engines call their clock as a zero-arg function, so this is a drop-in
    for ``time.time`` — construct one, pass it as ``clock=``, and
    ``advance()`` it between ticks to drive deadline expiry exactly."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t
