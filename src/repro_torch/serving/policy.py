"""Scheduling policy of the paged serving engine (counterpart of
``repro.serving.policy``; FIFO only so far).

A policy is two total orders plus one capability flag:

  sort_key(req, arrival)      urgency, smaller first. Admission pops the
                              minimum; preemption victims are the maximum
                              among strictly-less-urgent requests, so the
                              most urgent request always makes progress.
  decode_key(req, arrival, last_tick)
                              decode order under a token budget; the
                              slot's last-decoded tick makes a tight
                              budget round-robin.
  preempt_for_admission       may a more urgent waiter evict a runner just
                              for its slot? (False for FIFO.)

``TickBudget`` holds the per-tick token caps: prompt tokens prefilled and
live slots decoded. The reference's priority classes are not ported yet
(ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TickBudget:
    """Per-tick work caps, in tokens: ``prefill_tokens`` prompt tokens
    computed (the engine never splits a chunk), ``decode_tokens`` live
    slots decoded (one token each)."""
    prefill_tokens: int
    decode_tokens: int


class SchedulerPolicy:
    """FIFO: serve in arrival order, never preempt for admission."""

    name = "fifo"
    preempt_for_admission = False

    def sort_key(self, req, arrival: int):
        return (0, arrival)

    def decode_key(self, req, arrival: int, last_tick: int):
        return (0, last_tick, arrival)

    def shed_key(self, req, arrival: int, n_preempts: int):
        """Preemption-victim order under pool pressure: the engine takes
        the maximum, the least urgent request, ties toward the one that
        has churned through the most preemptions."""
        return (self.sort_key(req, arrival), n_preempts)


class FifoPolicy(SchedulerPolicy):
    pass


POLICIES = {"fifo": FifoPolicy}


def make_policy(policy) -> SchedulerPolicy:
    """'fifo' | a SchedulerPolicy instance."""
    if isinstance(policy, SchedulerPolicy):
        return policy
    if policy == "priority":
        raise NotImplementedError("the priority policy is not ported yet "
                                  "(ROADMAP queue 1 item 7)")
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler policy {policy!r}; have "
            f"{list(POLICIES) + ['priority']}") from None
