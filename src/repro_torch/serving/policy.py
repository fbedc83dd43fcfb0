"""Scheduling policy of the paged serving engine (counterpart of
``repro.serving.policy``): FIFO and priority classes.

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

``shed_key`` orders preemption victims and ``demote_key`` a tiered
pool's demotion victims.

``TickBudget`` holds the per-tick token caps: prompt tokens prefilled and
live slots decoded.
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

    def demote_key(self, page: int, cached_unreferenced: bool,
                   lru_order: int, last_use_tick: int):
        """Demotion order of a tiered pool: the engine demotes the minimum
        when it needs device frames. Cached pages no slot holds go first,
        in LRU order (their frames serve nobody; their bytes keep prefix
        value on the host), then cold resident pages by last-use tick.
        Demotion always comes before preemption or shedding: losing a
        frame costs one fetch, losing a slot a re-prefill."""
        return ((0, lru_order) if cached_unreferenced
                else (1, last_use_tick))


class FifoPolicy(SchedulerPolicy):
    pass


class PriorityPolicy(SchedulerPolicy):
    """Priority classes: a higher ``Request.priority`` is served first,
    arrival order breaks ties inside a class (equal priorities are FIFO).
    A waiter of a strictly higher class may preempt the least urgent
    running request for its slot."""

    name = "priority"
    preempt_for_admission = True

    def sort_key(self, req, arrival: int):
        return (-req.priority, arrival)

    def decode_key(self, req, arrival: int, last_tick: int):
        return (-req.priority, last_tick, arrival)


POLICIES = {"fifo": FifoPolicy, "priority": PriorityPolicy}


def make_policy(policy) -> SchedulerPolicy:
    """'fifo' | 'priority' | a SchedulerPolicy instance."""
    if isinstance(policy, SchedulerPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler policy {policy!r}; have "
            f"{list(POLICIES)}") from None
