"""Pluggable admission-queue scheduling policies for the front door (the
port's copy of ``repro/serving/scheduler.py``: same classes, same error
text).

The async server (``serving/server.py``) keeps its OWN bounded queue in
front of the engine and asks a :class:`SchedulingPolicy` which waiting
request to hand to the next free decode slot. Policies are pure host
code over :class:`QueueEntry` records — no torch, no engine internals —
so they are unit- and property-testable with a simulated clock.

Two policies ship:

* ``fifo`` — strict arrival order. The baseline every serving system
  implicitly has; under open-loop overload it maximizes head-of-line
  blocking (a late, tight-deadline request waits behind the entire
  backlog).
* ``slo`` — earliest-deadline-first over the waiting set, with an
  ANTI-STARVATION guarantee: whenever the oldest waiting entry has
  waited longer than ``starvation_s``, it is selected regardless of
  deadlines. Since "oldest" is unique and every selection removes one
  entry, an entry that has aged past the threshold is selected after at
  most as many selections as there are older entries — no admitted
  request can wait forever behind a stream of tighter deadlines.
  Entries without a deadline sort last among un-aged entries (they
  asked for no latency bound) but age like every other entry.

Selection is O(queue) per call — the front door's queues are bounded
(tens of entries), so scan cost is noise next to one engine tick.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass
class QueueEntry:
    """One waiting request as the policies see it.

    ``payload`` is opaque to the policy (the server stores the engine
    Request + stream plumbing there). Times are seconds on the server's
    clock; ``deadline_s`` is ABSOLUTE (arrival + SLO), None = no SLO.
    ``cost`` is the analytic admission price in whatever unit the
    server accounts backlog in (decode-token equivalents, see
    ``server.price_request``) — policies may use it for tie-breaks,
    admission uses it for backlog accounting.
    """

    payload: object
    arrival_s: float
    deadline_s: Optional[float] = None
    cost: float = 0.0
    seq: int = 0


class SchedulingPolicy:
    """Interface: pick the index of the next entry to dequeue."""

    name = "abstract"

    def select(self, queue: Sequence[QueueEntry], now: float) -> int:
        raise NotImplementedError


class FifoPolicy(SchedulingPolicy):
    """Strict arrival order (lowest submission sequence first)."""

    name = "fifo"

    def select(self, queue: Sequence[QueueEntry], now: float) -> int:
        return min(range(len(queue)), key=lambda i: queue[i].seq)


class SloPolicy(SchedulingPolicy):
    """Earliest deadline first, with bounded-wait anti-starvation.

    ``starvation_s``: once the OLDEST waiting entry has waited this
    long, it wins over every deadline. The bound makes the fairness
    guarantee crisp: an entry's wait before selection is at most
    ``starvation_s`` plus the drain time of entries older than it.
    """

    name = "slo"

    def __init__(self, starvation_s: float = 1.0):
        assert starvation_s > 0, starvation_s
        self.starvation_s = float(starvation_s)

    def select(self, queue: Sequence[QueueEntry], now: float) -> int:
        oldest = min(range(len(queue)), key=lambda i: queue[i].seq)
        if now - queue[oldest].arrival_s > self.starvation_s:
            return oldest
        return min(
            range(len(queue)),
            key=lambda i: (
                queue[i].deadline_s
                if queue[i].deadline_s is not None
                else math.inf,
                queue[i].seq,
            ),
        )


def make_policy(policy, **kwargs) -> SchedulingPolicy:
    """Resolve a policy name ("fifo" / "slo") or pass an instance
    through. Unknown names raise with the known set listed."""
    if isinstance(policy, SchedulingPolicy):
        return policy
    if policy == "fifo":
        return FifoPolicy()
    if policy == "slo":
        return SloPolicy(**kwargs)
    raise ValueError(
        f"unknown scheduling policy {policy!r}; known: 'fifo', 'slo'"
    )
