"""Deadline-aware scheduling: EDF-with-slack queue ordering.

Requests with the least remaining slack get elevated priority; the priority
is also propagated to the managed communication layer (StreamingObject
chunks are flushed in priority order). Baseline engines use FIFO.

Policies operate on any queue item carrying ``priority`` (predicted slack,
smaller = more urgent) and an arrival stamp (``enqueued_at`` for simcluster
Tasks, ``submitted_at`` for engine Requests), so one policy object serves
both the cluster simulator's dispatch queues and the generation engine's
admission + prefill-budget hooks (which waiting request gets admitted, and
which mid-prefill request gets the next chunk of the step's token budget).

Eviction-aware admission: the paged engine binds a *residency* probe into
its policy (``bind_residency``) scoring how much of a waiting request's
prompt is already resident in the KV tiers (HBM-shared blocks weigh full,
host-tier blocks half). ``resident_first`` prefers resident requests —
admitting them consumes fewer fresh blocks and zero (or cheap) prefill, and
doing so *before* the resident blocks age out of the LRU/host tiers is what
makes the cache hit rate self-reinforcing instead of self-defeating —
falling back to slack/arrival order among equals.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence


def _arrival(item) -> float:
    for attr in ("enqueued_at", "submitted_at"):
        v = getattr(item, attr, None)
        if v is not None:
            return v
    return 0.0


def edf_key(item) -> tuple:
    """EDF-slack ordering key: (predicted slack, arrival). This is the ONE
    ordering the serving stack uses for urgency everywhere it matters —
    ``EDFSlack`` admission/grants consume it directly, and the streaming
    transport (``core.streaming.PriorityFlusher``) flushes chunks sorted by
    the same ``priority`` field, so a request served first is also the one
    whose tokens leave the box first."""
    return (getattr(item, "priority", 0.0), _arrival(item))


class QueuePolicy:
    name = "fifo"

    _residency_fn: Optional[Callable] = None

    def bind_residency(self, fn: Callable) -> None:
        """Attach a residency probe (item -> [0, 1] resident fraction). The
        engine binds its own probe at construction; policies that ignore
        residency simply never call it."""
        self._residency_fn = fn

    def residency(self, item) -> float:
        return self._residency_fn(item) if self._residency_fn is not None else 0.0

    def select(self, queue: Sequence, now: float = 0.0) -> Optional[int]:
        """Index of the next item to serve (None on an empty queue)."""
        return 0 if queue else None

    def pop(self, queue: List, now: float = 0.0):
        i = self.select(queue, now)
        if i is None:
            return None
        return queue.pop(i)

    def order(self, items: Sequence, now: float = 0.0) -> List:
        """Full service order under this policy (non-destructive)."""
        rest = list(items)
        out: List = []
        while rest:
            out.append(rest.pop(self.select(rest, now)))
        return out


class EDFSlack(QueuePolicy):
    """Least-slack-first. ``priority`` is the predicted slack (seconds);
    ties broken by arrival order to avoid starvation churn."""

    name = "edf_slack"

    def select(self, queue: Sequence, now: float = 0.0) -> Optional[int]:
        if not queue:
            return None
        return min(range(len(queue)), key=lambda i: edf_key(queue[i]))


class ResidentFirst(EDFSlack):
    """Eviction-aware admission: prefer the request whose KV blocks are most
    resident (HBM or host tier), then least slack, then arrival order.

    Residency is quantized to blocks already (the probe scores whole keyed
    blocks), so rounding to 3 decimals only guards against float noise in
    the tie-break, not real signal."""

    name = "resident_first"

    def select(self, queue: Sequence, now: float = 0.0) -> Optional[int]:
        if not queue:
            return None
        return min(
            range(len(queue)),
            key=lambda i: (-round(self.residency(queue[i]), 3),)
            + edf_key(queue[i]),
        )


_POLICIES = {"edf_slack": EDFSlack, "resident_first": ResidentFirst}


def make_policy(name) -> QueuePolicy:
    if isinstance(name, QueuePolicy):
        return name
    return _POLICIES.get(name, QueuePolicy)()
