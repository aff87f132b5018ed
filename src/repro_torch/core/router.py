"""Load- and state-aware routing.

Naive distributed runtimes dispatch to the instantaneously idle worker; an
instance that *looks* idle may be a bad pick if re-entrant stateful
iterations are about to return to it. Patchwork's router scores instances by
current backlog + expected near-future stateful re-entries.
"""
from __future__ import annotations

import random
from typing import List, Optional

from repro_torch.core.simcluster import Instance, Task


class Router:
    """policy: "load_state" (Patchwork) | "idle_first" (Ray-like) | "random"."""

    def __init__(self, policy: str = "load_state", reentry_weight: float = 1.0,
                 seed: int = 0):
        self.policy = policy
        self.reentry_weight = reentry_weight
        self.rng = random.Random(seed)
        self.decisions = 0

    def pick(self, instances: List[Instance], task: Task, now: float,
             mean_service: float, sticky: Optional[int] = None) -> Instance:
        """sticky: instance_id that a stateful re-entrant request MUST return to."""
        self.decisions += 1
        avail = [i for i in instances if not i.draining and i.ready_at <= now]
        if not avail:
            avail = [i for i in instances if not i.draining] or instances
        if sticky is not None:
            for i in avail:
                if i.instance_id == sticky:
                    return i
        if self.policy == "random":
            return self.rng.choice(avail)
        if self.policy == "idle_first":
            # Ray-like: queue length only, ignores reserved stateful capacity
            return min(avail, key=lambda i: (len(i.queue) + i.in_flight, i.instance_id))
        # load_state: predicted work = backlog + in-flight + expected re-entries
        def score(i: Instance) -> float:
            backlog = i.backlog_work() + i.in_flight * mean_service
            reentry = i.outstanding_stateful * mean_service * self.reentry_weight
            return backlog + reentry

        return min(avail, key=lambda i: (score(i), i.instance_id))
