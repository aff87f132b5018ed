"""Discrete-event cluster substrate.

Models the paper's testbed abstractly: nodes with heterogeneous resource
pools (CPU cores, GPUs, RAM), long-running component instances with queues,
and a transport with distinct intra-node (shared-memory) and inter-node
(gRPC) cost. The control plane (controller/scheduler/router/autoscaler) is
REAL code running against this virtual clock; only compute occupancy is
simulated, calibrated against real component execution by core.profiling.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

# transport model (per message): grpc ~ paper's measured overhead (<1% of
# single-node perf); shm effectively free
GRPC_BASE_S = 0.0004
GRPC_PER_MB_S = 0.008
SHM_BASE_S = 0.00002
SHM_PER_MB_S = 0.0005


@dataclass
class Node:
    node_id: int
    cpu: float = 32.0
    gpu: float = 8.0
    ram: float = 256.0
    cpu_used: float = 0.0
    gpu_used: float = 0.0
    ram_used: float = 0.0

    def fits(self, res: Dict[str, float]) -> bool:
        return (
            self.cpu_used + res.get("CPU", 0) <= self.cpu
            and self.gpu_used + res.get("GPU", 0) <= self.gpu
            and self.ram_used + res.get("RAM", 0) <= self.ram
        )

    def take(self, res: Dict[str, float]):
        self.cpu_used += res.get("CPU", 0)
        self.gpu_used += res.get("GPU", 0)
        self.ram_used += res.get("RAM", 0)

    def release(self, res: Dict[str, float]):
        self.cpu_used -= res.get("CPU", 0)
        self.gpu_used -= res.get("GPU", 0)
        self.ram_used -= res.get("RAM", 0)


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)


class SimClock:
    def __init__(self):
        self.now = 0.0
        self._heap: List[_Event] = []
        self._seq = itertools.count()

    def schedule(self, delay: float, fn: Callable):
        heapq.heappush(self._heap, _Event(self.now + max(delay, 0.0), next(self._seq), fn))

    def run(self, until: float = float("inf")):
        while self._heap and self._heap[0].time <= until:
            ev = heapq.heappop(self._heap)
            self.now = ev.time
            ev.fn()
        self.now = max(self.now, min(until, self.now if not self._heap else until))

    @property
    def pending(self) -> int:
        return len(self._heap)


@dataclass
class Task:
    req: Any                       # runtime Request object
    comp_name: str
    features: Dict[str, float]
    enqueued_at: float
    priority: float = 0.0          # smaller = more urgent (EDF slack)
    service_s: float = 0.0


class Instance:
    """A long-running component instance pinned to a node."""

    _ids = itertools.count()

    def __init__(self, comp_name: str, node: Node, resources: Dict[str, float],
                 concurrency: int = 1):
        self.instance_id = next(Instance._ids)
        self.comp_name = comp_name
        self.node = node
        self.resources = resources
        self.concurrency = concurrency
        self.queue: List[Task] = []
        self.in_flight = 0
        self.busy_time = 0.0
        self.completed = 0
        self.outstanding_stateful = 0     # expected re-entrant load (state-aware routing)
        self.ready_at = 0.0               # cold-start: instance usable after this time
        self.draining = False

    def backlog_work(self) -> float:
        return sum(t.service_s for t in self.queue)

    def __repr__(self):
        return f"<{self.comp_name}#{self.instance_id}@n{self.node.node_id} q={len(self.queue)}>"


def transfer_time(size_mb: float, same_node: bool) -> float:
    if same_node:
        return SHM_BASE_S + size_mb * SHM_PER_MB_S
    return GRPC_BASE_S + size_mb * GRPC_PER_MB_S
