"""Workflow-wide telemetry: per-request trace spans + time-series gauges.

The paper's thesis is that per-component metrics are not enough — the
controller needs *workflow-wide* visibility (queueing cascades, branch
frequencies, critical paths). This module provides:

  * Dapper-style trace spans per request stage (queue + service + transfer),
  * time-series gauges (queue depth, instance count, chunk size, pool
    utilization) sampled on events,
  * critical-path extraction over a request's spans.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class Span:
    req_id: int
    comp: str
    instance_id: int
    enqueued: float
    started: float
    finished: float

    @property
    def queue_s(self) -> float:
        return self.started - self.enqueued

    @property
    def service_s(self) -> float:
        return self.finished - self.started


class Telemetry:
    def __init__(self, max_series: int = 100_000):
        self.spans: Dict[int, List[Span]] = defaultdict(list)
        self.gauges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self._max = max_series

    # ------------------------------------------------------------ recording
    def record_span(self, span: Span):
        self.spans[span.req_id].append(span)

    def gauge(self, name: str, t: float, value: float):
        series = self.gauges[name]
        if len(series) < self._max:
            series.append((t, value))

    # ------------------------------------------------------------ analysis
    def critical_path(self, req_id: int) -> List[Tuple[str, float, float]]:
        """Per-stage (component, queue_s, service_s) in execution order —
        the Dapper/CRISP-style view the paper argues RAG needs."""
        return [
            (s.comp, s.queue_s, s.service_s)
            for s in sorted(self.spans.get(req_id, []), key=lambda s: s.enqueued)
        ]

    def queue_time_share(self) -> Dict[str, float]:
        """Fraction of total request time spent queueing, per component —
        identifies where the queueing cascade forms."""
        q: Dict[str, float] = defaultdict(float)
        s: Dict[str, float] = defaultdict(float)
        for spans in self.spans.values():
            for sp in spans:
                q[sp.comp] += sp.queue_s
                s[sp.comp] += sp.service_s
        return {
            c: min(max(q[c] / max(q[c] + s[c], 1e-12), 0.0), 1.0)
            for c in set(q) | set(s)
        }

    def last(self, name: str, default: float = 0.0) -> float:
        """Latest value of a gauge (e.g. ``prefix_hit_rate/<comp>`` exported
        online by the controller's reallocation loop)."""
        series = self.gauges.get(name, [])
        return series[-1][1] if series else default

    def gauge_stats(self, name: str) -> Dict[str, float]:
        series = self.gauges.get(name, [])
        if not series:
            return {}
        vals = [v for _, v in series]
        return {
            "mean": sum(vals) / len(vals),
            "max": max(vals),
            "last": vals[-1],
            "n": len(vals),
        }

    def ascii_sparkline(self, name: str, width: int = 60) -> str:
        """Terminal-friendly gauge trace (for examples/ops runbooks)."""
        series = self.gauges.get(name, [])
        if not series:
            return "(no data)"
        vals = [v for _, v in series]
        # resample to `width` buckets
        step = max(len(vals) // width, 1)
        buckets = [max(vals[i : i + step]) for i in range(0, len(vals), step)][:width]
        lo, hi = min(buckets), max(buckets)
        chars = " ▁▂▃▄▅▆▇█"
        span = max(hi - lo, 1e-12)
        return "".join(chars[int((v - lo) / span * (len(chars) - 1))] for v in buckets)
