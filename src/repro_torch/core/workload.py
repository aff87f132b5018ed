"""Seeded open-loop workload generation for SLO benchmarking.

The SLO-violation experiments (paper sec. 4.1) drive the serving stack with an
*open-loop* arrival process: requests arrive on a clock the system does not
control, so queueing delay shows up as missed deadlines instead of being
hidden by closed-loop backpressure. This module generates those traces ahead
of time, deterministically:

  * a single ``numpy`` Generator seeds everything, and every draw happens in
    one fixed order (arrival times first, then the per-arrival class /
    shape / session draws in arrival order), so the same seed yields a
    byte-identical trace (``trace_bytes``) regardless of how the consumer
    paces through it;
  * each arrival is tagged with an :class:`SLOClass` — a pipeline name plus
    its end-to-end deadline — drawn from the configured mixture, so the
    benchmark can report violation rates *per pipeline class*;
  * a configurable fraction of arrivals open multi-turn sessions: the
    generator expands them into per-turn events separated by think times.
    Turn ``k`` additionally may not start before turn ``k-1`` finished —
    that data-dependent constraint is the driver's to enforce (the trace
    only carries the nominal think-time arrivals).

Three arrival processes cover the paper's load shapes:

``poisson``
    homogeneous Poisson at ``rate_rps``.
``diurnal``
    sinusoidally-modulated Poisson, implemented by thinning a homogeneous
    process at the peak rate ``rate_rps * (1 + diurnal_depth)``.
``bursty``
    a two-state MMPP alternating a high-rate burst state and a quiet state
    with exponential dwell times, normalized so the long-run mean rate is
    ``rate_rps``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ARRIVALS = ("poisson", "diurnal", "bursty")


@dataclass(frozen=True)
class SLOClass:
    """One pipeline class in the workload mixture.

    ``deadline_s`` is the end-to-end deadline measured from arrival;
    ``weight`` is the (unnormalized) mixture probability. ``max_new`` bounds
    the final generation stage so deadline feasibility is shape-controlled.
    """

    name: str
    deadline_s: float
    weight: float = 1.0
    max_new: int = 8
    k_docs: int = 2


# Default mixture mirroring the paper's pipeline zoo. Deadlines are in
# *relative* units — benchmarks/slo_violations.py rescales them against a
# calibrated low-load mean (deadline = slo_scale x calibrated e2e), so these
# encode only the relative tightness between classes.
DEFAULT_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("vrag", deadline_s=1.0, weight=3.0),
    SLOClass("crag", deadline_s=2.0, weight=2.0),
    SLOClass("srag", deadline_s=2.5, weight=1.0),
    SLOClass("planrag", deadline_s=3.0, weight=1.0),
)


@dataclass
class WorkloadEvent:
    """One request arrival in an open-loop trace."""

    t: float            # nominal arrival time, seconds from trace start
    request_id: int     # unique, dense, in emission order
    slo_class: str      # SLOClass.name of the pipeline to run
    deadline_s: float   # relative deadline (absolute deadline = t + this)
    query_len: int      # tokens in the user query
    max_new: int        # decode budget for the final generation stage
    k_docs: int         # documents the pipeline's retriever should fetch
    complexity: float   # in [0, 1); drives data-dependent stage counts
    seed: int           # per-request stream for the pipeline's own draws
    session_id: int = -1  # -1: single shot; >=0: multi-turn session
    turn: int = 0       # turn index within the session

    def fields(self) -> Tuple:
        return (self.t, self.request_id, self.slo_class, self.deadline_s,
                self.query_len, self.max_new, self.k_docs, self.complexity,
                self.seed, self.session_id, self.turn)


@dataclass
class WorkloadSpec:
    """Everything that determines a trace (besides the seed)."""

    rate_rps: float = 8.0
    duration_s: float = 30.0
    arrival: str = "poisson"
    classes: Sequence[SLOClass] = DEFAULT_CLASSES
    session_fraction: float = 0.0   # fraction of arrivals that open sessions
    turns_range: Tuple[int, int] = (2, 5)  # inclusive turn-count bounds
    think_time_s: float = 1.0       # mean think time between session turns
    query_len_range: Tuple[int, int] = (8, 33)
    diurnal_depth: float = 0.5      # modulation depth for "diurnal"
    diurnal_period_s: Optional[float] = None  # default: one period per trace
    burst_factor: float = 4.0       # hi/lo rate ratio for "bursty"
    burst_dwell_s: float = 2.0      # mean dwell in each MMPP state


def _poisson_arrivals(rng, rate, duration) -> List[float]:
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= duration:
            return out
        out.append(t)


def _diurnal_arrivals(rng, spec: WorkloadSpec) -> List[float]:
    """Thinning: draw at the peak rate, keep with probability lam(t)/peak."""
    period = spec.diurnal_period_s or spec.duration_s
    peak = spec.rate_rps * (1.0 + spec.diurnal_depth)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= spec.duration_s:
            return out
        lam = spec.rate_rps * (
            1.0 + spec.diurnal_depth * math.sin(2.0 * math.pi * t / period))
        if rng.random() < lam / peak:
            out.append(t)


def _bursty_arrivals(rng, spec: WorkloadSpec) -> List[float]:
    """Two-state MMPP with equal mean dwells, normalized to ``rate_rps``:
    r_hi = burst_factor * r_lo and (r_hi + r_lo) / 2 == rate_rps."""
    r_lo = 2.0 * spec.rate_rps / (1.0 + spec.burst_factor)
    r_hi = spec.burst_factor * r_lo
    out, t, hi = [], 0.0, True
    state_end = rng.exponential(spec.burst_dwell_s)
    while t < spec.duration_s:
        rate = r_hi if hi else r_lo
        t += rng.exponential(1.0 / rate)
        while t >= state_end:  # state flips are clock-driven, not draw-driven
            hi = not hi
            state_end += rng.exponential(spec.burst_dwell_s)
        if t < spec.duration_s:
            out.append(t)
    return out


def generate(spec: WorkloadSpec, seed: int = 0) -> List[WorkloadEvent]:
    """Deterministically expand ``spec`` into a time-sorted event trace.

    One rng, one draw order: all arrival times first, then the per-arrival
    draws in arrival order (class, shape, session membership, turn think
    times). Events are returned sorted by (t, request_id) with dense ids in
    emission order, so equality of two traces is equality of every field.
    """
    if spec.arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival process: {spec.arrival!r}")
    rng = np.random.default_rng(seed)
    if spec.arrival == "poisson":
        base = _poisson_arrivals(rng, spec.rate_rps, spec.duration_s)
    elif spec.arrival == "diurnal":
        base = _diurnal_arrivals(rng, spec)
    else:
        base = _bursty_arrivals(rng, spec)

    classes = list(spec.classes)
    w = np.asarray([c.weight for c in classes], float)
    w = w / w.sum()
    qlo, qhi = spec.query_len_range

    events: List[WorkloadEvent] = []
    rid = 0
    n_sessions = 0
    for t in base:
        cls = classes[int(rng.choice(len(classes), p=w))]
        qlen = int(rng.integers(qlo, qhi))
        complexity = float(rng.random())
        req_seed = int(rng.integers(0, 2**31 - 1))
        in_session = (spec.session_fraction > 0.0
                      and rng.random() < spec.session_fraction)
        if not in_session:
            events.append(WorkloadEvent(
                t=t, request_id=rid, slo_class=cls.name,
                deadline_s=cls.deadline_s, query_len=qlen,
                max_new=cls.max_new, k_docs=cls.k_docs,
                complexity=complexity, seed=req_seed))
            rid += 1
            continue
        sid = n_sessions
        n_sessions += 1
        n_turns = int(rng.integers(spec.turns_range[0],
                                   spec.turns_range[1] + 1))
        tt = t
        for turn in range(n_turns):
            if turn:
                tt += rng.exponential(spec.think_time_s)
                qlen = int(rng.integers(qlo, qhi))
                complexity = float(rng.random())
                req_seed = int(rng.integers(0, 2**31 - 1))
            if tt >= spec.duration_s:
                break
            events.append(WorkloadEvent(
                t=tt, request_id=rid, slo_class=cls.name,
                deadline_s=cls.deadline_s, query_len=qlen,
                max_new=cls.max_new, k_docs=cls.k_docs,
                complexity=complexity, seed=req_seed,
                session_id=sid, turn=turn))
            rid += 1
    events.sort(key=lambda e: (e.t, e.request_id))
    return events


def realized_rate(events: Sequence[WorkloadEvent], spec: WorkloadSpec) -> float:
    """Mean arrival rate the trace actually realized (all turns counted)."""
    return len(events) / spec.duration_s if spec.duration_s > 0 else 0.0


def trace_bytes(events: Sequence[WorkloadEvent]) -> bytes:
    """Canonical serialization: one line per event, floats at fixed
    precision, so byte equality == trace equality."""
    lines = []
    for e in events:
        lines.append(
            f"{e.t:.9f}\t{e.request_id}\t{e.slo_class}\t{e.deadline_s:.9f}\t"
            f"{e.query_len}\t{e.max_new}\t{e.k_docs}\t{e.complexity:.9f}\t"
            f"{e.seed}\t{e.session_id}\t{e.turn}")
    return ("\n".join(lines) + "\n").encode("utf-8")


def by_class(events: Sequence[WorkloadEvent]) -> Dict[str, List[WorkloadEvent]]:
    out: Dict[str, List[WorkloadEvent]] = {}
    for e in events:
        out.setdefault(e.slo_class, []).append(e)
    return out
