"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
seconds of steady serving after the measured window, recording the
device's operations only, so that the host loop runs in the slice as in the
window (the run prints the slice's step time beside the window's). Reduced
to the device's busy time, kernel time by name, and the device's idle gaps
by what the client loop was doing, from its own spans on the benchmark's
clock (``retrieve``, ``submit``, ``step``; a gap under none of them is
``client.loop``).

The two clocks are aligned by a marker: the slice starts on an idle device
(synchronized, before the profiler starts) by launching one small kernel:
``torch.cuda._sleep``'s ``spin_kernel`` (or, failing the name, the
trace's first device operation) starts when the host launched it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

MARKER = "spin_kernel"
PAGED_KERNELS = ("paged_decode_split", "paged_chunk", "chunk_plan", "split_merge")


class _Span:
    def __init__(self, items: list, name: str):
        self.items, self.name = items, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.items.append((self.name, self.t0, time.perf_counter()))


class Spans:
    """The client loop's host spans, (name, start, end) in seconds on the
    benchmark's clock, kept only while ``on``."""

    def __init__(self):
        self.on = False
        self.items: List[Tuple[str, float, float]] = []

    def __call__(self, name: str):
        return _Span(self.items, name) if self.on else contextlib.nullcontext()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of the device's operations that a finished
    ``torch.profiler.profile`` recorded, read from its raw Kineto results
    (building the profiler's event tree would take longer than the slice)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def reduce(events, spans, host0: float, host1: float) -> Dict:
    """From ``device_events``, the client loop's ``spans`` and the slice's
    start and end on the benchmark's clock (``host0`` taken just before the
    marker's launch): busy and window seconds, device seconds by kernel
    name, idle seconds by host span, and the paged attention kernels'
    seconds. None where the slice ran no device op besides the marker."""
    events = sorted(events, key=lambda e: e[1])
    if len(events) < 2:
        return None
    marker = next((e for e in events if MARKER in e[0]), events[0])
    w0 = marker[1] / 1e3                          # microseconds, device clock
    w1 = w0 + (host1 - host0) * 1e6
    shift = w0 - host0 * 1e6
    kernels = [(a / 1e3, b / 1e3, name) for name, a, b in events if (name, a, b) != marker]
    spans = [(a * 1e6 + shift, b * 1e6 + shift, name) for name, a, b in spans]
    clipped = [(max(a, w0), min(b, w1)) for a, b, _ in kernels if b > w0 and a < w1]
    busy = _union(clipped)
    by_name: Dict[str, float] = {}
    for a, b, name in kernels:
        if b > w0 and a < w1:
            by_name[name] = by_name.get(name, 0.0) + (min(b, w1) - max(a, w0)) / 1e6
    idle: Dict[str, float] = {}
    cursor = w0
    for a, b in busy + [(w1, w1)]:
        if a > cursor:
            mid = (cursor + a) / 2
            inside = [(e - s, n) for s, e, n in spans if s <= mid < e]
            label = min(inside)[1] if inside else "client.loop"
            idle[label] = idle.get(label, 0.0) + (a - cursor) / 1e6
        cursor = max(cursor, b)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "marker": marker[0],
        "kernel_s": by_name,
        "paged_s": sum(v for k, v in by_name.items() if any(p in k for p in PAGED_KERNELS)),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)},
    }
