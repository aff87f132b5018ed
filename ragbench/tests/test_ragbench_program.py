"""What the benchmark reads of the engine's own recorder: the admission
stamps behind ``queue_wait_p95_ms.open``, read from each request, nothing
from an engine that does not stamp admission; and a program span nested in
the client's ``step`` takes the idle gaps inside it."""
import math

import numpy as np
import pytest

import tiny
from ragbench import spec, stats, trace
from ragbench.bench import run_cell
from ragbench.workload import Plan

SEED = 2**31 + 23


class Req:
    def __init__(self, submitted_at, admitted_at):
        self.submitted_at, self.admitted_at = submitted_at, admitted_at


def _run(reqs, w0=10.0, w1=20.0):
    sent = []
    for r in reqs:
        p = Plan(0, r.submitted_at, 0, 1, np.zeros(1, np.int32), np.zeros(1, np.int64))
        s = stats.Sent(p, r.submitted_at, r.submitted_at, 10.0)
        s.req = r
        sent.append(s)

    class Run:
        loop = "open"

    Run.sent, Run.w0, Run.w1 = sent, w0, w1
    return Run


def test_queue_wait_is_over_requests_submitted_in_the_window():
    read = spec.reader("queue_wait_p95_ms.open")
    reqs = [Req(9.0, 12.0),          # submitted before the window: not counted
            Req(11.0, 11.25),        # 0.25 s
            Req(12.0, 12.0),         # 0
            Req(15.0, None),         # not admitted: counts at 20 - 15
            Req(18.0, 21.0),         # admitted after the end: 20 - 18
            Req(20.0, 20.5)]         # submitted at the end: not counted
    want = 1e3 * np.percentile([0.25, 0.0, 5.0, 2.0], 95)
    assert read(_run(reqs)) == pytest.approx(want)


def test_queue_wait_reads_nothing_without_admission_stamps():
    read = spec.reader("queue_wait_p95_ms.open")

    class Parent:   # a Request of an engine that stamps submission only
        submitted_at = 12.0

    assert read(_run([Req(11.0, 11.5), Parent()])) is None
    assert read(_run([])) is None
    closed = _run([Req(11.0, 11.5)])
    closed.loop = "closed"
    assert read(closed) is None


def test_a_program_span_inside_step_takes_the_gap():
    US = 1000
    events = [("spin_kernel", 1000 * US, 1001 * US),
              ("gemm", 1100 * US, 1200 * US),
              ("gemm", 1500 * US, 1600 * US),
              ("gemm", 1700 * US, 1800 * US)]
    host0, host1 = 5.0, 5.0 + 900e-6
    at = lambda us: host0 + us * 1e-6     # device 1000 + us
    spans = [("step", at(10), at(895)),              # the client's span
             ("engine.step", at(20), at(890)),       # the program's, inside it
             ("plan", at(210), at(480)),             # holds the gap 1200-1500
             ("launch", at(490), at(690))]           # holds the gap 1600-1700
    r = trace.reduce(events, spans, host0, host1)
    idle = dict(r["breakdown"]["idle_gaps"])
    # gaps: 1000-1100 (engine.step alone), 1200-1500 (plan), 1600-1700
    # (launch), 1800-1900 (engine.step alone)
    assert idle == pytest.approx({"engine.step": 200e-6, "plan": 300e-6, "launch": 100e-6})
    # without the program's spans the same gaps fall to the client's step
    r = trace.reduce(events, spans[:1], host0, host1)
    assert dict(r["breakdown"]["idle_gaps"]) == pytest.approx({"step": 600e-6})


def test_a_traced_tiny_run_reports_the_queue_wait(tmp_path):
    cell = tiny.tiny_cell(tmp_path)
    out = run_cell(cell, SEED, 3.0, True, device="cpu")
    assert out["correct"] is True
    m = out["metrics"]
    v = m["queue_wait_p95_ms.open"]["value"]
    assert math.isfinite(v) and 0.0 <= v <= m["ttft_p95_ms"]["value"]
    assert m["queue_wait_p95_ms.open"]["unit"] == "ms"
