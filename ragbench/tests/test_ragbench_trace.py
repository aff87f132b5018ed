"""The traced slice's reduction: the marker aligns the device's clock with
the benchmark's, busy time is the union of the device's operations inside
the slice, and each idle gap goes to the host span it falls in."""
import pytest

from ragbench import trace

US = 1000  # nanoseconds


def test_reduce_aligns_the_clocks_by_the_marker():
    # device clock: the marker at 1000 us; host clock: launched at 5.0 s
    events = [("spin_kernel(long)", 1000 * US, 1001 * US),
              ("gemm", 1100 * US, 1400 * US),
              ("paged_chunk_tc_kernel", 1350 * US, 1500 * US),   # overlaps gemm
              ("gemm", 1800 * US, 2000 * US),
              ("late", 2100 * US, 2300 * US)]                    # ends past the slice
    host0, host1 = 5.0, 5.0 + 1200e-6
    spans = [("step", 5.0 + 500e-6, 5.0 + 900e-6),     # device 1500-1900 us
             ("retrieve", 5.0 + 1000e-6, 5.0 + 1150e-6)]  # device 2000-2150 us
    r = trace.reduce(events, spans, host0, host1)
    assert r["marker"] == "spin_kernel(long)"
    assert r["window_s"] == pytest.approx(1200e-6)
    # busy: 1100-1500, 1800-2000, 2100-2200 (clipped at the slice's end)
    assert r["busy_s"] == pytest.approx(700e-6)
    assert r["paged_s"] == pytest.approx(150e-6)
    idle = dict(r["breakdown"]["idle_gaps"])
    # gaps: 1000-1100 (no span), 1500-1800 (step), 2000-2100 (retrieve)
    assert idle == pytest.approx({"client.loop": 100e-6, "step": 300e-6, "retrieve": 100e-6})
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["gemm"] == pytest.approx(500e-6) and "spin_kernel(long)" not in ops


def test_reduce_falls_back_to_the_first_operation_and_reads_nothing_alone():
    events = [("b", 20 * US, 30 * US), ("a", 10 * US, 11 * US)]
    r = trace.reduce(events, [], 1.0, 1.0 + 40e-6)
    assert r["marker"] == "a" and r["busy_s"] == pytest.approx(10e-6)
    assert trace.reduce([("a", 0, 1)], [], 0.0, 1.0) is None


def test_spans_are_kept_only_while_on():
    s = trace.Spans()
    with s("step"):
        pass
    assert s.items == []
    s.on = True
    with s("step"):
        pass
    assert [n for n, _, _ in s.items] == ["step"] and s.items[0][1] <= s.items[0][2]


def test_device_idle_takes_the_busy_time_a_step_from_the_slice():
    from ragbench import spec

    class Run:
        loop = "open"
        w0, w1 = 0.0, 10.0
        a, b = type("A", (), {"steps": 0}), type("B", (), {"steps": 200})  # 50 ms a step
        trace = {"busy_s": 0.6, "window_s": 2.0, "slice_steps": 30}       # 20 ms busy a step

    assert spec.reader("device_idle.open")(Run) == pytest.approx(60.0)
    Run.trace = None
    assert spec.reader("device_idle.open")(Run) is None
