"""The served engine's hot-path recorder (``core.telemetry.Recorder``,
``GenerationEngine.telemetry``): its spans nest under ``engine.step`` with
the right parents, preemption mid-build included; every span and request
stamp is on ``time.perf_counter``; with the recorder off no span is kept
and the totals still add up; admission is stamped once and its prefix
deferrals counted; and turning the recorder on changes no plan and no
token. The port alone, on the CPU: nothing here imports JAX."""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core import telemetry
from repro_torch.core.telemetry import Recorder
from repro_torch.serving.engine import _MIRRORED_FIELDS, GenerationEngine
from torch_harness import bursty_workload, record_plans

torch.set_num_threads(1)

CFG = smoke_variant(get_arch("smollm-135m"))
STEP_CHILDREN = {"plan", "launch", "copies", "wait", "emit"}
# (seed, n_blocks, long_decode): a full pool, and a tiny pool whose long
# decodes run it dry, so that preemption lands the inflight plan mid-build
WORKLOADS = [(0, None, False), (2, 8, True), (5, 10, True)]
PLAN_FIELDS = ("tokens", "starts", "temps", "tables", "prev_slots", "n_valid",
               "positions", "p_end", "s_start", "row_of", "slots", "decode_idx",
               "last_idx")


def _engine(n_blocks=None, **kw):
    kw = {"max_batch": 3, "max_seq": 96, "prefill_chunk_size": 16, "token_budget": 20,
          "scheduler": "fifo", "preempt": "recompute", **kw}
    return GenerationEngine(CFG, n_blocks=n_blocks, device="cpu", seed=0, **kw)


def _parent_names(spans):
    return [(n, None if p is None else spans[p][0]) for n, _, _, p in spans]


# ---------------------------------------------------------------- recorder
def test_the_clock_is_perf_counter():
    assert telemetry.clock is time.perf_counter


def test_recorder_off_keeps_totals_and_no_spans():
    rec = Recorder()
    for _ in range(200):
        with rec.span("outer"):
            with rec.span("inner"):
                pass
            with rec.span("inner"):
                pass
    assert rec.spans == [] and rec._open == []
    assert rec.totals["outer"][1] == 200 and rec.totals["inner"][1] == 400
    assert 0.0 <= rec.totals["inner"][0] <= rec.totals["outer"][0]


def test_recorder_on_keeps_spans_with_their_parents():
    rec = Recorder()
    rec.on = True
    with rec.span("a"):
        with rec.span("b"):
            with rec.span("c"):
                pass
        with rec.span("d"):
            pass
    with rec.span("a"):
        pass
    assert _parent_names(rec.spans) == [("a", None), ("b", "a"), ("c", "b"), ("d", "a"),
                                        ("a", None)]
    for name, start, end, parent in rec.spans:
        assert start <= end
        if parent is not None:
            assert rec.spans[parent][1] <= start and end <= rec.spans[parent][2]
    assert rec._open == []
    assert {k: v[1] for k, v in rec.totals.items()} == {"a": 2, "b": 1, "c": 1, "d": 1}


def test_a_span_closes_when_its_block_raises():
    rec = Recorder()
    rec.on = True
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("inner"):
                raise ValueError
    assert _parent_names(rec.spans) == [("outer", None), ("inner", "outer")]
    assert all(s[2] >= s[1] > 0 for s in rec.spans)
    assert rec._open == [] and rec.totals["inner"][1] == 1


def test_recorder_turned_on_or_off_inside_a_span():
    rec = Recorder()
    with rec.span("outer"):           # opened while off: never kept
        rec.on = True
        with rec.span("inner"):       # kept, at the top
            pass
    assert _parent_names(rec.spans) == [("inner", None)] and rec._open == []
    rec.spans.clear()
    with rec.span("outer"):           # opened while on: closed though off
        rec.on = False
        with rec.span("inner"):
            pass
    assert _parent_names(rec.spans) == [("outer", None)] and rec.spans[0][2] > 0
    assert rec._open == [] and rec.totals["outer"][1] == 2


def test_counters_and_the_snapshot_is_a_copy():
    rec = Recorder()
    for _ in range(3):
        rec.count("x")
    with rec.span("s"):
        pass
    snap = rec.snapshot()
    assert snap["counters"] == {"x": 3} and snap["totals"]["s"][1] == 1
    rec.count("x")
    with rec.span("s"):
        pass
    assert snap["counters"] == {"x": 3} and snap["totals"]["s"][1] == 1
    assert rec.snapshot()["totals"]["s"][1] == 2


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("seed,n_blocks,long_decode", WORKLOADS)
def test_step_spans_nest_under_engine_step(seed, n_blocks, long_decode):
    eng = _engine(n_blocks)
    eng.telemetry.on = True
    bursty_workload(eng, seed, long_decode)
    spans = eng.telemetry.spans
    pairs = set(_parent_names(spans))
    allowed = {("engine.step", None), ("plan.admit", "plan")}
    allowed |= {(c, "engine.step") for c in STEP_CHILDREN}
    allowed |= {("wait", "plan"), ("emit", "plan")}   # preemption lands a plan mid-build
    assert pairs <= allowed, pairs - allowed
    assert {n for n, _ in pairs} == STEP_CHILDREN | {"engine.step", "plan.admit"}
    for name, start, end, parent in spans:
        assert start <= end
        if parent is not None:
            assert spans[parent][1] <= start and end <= spans[parent][2]
    if eng.preemptions:
        assert ("wait", "plan") in pairs and ("emit", "plan") in pairs
    assert eng.telemetry._open == []
    n = lambda name: sum(1 for s in spans if s[0] == name)
    assert n("engine.step") == n("plan") == n("plan.admit") == n("copies")
    assert n("launch") == eng.steps


@pytest.mark.parametrize("seed,n_blocks,long_decode", WORKLOADS)
def test_spans_and_stamps_lie_between_clock_reads(seed, n_blocks, long_decode):
    eng = _engine(n_blocks)
    eng.telemetry.on = True
    t0 = time.perf_counter()
    reqs = bursty_workload(eng, seed, long_decode)
    t1 = time.perf_counter()
    assert all(t0 <= s <= e <= t1 for _, s, e, _ in eng.telemetry.spans)
    for r in reqs:
        stamps = [r.submitted_at, r.admitted_at, r.first_token_at, r.last_token_at,
                  r.finished_at]
        assert all(t0 <= t <= t1 for t in stamps), (r.req_id, stamps)
        assert r.submitted_at <= r.admitted_at <= r.first_token_at <= r.finished_at
    # and step by step: each step's spans inside the clock reads around it
    eng.telemetry.spans.clear()
    eng.submit(np.arange(40) % 90, max_new=6)
    while eng.waiting or any(eng.slots) or eng.pending:
        a = time.perf_counter()
        eng.step()
        b = time.perf_counter()
        assert all(a <= s <= e <= b for _, s, e, _ in eng.telemetry.spans)
        eng.telemetry.spans.clear()


@pytest.mark.parametrize("seed,n_blocks,long_decode", WORKLOADS)
def test_recorder_off_keeps_no_spans_and_the_totals_add_up(seed, n_blocks, long_decode):
    eng = _engine(n_blocks)
    calls = 0
    step = eng.step

    def counted():
        nonlocal calls
        calls += 1
        return step()

    eng.step = counted
    bursty_workload(eng, seed, long_decode)
    rec = eng.telemetry
    assert rec.spans == [] and rec._open == []
    tot = rec.totals
    assert tot["engine.step"][1] == tot["plan"][1] == tot["plan.admit"][1] == calls
    assert tot["copies"][1] == calls and tot["launch"][1] == eng.steps
    assert tot["wait"][1] == eng.steps        # every dispatched plan lands once
    children = sum(tot[c][0] for c in STEP_CHILDREN)
    assert 0.0 < children <= tot["engine.step"][0]
    assert tot["plan.admit"][0] <= tot["plan"][0]
    assert eng.stats()["telemetry"]["totals"]["engine.step"] == tuple(tot["engine.step"])


@pytest.mark.parametrize("chunk", [16, 32])
def test_prefix_deferral_is_counted_and_admission_stamped(chunk):
    """Two requests with the same first block: the second waits, a slot
    free, while the first prefills its prompt chunk by chunk."""
    eng = _engine(max_batch=2, prefill_chunk_size=chunk, token_budget=chunk + 2)
    rng = np.random.default_rng(3)
    head = rng.integers(0, 90, 16)
    a = eng.submit(np.concatenate([head, rng.integers(0, 90, 60)]), max_new=3)
    b = eng.submit(np.concatenate([head, rng.integers(0, 90, 20)]), max_new=3)
    eng.run_until_done()
    deferred = eng.telemetry.counters["admit.deferred_prefix"]
    assert deferred >= -(-76 // chunk) - 1
    assert b.shared_prefix_tokens >= 16
    for r in (a, b):
        assert r.submitted_at <= r.admitted_at <= r.first_token_at
    assert a.admitted_at < b.admitted_at
    assert b.queued_steps == b.admitted_step - b.submitted_step >= deferred
    assert a.queued_steps == 0


def test_no_deferral_without_prefix_sharing():
    eng = _engine(max_batch=2, prefix_sharing=False)
    head = np.arange(16)
    for tail in (40, 20):
        eng.submit(np.concatenate([head, np.arange(tail) % 90]), max_new=3)
    eng.run_until_done()
    assert "admit.deferred_prefix" not in eng.telemetry.counters


@pytest.mark.parametrize("seed,n_blocks,long_decode", WORKLOADS)
@pytest.mark.parametrize("pipeline", [True, False])
def test_the_recorder_changes_no_plan_and_no_token(seed, n_blocks, long_decode, pipeline):
    runs = []
    for on in (False, True):
        eng = _engine(n_blocks, pipeline=pipeline)
        eng.telemetry.on = on
        plans = record_plans(eng)
        reqs = bursty_workload(eng, seed, long_decode)
        runs.append((eng, plans, reqs))
        assert bool(eng.telemetry.spans) == on
    (e0, p0, r0), (e1, p1, r1) = runs
    assert len(p0) == len(p1) > 0
    for a, b in zip(p0, p1):
        assert (a.plan_id, a.kind, a.n_tokens) == (b.plan_id, b.kind, b.n_tokens)
        for name in PLAN_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"plan {a.plan_id} {name}")
        assert [(r.req_id, row, f) for r, row, f in a.emit_rows] == \
            [(r.req_id, row, f) for r, row, f in b.emit_rows]
    assert [r.out_tokens for r in r0] == [r.out_tokens for r in r1]
    assert [r.queued_steps for r in r0] == [r.queued_steps for r in r1]
    assert e0.preemptions == e1.preemptions and e0.steps == e1.steps


@pytest.mark.parametrize("kw", [{"interleave": False}, {"backend": "dense"}],
                         ids=["sequential", "dense"])
def test_sequential_and_dense_paths_time_engine_step_alone(kw):
    eng = _engine(**kw)
    eng.telemetry.on = True
    rng = np.random.default_rng(4)
    reqs = [eng.submit(rng.integers(0, 90, int(n)), max_new=4) for n in (5, 30, 12, 9, 21)]
    eng.run_until_done()
    assert set(eng.telemetry.totals) == {"engine.step"}
    assert _parent_names(eng.telemetry.spans) == [("engine.step", None)] * len(
        eng.telemetry.spans) and eng.telemetry.spans
    for r in reqs:
        assert len(r.out_tokens) == 4
        assert r.submitted_at <= r.admitted_at <= r.first_token_at <= r.finished_at
    # five requests over three slots: the last two waited for a slot
    assert [r.queued_steps > 0 for r in reqs] == [False] * 3 + [True] * 2


def test_preemption_keeps_the_first_admission_stamp():
    eng = _engine(8)
    eng.telemetry.on = True
    stamps = {}
    orig = eng._preempt

    def preempt(victim):
        stamps[victim.req_id] = (victim.admitted_at, victim.admitted_step)
        orig(victim)

    eng._preempt = preempt
    reqs = bursty_workload(eng, 2, True)
    assert stamps and eng.preemptions >= len(stamps)
    for r in reqs:
        if r.req_id in stamps:
            assert r.done and (r.admitted_at, r.admitted_step) == stamps[r.req_id]


def test_host_gap_mean_is_the_total_over_the_gaps():
    eng = _engine()
    bursty_workload(eng, 0, False)
    run = eng.runner.summary()
    assert eng.runner.n_gaps > 0
    assert run["host_gap_mean_s"] == pytest.approx(run["host_gap_s"] / eng.runner.n_gaps)
    assert not hasattr(eng.runner, "gap_samples")


def test_a_data_axis_stand_in_takes_the_admission_stamps():
    assert {"admitted_at", "submitted_step", "admitted_step"} <= set(_MIRRORED_FIELDS)
    assert "queued_steps" not in _MIRRORED_FIELDS   # a property over the two steps


def test_serve_prints_the_step_spans(capsys):
    from repro_torch.launch.serve import serve_real

    eng = serve_real("smollm-135m", n_requests=3, max_new=4, smoke=True, device="cpu")
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if "step spans" in l)
    for name in ("plan", "plan.admit", "launch", "wait", "emit", "admit.deferred_prefix"):
        assert f" {name} " in line, line
    assert f"of {eng.steps} steps" in line
