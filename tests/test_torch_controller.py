"""The port's Patchwork control plane against the JAX package on the CPU.

The same seeds and inputs go through both packages in one process:

* the workload generator (``make_workload``, ``sample_request_features``);
* the simulated cluster's pieces: ``SimClock`` ordering, ``Router`` picks
  on the same instance lists, ``Telemetry`` results op for op;
* ``PatchworkRuntime`` on the six apps under the three engine presets and
  two seeds, the load-shift workload (the autoscaler re-plans) and an
  instance failure: every ``Metrics`` field but the wall-clock
  ``controller_overhead_s`` compares with ``==``, and so do the plans, the
  telemetry gauges and the final instance counts;
* the entry points: ``serve_sim``'s printed line up to ``ctrl=`` and
  ``deploy_config``.

``WebSearch.estimate_time`` draws its jitter from Python's module-level
``random`` (both packages: the reference's behaviour, copied), so each side
reseeds it to the same value before it runs.
"""
import dataclasses
import json
import random
import re

import numpy as np
import pytest

import repro.apps as japps
import repro.core.controller as jctrl
import repro.core.router as jrouter
import repro.core.simcluster as jsim
import repro.core.telemetry as jtel
import repro.data.workload as jwl
import repro.launch.deploy_config as jdeploy
import repro.launch.serve as jserve
import repro_torch.apps as tapps
import repro_torch.core.controller as tctrl
import repro_torch.core.router as trouter
import repro_torch.core.simcluster as tsim
import repro_torch.core.telemetry as ttel
import repro_torch.data.workload as twl
import repro_torch.launch.deploy_config as tdeploy
import repro_torch.launch.serve as tserve

APP_NAMES = ("vrag", "crag", "srag", "arag", "graphrag", "planrag")
ENGINES = ("PATCHWORK", "MONOLITHIC", "RAY_LIKE")
BUDGETS = {"GPU": 32, "CPU": 256, "RAM": 1024}
JAX = (japps, jctrl, jwl)
PORT = (tapps, tctrl, twl)


# ------------------------------------------------------------------ workload
@pytest.mark.parametrize("rate,duration,seed", [(4.0, 15.0, 0), (24.0, 10.0, 1),
                                                (45.0, 40.0, 2), (0.5, 3.0, 7)])
def test_make_workload_matches_jax(rate, duration, seed):
    got = twl.make_workload(rate, duration, seed=seed)
    want = jwl.make_workload(rate, duration, seed=seed)
    assert got == want
    assert twl.ArrivalProcess(rate, duration, seed).arrivals() == \
        jwl.ArrivalProcess(rate, duration, seed).arrivals()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sample_request_features_matches_jax(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = [twl.sample_request_features(a) for _ in range(200)]
    want = [jwl.sample_request_features(b) for _ in range(200)]
    assert got == want
    assert all(8 <= f["tokens_in"] <= 2048 and 100 <= f["k_docs"] <= 300 for f in got)


# ------------------------------------------------------------------ pieces
def test_sim_clock_orders_events_as_jax():
    logs = []
    for mod in (jsim, tsim):
        clock, log = mod.SimClock(), []

        def ev(tag, again=None):
            def fn():
                log.append((tag, clock.now))
                if again is not None:
                    clock.schedule(again, ev(tag + "'"))
            return fn

        # equal times keep their scheduling order; negative delays clamp to 0
        for tag, delay, again in (("a", 1.0, 0.5), ("b", 0.25, None), ("c", 1.0, None),
                                  ("d", -3.0, 0.0), ("e", 0.25, 2.0), ("f", 7.0, None)):
            clock.schedule(delay, ev(tag, again))
        clock.run(until=2.0)
        log.append(("pending", clock.pending, clock.now))
        clock.run()
        log.append(("pending", clock.pending, clock.now))
        logs.append(log)
    assert logs[0] == logs[1]


def _instances(mod, rng):
    nodes = [mod.Node(i) for i in range(2)]
    out = []
    for i in range(6):
        inst = mod.Instance("G", nodes[i % 2], {"GPU": 1})
        inst.queue = [mod.Task(None, "G", {}, 0.0, service_s=float(s))
                      for s in rng.uniform(0.01, 0.3, int(rng.integers(0, 4)))]
        inst.in_flight = int(rng.integers(0, 2))
        inst.outstanding_stateful = float(rng.integers(0, 3))
        inst.ready_at = float(rng.choice([0.0, 0.0, 5.0]))
        inst.draining = bool(rng.random() < 0.15)
        out.append(inst)
    return out


@pytest.mark.parametrize("policy", ["load_state", "idle_first", "random"])
def test_router_picks_as_jax(policy):
    picks = []
    for mod, rmod in ((jsim, jrouter), (tsim, trouter)):
        rng = np.random.default_rng(5)
        router = rmod.Router(policy, reentry_weight=0.7, seed=3)
        got = []
        for trial in range(60):
            insts = _instances(mod, rng)
            sticky_i = int(rng.integers(-1, len(insts)))
            sticky = insts[sticky_i].instance_id if sticky_i >= 0 else None
            task = mod.Task(None, "G", {}, 0.0, service_s=0.1)
            now = float(rng.choice([0.0, 6.0]))
            pick = router.pick(insts, task, now, mean_service=float(rng.uniform(0.01, 0.2)),
                               sticky=sticky)
            got.append(insts.index(pick))
        picks.append((got, router.decisions))
    assert picks[0] == picks[1]


def test_telemetry_matches_jax_op_for_op():
    outs = []
    for mod in (jtel, ttel):
        rng = np.random.default_rng(2)
        tel = mod.Telemetry(max_series=40)
        for i in range(120):
            enq = float(rng.uniform(0, 10))
            start = enq + float(rng.uniform(0, 1))
            tel.record_span(mod.Span(int(rng.integers(0, 8)), f"c{int(rng.integers(0, 3))}",
                                     i, enq, start, start + float(rng.uniform(0, 0.5))))
            tel.gauge(f"g{i % 2}", float(i), float(rng.normal()))
        outs.append((
            [tel.critical_path(r) for r in range(9)],
            sorted(tel.queue_time_share().items()),
            [tel.last(n, -1.0) for n in ("g0", "g1", "none")],
            [tel.gauge_stats(n) for n in ("g0", "g1", "none")],
            [tel.ascii_sparkline(n, w) for n in ("g0", "none") for w in (7, 60)],
            {k: list(v) for k, v in tel.gauges.items()},
        ))
    assert outs[0] == outs[1]


def test_transfer_time_matches_jax():
    for mb in (0.0, 0.01, 0.5, 12.0):
        for same in (True, False):
            assert tsim.transfer_time(mb, same) == jsim.transfer_time(mb, same)
    for name in ("GRPC_BASE_S", "GRPC_PER_MB_S", "SHM_BASE_S", "SHM_PER_MB_S"):
        assert getattr(tsim, name) == getattr(jsim, name)


# ------------------------------------------------------------------ runtime
def _metrics(m):
    d = dataclasses.asdict(m)
    d.pop("controller_overhead_s")
    d["failovers"] = getattr(m, "failovers", None)
    d["derived"] = (m.throughput, m.goodput, m.slo_violation_rate,
                    m.latency_pct(50), m.latency_pct(99))
    return d


def _plan(plan):
    d = dataclasses.asdict(plan)
    d.pop("solve_time_s")
    return d


def _runtime_state(rt):
    gauges = {k: list(v) for k, v in rt.telemetry.gauges.items()}
    spans = sorted((s.req_id, s.comp, s.enqueued, s.started, s.finished)
                   for spans in rt.telemetry.spans.values() for s in spans)
    counts = {c: [(len(i.queue), i.in_flight, i.completed, i.busy_time, i.draining,
                   i.ready_at, i.node.node_id) for i in v]
              for c, v in rt.instances.items()}
    plan = _plan(rt.plan) if hasattr(rt, "plan") else None
    return gauges, spans, counts, plan, rt._last_plan, rt._pending_plan


def _both(fn, rseed=0):
    """``fn(package)`` once per package, Python's ``random`` reseeded first."""
    out = []
    for pkg in (JAX, PORT):
        random.seed(1000 + rseed)
        out.append(fn(*pkg))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("app_name", APP_NAMES)
def test_runtime_matches_jax(app_name, engine, seed):
    def run(apps, ctrl, wl):
        rt = ctrl.PatchworkRuntime(apps.make_app(app_name), BUDGETS,
                                   engine=getattr(ctrl, engine), slo_s=2.0, seed=seed)
        m = rt.run(wl.make_workload(24, 15, seed=seed))
        return _metrics(m), _runtime_state(rt), m

    (jm, jstate, jraw), (tm, tstate, traw) = _both(run, seed)
    assert tm == jm
    assert tstate == jstate
    assert traw.completed == traw.offered > 0
    assert len(traw.controller_overhead_s) == len(jraw.controller_overhead_s)


def test_autoscaler_load_shift_matches_jax():
    """tests/test_runtime.py's load shift: 8 requests/s for 30 s, then 45/s
    for 40 s; the closed loop re-plans on both sides alike."""
    def run(apps, ctrl, wl):
        rt = ctrl.PatchworkRuntime(apps.make_app("crag"), BUDGETS, engine=ctrl.PATCHWORK,
                                   slo_s=2.0, seed=0)
        work = wl.make_workload(8, 30, seed=1) + [
            (30 + t, f) for t, f in wl.make_workload(45, 40, seed=2)]
        work.sort(key=lambda x: x[0])
        m = rt.run(work)
        return _metrics(m), _runtime_state(rt)

    (jm, jstate), (tm, tstate) = _both(run)
    assert tm == jm and tstate == jstate
    assert tm["realloc_events"] >= 1
    assert tstate[4] != tstate[3]["instances"]   # the applied plan moved off the first


def test_instance_failure_matches_jax():
    """tests/test_extensions.py's failover: a generator instance dies at 3 s;
    its queue is re-dispatched and a replacement comes up cold."""
    def run(apps, ctrl, wl):
        rt = ctrl.PatchworkRuntime(apps.make_app("vrag"), BUDGETS, engine=ctrl.PATCHWORK,
                                   slo_s=5.0, seed=0)
        victim = rt.instances["VGenerator"][0]
        rescued = []
        rt.clock.schedule(3.0, lambda: rescued.append(
            rt.fail_instance("VGenerator", victim.instance_id)))
        m = rt.run(wl.make_workload(20, 10, seed=0))
        alive = all(i is not victim for i in rt.instances["VGenerator"])
        return _metrics(m), _runtime_state(rt), rescued, alive, rt.fail_instance("VGenerator", -1)

    jax_side, port = _both(run)
    assert port == jax_side
    m, _, rescued, alive, missing = port
    assert m["failovers"] == 1 and m["completed"] == m["offered"]
    assert alive and missing == 0 and len(rescued) == 1


def test_ablation_switches_match_jax():
    """Non-preset EngineConfigs: FIFO under Patchwork's router, fixed chunks,
    no streaming, a random router, a short re-plan period."""
    for cfg in (dict(name="fifo", scheduler="fifo"),
                dict(name="fixed", streaming_mgmt=False, fixed_chunk=16),
                dict(name="nostream", streaming=False),
                dict(name="rand", router_policy="random", reallocate_period_s=2.0)):
        def run(apps, ctrl, wl):
            rt = ctrl.PatchworkRuntime(apps.make_app("arag"), BUDGETS,
                                       engine=ctrl.EngineConfig(**cfg), slo_s=1.5, seed=0)
            return _metrics(rt.run(wl.make_workload(30, 10, seed=0))), _runtime_state(rt)

        jax_side, port = _both(run)
        assert port == jax_side, cfg["name"]


# ------------------------------------------------------------------ entry points
def _line(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("[serve:")]
    assert len(lines) == 1, text
    return lines[0].split(" ctrl=")[0]


@pytest.mark.parametrize("app_name,engine", [("crag", "patchwork"), ("srag", "ray_like"),
                                             ("planrag", "monolithic")])
def test_serve_sim_prints_the_reference_line(app_name, engine, capsys):
    lines = []
    for mod in (jserve, tserve):
        random.seed(7)
        m = mod.serve_sim(app_name, 24, 10, engine)
        lines.append((_line(capsys.readouterr().out), _metrics(m)))
    assert lines[0] == lines[1]
    assert tserve.ENGINES.keys() == jserve.ENGINES.keys()
    assert tserve.DEFAULT_BUDGETS == jserve.DEFAULT_BUDGETS


def test_serve_cli_app_mode(capsys):
    """``--app`` selects the simulated mode: the reference CLI's default
    (neither ``--real`` nor ``--pipelines``) with the same options."""
    argv = ["--app", "crag", "--rate", "24", "--duration", "10", "--engine", "ray_like",
            "--slo", "1.5"]
    random.seed(3)
    jserve.main(argv)
    want = _line(capsys.readouterr().out)
    random.seed(3)
    tserve.main(argv)
    got = _line(capsys.readouterr().out)
    assert got == want
    assert re.match(r"\[serve:ray_like\] app=crag rate=24.0/s: thr=", got)


def _deploy(mod, spec):
    random.seed(11)
    rt, m = mod.run_deployment(spec)
    return (rt.app.name, dataclasses.asdict(rt.engine), rt.budgets, len(rt.nodes), rt.slo_s, _metrics(m),
            _runtime_state(rt), sorted(rt.telemetry.queue_time_share().items()))


def test_deploy_config_defaults_and_overrides_match_jax(tmp_path):
    assert tdeploy.DEFAULTS == jdeploy.DEFAULTS
    assert tdeploy.load_deployment({}) == jdeploy.load_deployment({})
    over = {"app": "crag", "engine": {"name": "ray_like", "scheduler": "fifo",
                                      "router_policy": "idle_first", "autoscale": False},
            "cluster": {"nodes": 2}, "budgets": {"GPU": 16, "CPU": 128, "RAM": 512},
            "slo_s": 3.0, "workload": {"rate": 12.0, "duration_s": 8.0, "seed": 3}}
    path = tmp_path / "deploy.json"
    path.write_text(json.dumps(over))
    cfg = tdeploy.load_deployment(str(path))
    assert cfg == jdeploy.load_deployment(str(path)) == tdeploy.load_deployment(over)
    assert cfg["cluster"]["node"] == tdeploy.DEFAULTS["cluster"]["node"]   # merged, not replaced
    assert _deploy(tdeploy, over) == _deploy(jdeploy, over)
    small = {"workload": {"rate": 6.0, "duration_s": 5.0}}
    assert _deploy(tdeploy, small) == _deploy(jdeploy, small)


def test_deploy_config_rejects_unknown_engine_keys():
    bad = {"engine": {"name": "patchwork", "warp_speed": 9, "autoscale": True}}
    with pytest.raises(ValueError) as te:
        tdeploy.load_deployment(bad)
    with pytest.raises(ValueError) as je:
        jdeploy.load_deployment(bad)
    assert str(te.value) == str(je.value) == "unknown engine options: ['warp_speed']"


def test_deploy_config_main_prints_the_reference_summary(tmp_path, capsys):
    path = tmp_path / "d.json"
    path.write_text(json.dumps({"app": "srag", "workload": {"rate": 10.0, "duration_s": 6.0}}))
    outs = []
    for mod in (jdeploy, tdeploy):
        random.seed(5)
        mod.main(["--config", str(path)])
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[1]["app"] == "srag" and outs[1]["engine"] == "patchwork"
