"""The port's deployment LP (``core/allocation.py``, the paper's Fig. 8
generalized network flow) against the JAX package on the CPU: the same
graph and keywords give the same ``status`` and ``instances``, resources
and flows, and ``throughput`` within 1e-9 relative, on the six apps'
captured graphs (profiled as the runtime profiles them), on
``random_graph(n, seed)`` and under each keyword of ``solve_allocation``."""
import dataclasses
import random

import pytest

import repro.apps as japps
import repro.core.allocation as jalloc
import repro.core.profiling as jprof
import repro_torch.apps as tapps
import repro_torch.core.allocation as talloc
import repro_torch.core.profiling as tprof

APP_NAMES = ("vrag", "crag", "srag", "arag", "graphrag", "planrag")
BUDGETS = {"GPU": 32, "CPU": 256, "RAM": 1024}


def _same_plan(got, want):
    assert got.status == want.status
    assert got.instances == want.instances
    assert got.throughput == pytest.approx(want.throughput, rel=1e-9, abs=1e-12)
    assert got.resources.keys() == want.resources.keys()
    for comp, alloc in want.resources.items():
        assert got.resources[comp] == pytest.approx(alloc, rel=1e-9, abs=1e-9), comp
    assert got.flows == pytest.approx(want.flows, rel=1e-9, abs=1e-9)
    assert got.solve_time_s >= 0.0


def _graph(g):
    nodes = {n: dataclasses.asdict(m) for n, m in g.nodes.items()}
    return g.name, nodes, [(e.src, e.dst, e.prob, e.recursive, e.count) for e in g.edges]


def _apps(name):
    """The app in both packages, profiled from seed 0 as the runtime does
    (``WebSearch`` draws its jitter from Python's ``random``: reseeded)."""
    j, t = japps.make_app(name), tapps.make_app(name)
    random.seed(0)
    jprof.profile_components(j.components, seed=0)
    random.seed(0)
    tprof.profile_components(t.components, seed=0)
    return j, t


def _base(app):
    return {c: comp.meta.base_instances for c, comp in app.components.items()}


@pytest.mark.parametrize("name", APP_NAMES)
def test_app_graph_plans_match_jax(name):
    j, t = _apps(name)
    assert _graph(t.workflow_graph) == _graph(j.workflow_graph)
    for kw in ({}, {"min_instances": "base"}):
        jkw = {k: _base(j) for k in kw}
        tkw = {k: _base(t) for k in kw}
        want = jalloc.solve_allocation(j.workflow_graph, BUDGETS, **jkw)
        got = talloc.solve_allocation(t.workflow_graph, BUDGETS, **tkw)
        _same_plan(got, want)
        assert got.status == "optimal" and got.throughput > 0


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_graph_plans_match_jax(n, seed):
    jg, tg = jalloc.random_graph(n, seed), talloc.random_graph(n, seed)
    assert _graph(tg) == _graph(jg)
    budgets = {"CPU": 64, "GPU": 8}
    _same_plan(talloc.solve_allocation(tg, budgets), jalloc.solve_allocation(jg, budgets))


KEYWORDS = {
    "source_rate": dict(source_rate=7.5, resource_penalty=1e-6),
    "source_rate_slack": dict(source_rate=1e6),
    "alpha_scale": dict(alpha_scale={"CGenerator": 1.8, "CGrader": 0.6}),
    "tp_dict": dict(tp_degree={"CGenerator": 2, "CGrader": 4},
                    tp_efficiency={"CGenerator": 0.9}),
    "tp_callable": dict(tp_degree={"CGenerator": 4},
                        tp_efficiency=lambda t: 1.0 / (1.0 + 0.2 * (t - 1))),
    "tp_default": dict(tp_degree={"CRewriter": 2}),
    "kv_capacity_scale": dict(kv_capacity_scale={"CGenerator": 36864 / 18468}),
    "all": dict(alpha_scale={"CGenerator": 1.3}, tp_degree={"CGenerator": 2},
                tp_efficiency={"CGenerator": 0.95}, kv_capacity_scale={"CGrader": 2.0},
                min_instances={"CGrader": 3, "CRetriever": 2, "absent": 4}),
    "infeasible": dict(min_instances={"CGrader": 40}),
}


@pytest.mark.parametrize("case", sorted(KEYWORDS))
def test_solve_allocation_keywords_match_jax(case):
    j, t = _apps("crag")
    kw = KEYWORDS[case]
    want = jalloc.solve_allocation(j.workflow_graph, BUDGETS, **kw)
    got = talloc.solve_allocation(t.workflow_graph, BUDGETS, **kw)
    _same_plan(got, want)
    if case == "infeasible":
        assert got.status.startswith("infeasible") and got.instances == {}
    else:
        assert got.status == "optimal"
    if case == "source_rate":
        assert got.throughput == pytest.approx(7.5, rel=1e-6)


def test_capacity_multipliers_move_the_plan():
    """alpha_scale and kv_capacity_scale are the same alpha multiplier: at a
    capped load they free Generator replicas, and tp_degree counts t
    bundles as one replica."""
    _, t = _apps("crag")
    g = t.workflow_graph
    cap = dict(source_rate=10.0, resource_penalty=1e-6)
    base = talloc.solve_allocation(g, BUDGETS, **cap)
    assert base.throughput == pytest.approx(10.0, rel=1e-6)
    kv = talloc.solve_allocation(g, BUDGETS, kv_capacity_scale={"CGenerator": 2.0}, **cap)
    alpha = talloc.solve_allocation(g, BUDGETS, alpha_scale={"CGenerator": 2.0}, **cap)
    assert kv.resources["CGenerator"]["GPU"] == pytest.approx(
        base.resources["CGenerator"]["GPU"] / 2, rel=1e-6)
    for comp, alloc in alpha.resources.items():
        assert kv.resources[comp] == pytest.approx(alloc, rel=1e-9, abs=1e-9), comp
    tp = talloc.solve_allocation(g, BUDGETS, tp_degree={"CGenerator": 2}, **cap)
    assert tp.instances["CGenerator"] <= base.instances["CGenerator"]


@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_default_tp_efficiency_matches_jax(t):
    for f in (0.0, 0.08, 0.5):
        assert talloc._default_tp_efficiency(t, f) == jalloc._default_tp_efficiency(t, f)
    assert talloc._default_tp_efficiency(t) == jalloc._default_tp_efficiency(t)

