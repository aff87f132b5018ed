"""The port's RAG layer above the engine against the JAX package on the CPU:
the apps' captured workflow graphs, the slack model, the workload
generator, sessions, the components' cost models, and the open-loop driver
end to end. The driver runs over the port's engine on the CPU and over the
JAX engine (``kernel="pallas"``, interpret mode), with the same weights
through the bridge, a virtual clock, EDF-slack admission and no host tier
on either side: records and every engine request's tokens must be equal."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.apps as japps
import repro.core.components as jcomp
import repro.core.slack as jslack
import repro.core.workload as jwl
import repro_torch.apps as tapps
import repro_torch.core.components as tcomp
import repro_torch.core.slack as tslack
import repro_torch.core.workload as twl
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_params as jax_init_params
from repro.serving.engine import GenerationEngine as JaxEngine
from repro.serving.session import Session as JaxSession
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.session import Session

torch.set_num_threads(1)

APP_NAMES = ("vrag", "crag", "srag", "arag", "graphrag", "planrag")


def _graph(app):
    g = app.workflow_graph
    nodes = {n: dataclasses.asdict(m) for n, m in g.nodes.items()}
    edges = [(e.src, e.dst, e.prob, e.recursive, e.count) for e in g.edges]
    return g.name, nodes, edges


@pytest.mark.parametrize("name", APP_NAMES)
def test_captured_graphs_match_jax(name):
    got, want = tapps.make_app(name), japps.make_app(name)
    assert got.name == want.name and got.workflow_loc == want.workflow_loc
    assert _graph(got) == _graph(want)
    assert set(got.components) == set(want.components)
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    for c in np.linspace(0.0, 0.99, 7):
        feats = {"complexity": float(c)}
        assert got.sample_path(feats, rng_a) == want.sample_path(feats, rng_b)


def test_slack_model_matches_jax():
    rng = np.random.default_rng(0)
    got, want = tslack.SlackModel(), jslack.SlackModel()
    comps = ["VGenerator", "CGrader", "PRetriever"]
    feats = [{f: float(rng.uniform(0, 2000)) for f in tslack.FEATURES} for _ in range(40)]
    for i, f in enumerate(feats):
        lat = float(rng.uniform(0.01, 0.5))
        got.observe(comps[i % 3], f, lat)
        want.observe(comps[i % 3], f, lat)
        for c in comps + ["unseen"]:
            np.testing.assert_allclose(got.predict_stage(c, f), want.predict_stage(c, f),
                                       rtol=1e-9)
    path = comps + comps[:1]
    np.testing.assert_allclose(got.slack(0.3, 2.0, path, feats[0]),
                               want.slack(0.3, 2.0, path, feats[0]), rtol=1e-9)


@pytest.mark.parametrize("arrival", twl.ARRIVALS)
def test_workload_traces_match_jax(arrival):
    kw = dict(rate_rps=12.0, duration_s=3.0, arrival=arrival, session_fraction=0.3,
              think_time_s=0.3)
    got = twl.generate(twl.WorkloadSpec(**kw), seed=5)
    want = jwl.generate(jwl.WorkloadSpec(**kw), seed=5)
    assert [e.fields() for e in got] == [e.fields() for e in want]
    assert twl.trace_bytes(got) == jwl.trace_bytes(want)
    assert twl.realized_rate(got, twl.WorkloadSpec(**kw)) == \
        jwl.realized_rate(want, jwl.WorkloadSpec(**kw))
    assert {k: len(v) for k, v in twl.by_class(got).items()} == \
        {k: len(v) for k, v in jwl.by_class(want).items()}


def _prompt(p):
    return [(s.kind, s.doc_id, s.tokens.tolist()) for s in p.segments]


@pytest.mark.parametrize("max_history", [None, 40])
def test_session_prompts_match_jax(max_history):
    rng = np.random.default_rng(2)
    sys_toks = rng.integers(0, 90, 16)
    got, want = (cls(session_id=3, system_tokens=sys_toks, max_history=max_history)
                 for cls in (Session, JaxSession))
    for turn in range(4):
        q = rng.integers(0, 90, 5)
        docs = [rng.integers(0, 90, 32) for _ in range(turn % 3)]
        ids = list(range(turn, turn + len(docs)))
        assert _prompt(got.prompt(q, docs, ids)) == _prompt(want.prompt(q, docs, ids))
        answer = rng.integers(0, 90, 6)
        got.commit(q, answer)
        want.commit(q, answer)
        assert np.array_equal(got.history, want.history) and got.turns == want.turns


def test_component_cost_models_match_jax():
    feats = {"tokens_in": 180.0, "tokens_out": 40.0, "k_docs": 150.0,
             "docs_tokens": 3000.0, "complexity": 0.4}
    for name in ("Retriever", "Generator", "Grader", "Rewriter", "Critic", "Reranker",
                 "GraphExpander", "QueryClassifier", "Augmenter", "VLLM"):
        got, want = getattr(tcomp, name)(), getattr(jcomp, name)()
        assert got.estimate_time(feats) == want.estimate_time(feats), name
        assert got.output_features(feats) == want.output_features(feats), name
    got, want = tcomp.Generator(tp_degree=4), jcomp.Generator(tp_degree=4)
    assert got.estimate_ttft(feats, hit_rate=0.3) == want.estimate_ttft(feats, hit_rate=0.3)
    assert got.tp_speedup() == want.tp_speedup()
    assert np.array_equal(tcomp._embed_query("q", 64), jcomp._embed_query("q", 64))


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, tree, tcfg, params_from_numpy(tcfg, tree, "cpu")


ENGINE_KW = dict(max_batch=4, max_seq=256, prefill_chunk_size=32, token_budget=64,
                 scheduler="edf_slack")


def _drive(eng, apps_mod, wl, session_fraction):
    """The fast case of benchmarks/slo_violations.py: vrag + crag at 10
    requests/s for 1 trace-second."""
    classes = [c for c in wl.DEFAULT_CLASSES if c.name in ("vrag", "crag")]
    apps = {c.name: apps_mod.make_app(c.name, engine=eng) for c in classes}
    spec = wl.WorkloadSpec(rate_rps=10.0, duration_s=1.0, classes=tuple(classes),
                           session_fraction=session_fraction, think_time_s=0.3)
    reqs = []
    submit = eng.submit

    def recording_submit(*a, **kw):
        reqs.append(submit(*a, **kw))
        return reqs[-1]

    eng.submit = recording_submit
    drv = apps_mod.OpenLoopDriver(eng, apps, wl.generate(spec, seed=1),
                                  clock=apps_mod.VirtualClock(dt=0.02), seed=1)
    drv.run()
    return drv, reqs


@pytest.mark.parametrize("session_fraction", [0.0, 0.3])
def test_open_loop_driver_matches_jax(weights, session_fraction):
    jcfg, tree, tcfg, tparams = weights
    jeng = JaxEngine(jcfg, params=jax.tree.map(jax.numpy.asarray, tree), kernel="pallas",
                     **ENGINE_KW)
    teng = GenerationEngine(tcfg, params=tparams, device="cpu", **ENGINE_KW)
    jdrv, jreqs = _drive(jeng, japps, jwl, session_fraction)
    tdrv, treqs = _drive(teng, tapps, twl, session_fraction)
    assert len(tdrv.records) == len(jdrv.records) > 0
    assert tdrv.records == jdrv.records
    assert len(treqs) == len(jreqs) > len(tdrv.records)
    for a, b in zip(jreqs, treqs):
        assert b.out_tokens == a.out_tokens and b.priority == a.priority, a.req_id
    assert tdrv.violation_summary() == jdrv.violation_summary()
    assert teng.steps == jeng.steps
    tst, jst = teng.stats(), jeng.stats()
    assert tst["prefix_hit_tokens"] == jst["prefix_hit_tokens"] > 0
    assert tst["session_shared_tokens"] == jst["session_shared_tokens"]
    if session_fraction:
        assert tst["session_shared_tokens"] > 0
    pool = teng.kv.pool
    assert pool.n_free == pool.n_blocks - 1
