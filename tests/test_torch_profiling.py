"""The port's startup profiling (``core/profiling.py``) against the JAX
package on the CPU, and its calibration against the port's paged engine.

* The estimate branch of ``profile_components`` (the cost models, cold
  cache) gives the same ``alpha``, ``mean_service_s`` and baked hit rates
  as JAX on the six apps; ``generator_alpha_scale``,
  ``fit_tp_comm_fraction``, ``estimate_gamma`` and ``profile_routing`` are
  equal too.
* ``calibrate_generator_from_engine`` on the port's smoke engine
  (``device="cpu"``, float32 and int8 pools) gives positive coefficients
  and a long decode that costs more than a short one
  (``tests/test_paged_engine.py``), and its ``kv_bytes_per_token`` and
  ``baseline_kv_bytes_per_token`` equal what JAX's
  ``engine_kv_bytes_per_token`` and formula give for the same smoke config.
* The real-execution branch of ``profile_components`` drives the engine.
* The engine ``Request``'s ``host_hit_rate`` and ``session_hit_rate``
  equal the JAX engine's, request for request, on a host-tier workload
  with document demotions and session-history promotions.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps as japps
import repro.core.components as jcomp
import repro.core.graph as jgraph
import repro.core.profiling as jprof
import repro_torch.apps as tapps
import repro_torch.core.components as tcomp
import repro_torch.core.graph as tgraph
import repro_torch.core.profiling as tprof
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


def _profiled(mod, name, **kw):
    app = mod.make_app(name)
    random.seed(0)          # WebSearch draws its jitter from Python's random
    (jprof if mod is japps else tprof).profile_components(app.components, **kw)
    return {c: (m.meta.alpha, m.meta.mean_service_s, m.meta.alpha_hit_rate,
                m.meta.alpha_host_hit_rate) for c, m in app.components.items()}


@pytest.mark.parametrize("name", APP_NAMES)
def test_profile_components_estimate_matches_jax(name):
    for kw in ({}, {"n_samples": 17, "seed": 5}):
        got, want = _profiled(tapps, name, **kw), _profiled(japps, name, **kw)
        assert got == want
        assert all(next(iter(a.values())) > 0 and t > 0 for a, t, _, _ in got.values())
        # Generators are fitted cold; the other stages bake no hit rate
        for comp, (_, _, h, hh) in got.items():
            gen = isinstance(tapps.make_app(name).components[comp], tcomp.Generator)
            assert (h, hh) == ((0.0, 0.0) if gen else (None, None)), comp


@pytest.mark.parametrize("cls", ["Generator", "Grader", "Rewriter", "Critic"])
def test_generator_alpha_scale_matches_jax(cls):
    tg, jg = getattr(tcomp, cls)(), getattr(jcomp, cls)()
    coeffs = {"prefill_per_token_s": 1.1e-4, "decode_per_token_s": 0.027,
              "decode_cache_per_ctx_token_s": 1e-9, "host_hit_rate": 0.1,
              "prefix_hit_rate": 0.3}
    feats = {"tokens_in": 90.0, "docs_tokens": 20000.0, "tokens_out": 120.0}
    for calibrated in (False, True):
        if calibrated:
            tg.calibrate(coeffs)
            jg.calibrate(coeffs)
        for kw in ({}, {"features": feats},
                   {"hit_rate": 0.6, "host_hit_rate": 0.2},
                   {"hit_rate": 0.2, "baseline_hit_rate": 0.5, "host_hit_rate": 0.0,
                    "baseline_host_hit_rate": 0.3, "features": feats},
                   {"hit_rate": 1.0, "host_hit_rate": 0.5}):
            assert tprof.generator_alpha_scale(tg, **kw) == jprof.generator_alpha_scale(jg, **kw)


def test_fit_tp_comm_fraction_matches_jax():
    for t in (0, 1, 2, 3, 4, 8):
        for s in (0.0, 0.5, 1.0, 1.7, 2.0, 3.9, 8.0, 12.0):
            got = tprof.fit_tp_comm_fraction(t, s)
            assert got == jprof.fit_tp_comm_fraction(t, s)
            assert 0.0 <= got <= 1.0


def test_gamma_and_routing_from_traces_match_jax():
    rng = np.random.default_rng(3)
    comps = ["A", "B", "C", "D"]
    traces = []
    for _ in range(50):
        tr = ["A"]
        while rng.random() < 0.4 and len(tr) < 8:
            tr += ["B", "C"] if rng.random() < 0.5 else ["D"]
        traces.append(tr + ["B"])
    assert tprof.estimate_gamma(traces) == jprof.estimate_gamma(traces)
    assert tprof.estimate_gamma([]) == jprof.estimate_gamma([]) == {}
    graphs = []
    for gmod, pmod in ((jgraph, jprof), (tgraph, tprof)):
        g = gmod.WorkflowGraph("t")
        g.add_edge(gmod.SOURCE, "A")
        pmod.profile_routing(g, traces)
        graphs.append([(e.src, e.dst, e.prob, e.recursive, e.count) for e in g.edges])
    assert graphs[0] == graphs[1]
    assert any(rec for *_, rec, _ in graphs[1])


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_calibrate_against_the_port_engine(weights, kv_dtype):
    jcfg, jparams, tcfg, tparams = weights
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=1, max_seq=128,
                           kv_dtype=kv_dtype)
    gen = tcomp.Generator(engine=eng)
    coeffs = tprof.calibrate_generator_from_engine(gen, eng, tp_engine=eng)
    assert coeffs["prefill_per_token_s"] > 0
    assert coeffs["ttft_per_prefill_token_s"] > 0
    assert coeffs["decode_per_token_s"] > 0
    assert coeffs["decode_cache_per_ctx_token_s"] >= 0
    assert 0.0 <= coeffs["prefix_hit_rate"] <= 1.0
    # a single-device engine has no pool layout: tp degree 1 fits 0.0, as in JAX
    assert coeffs["tp_comm_fraction"] == 0.0
    for key, value in coeffs.items():
        assert getattr(gen, key) == value, key
    short = gen.estimate_time({"tokens_in": 100, "docs_tokens": 1000, "tokens_out": 16})
    long = gen.estimate_time({"tokens_in": 100, "docs_tokens": 1000, "tokens_out": 64})
    assert long > short

    # pool bytes: the port's live pools against JAX's on the same smoke config
    jeng = JaxEngine(jcfg, params=jparams, max_batch=1, max_seq=128, kv_dtype=kv_dtype)
    want = jprof.engine_kv_bytes_per_token(jeng)
    baseline = float(2 * jcfg.num_layers * jcfg.num_kv_heads * jcfg.head_dim
                     * jnp.dtype(jcfg.dtype).itemsize)
    assert tprof.engine_kv_bytes_per_token(eng) == want == coeffs["kv_bytes_per_token"]
    assert coeffs["baseline_kv_bytes_per_token"] == baseline
    L, KVH, hd, bs = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim, eng.kv.k.shape[2]
    if kv_dtype == "int8":
        assert want == 2.0 * L * KVH * hd + 2.0 * L * KVH * 4.0 / bs
        assert gen.kv_capacity_scale() == baseline / want > 1.9
    else:
        assert want == baseline
        assert gen.kv_capacity_scale() == 1.0


def test_dense_engines_report_no_pool_bytes(weights):
    jcfg, jparams, tcfg, tparams = weights
    teng = GenerationEngine(tcfg, params=tparams, device="cpu", backend="dense",
                            max_batch=1, max_seq=64)
    jeng = JaxEngine(jcfg, params=jparams, backend="dense", max_batch=1, max_seq=64)
    assert tprof.engine_kv_bytes_per_token(teng) is None
    assert jprof.engine_kv_bytes_per_token(jeng) is None


def test_real_execution_profile_drives_the_engine(weights):
    _, _, tcfg, tparams = weights
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2, max_seq=128)
    app = tapps.make_app("vrag", engine=eng)
    gen = app.components["VGenerator"]
    tprof.profile_components({"VGenerator": gen}, n_samples=3, real_execution=True)
    meta = gen.meta
    assert meta.mean_service_s > 0
    assert meta.alpha == {"GPU": 1.0 / meta.mean_service_s}
    assert meta.alpha_hit_rate == gen.effective_hit_rate()
    assert meta.alpha_host_hit_rate == gen.effective_host_hit_rate()
    assert len(eng.finished) == 3 and all(r.out_tokens for r in eng.finished)


def _hit_rate_workload(eng, session_cls):
    """One three-turn session with filler requests between turns on a tiny
    pool (the warm LRU demotes the history, the next turn promotes it: the
    session class), then a document evicted and asked for again (a host hit
    of the document class). Returns every request in submission order."""
    rng = np.random.default_rng(0)
    sess = session_cls(session_id=0, system_tokens=rng.integers(0, 90, size=20))
    reqs = []
    for _ in range(3):
        q = rng.integers(0, 90, size=12).astype(np.int32)
        r = eng.submit(sess.prompt(q), max_new=6, temperature=0.0)
        reqs += [r] + [eng.submit(rng.integers(0, 90, size=40), max_new=2, temperature=0.0)
                       for _ in range(3)]
        eng.run_until_done(max_steps=2000)
        sess.commit(q, r.out_tokens)
    ctx = np.arange(64) % 90
    reqs.append(eng.submit(np.concatenate([ctx, [5]]), max_new=2))
    eng.run_until_done()
    for i in range(3):
        reqs.append(eng.submit(np.arange(40) % 90 + 100 + 17 * i, max_new=2))
        eng.run_until_done()
    reqs.append(eng.submit(np.concatenate([ctx, [6]]), max_new=3))
    eng.run_until_done()
    return reqs


def test_request_hit_rates_match_jax(weights):
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(max_batch=2, max_seq=160, n_blocks=10, host_blocks=64,
              prefill_chunk_size=16, token_budget=20)
    sides = []
    for eng, sess in ((JaxEngine(jcfg, params=jparams, kernel="pallas", **kw), JaxSession),
                      (GenerationEngine(tcfg, params=tparams, device="cpu", **kw), Session)):
        reqs = _hit_rate_workload(eng, sess)
        lat = eng.latency_summary()
        sides.append(([(r.out_tokens, r.prefix_hit_rate, r.host_hit_rate, r.session_hit_rate)
                       for r in reqs],
                      (lat["prefix_hit_rate"], lat["host_hit_rate"], lat["session_hit_rate"]),
                      (eng.measured_host_hit_rate(min_tokens=1),
                       eng.measured_session_hit_rate(min_tokens=1))))
    assert sides[1] == sides[0]
    per_req = sides[1][0]
    assert any(h > 0 for _, _, h, _ in per_req)        # document promotions
    assert any(s > 0 for _, _, _, s in per_req)        # session-history promotions
    assert all(p + h + s <= 1.0 for _, p, h, s in per_req)
