"""The port's engine against the JAX engine on the invariant-harness
workloads (tests/test_engine_invariants.py): seeded bursts of fresh and
shared-prefix prompts, with a full pool and with a tiny pool that forces
backpressure and recompute preemption. Same weights through the bridge,
greedy sampling. The JAX engine runs ``kernel="pallas"`` in interpret mode,
the port's engine runs on the CPU. Both must build identical StepPlan
sequences, emit identical tokens and drain the pool clean; the port's
pipelined and sync modes must agree."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_params as jax_init_params
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import _NULL_SEQ, GenerationEngine
from repro_torch.serving.segments import assemble_prompt

torch.set_num_threads(1)

WORKLOADS = [(0, None), (2, 8)]   # (seed, n_blocks): full pool, tiny pool


def _capture_plans(eng):
    plans = []
    orig = eng.control.build_plan

    def wrapped():
        p = orig()
        if p is not None:
            plans.append(p)
        return p

    eng.control.build_plan = wrapped
    return plans


def _run(make_engine, seed, n_blocks, pipeline=True):
    """The harness's bursty workload (_run_workload), greedy."""
    rng = np.random.default_rng(seed)
    eng = make_engine(max_batch=3, max_seq=96, n_blocks=n_blocks,
                      prefill_chunk_size=16, token_budget=20, scheduler="fifo",
                      interleave=True, preempt="recompute", pipeline=pipeline)
    plans = _capture_plans(eng)
    ctx = rng.integers(0, 90, size=32).astype(np.int32)
    reqs = []
    for _ in range(4):
        for _ in range(int(rng.integers(1, 4))):
            if rng.random() < 0.4:
                tail = rng.integers(0, 90, size=int(rng.integers(1, 12)))
                prompt = np.concatenate([ctx, tail])
            else:
                prompt = rng.integers(0, 90, size=int(rng.integers(3, 45)))
            max_new = int(rng.integers(2, 9))
            reqs.append(eng.submit(prompt, max_new=max_new, temperature=0.0,
                                   priority=float(rng.random())))
        for _ in range(int(rng.integers(0, 4))):
            eng.step()
    eng.run_until_done(max_steps=2000)
    return eng, reqs, plans


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, tree, tcfg, params_from_numpy(tcfg, tree, "cpu")


@pytest.fixture(scope="module")
def runs(weights):
    jcfg, tree, tcfg, tparams = weights
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    out = {}
    for seed, nb in WORKLOADS:
        jax_run = _run(lambda **kw: JaxEngine(jcfg, params=jparams, kernel="pallas",
                                              **kw), seed, nb)
        tor_run = _run(lambda **kw: GenerationEngine(tcfg, params=tparams,
                                                     device="cpu", **kw), seed, nb)
        out[(seed, nb)] = (jax_run, tor_run)
    return out


_FIELDS = ("tokens", "starts", "temps", "tables", "prev_slots", "n_valid",
           "positions", "p_end", "s_start", "row_of", "slots", "decode_idx",
           "last_idx")


@pytest.mark.parametrize("seed,n_blocks", WORKLOADS)
def test_engine_plans_and_tokens_match_jax(runs, seed, n_blocks):
    (jeng, jreqs, jplans), (teng, treqs, tplans) = runs[(seed, n_blocks)]
    assert len(tplans) == len(jplans) > 0
    for jp, tp in zip(jplans, tplans):
        assert (tp.plan_id, tp.kind, tp.n_tokens) == (jp.plan_id, jp.kind, jp.n_tokens)
        for name in _FIELDS:
            a, b = getattr(jp, name), getattr(tp, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=f"plan {jp.plan_id} {name}")
        assert [(r.req_id, row, fin) for r, row, fin in tp.emit_rows] == \
            [(r.req_id, row, fin) for r, row, fin in jp.emit_rows]
    assert {p.kind for p in tplans} == {"ragged", "decode"}
    for a, b in zip(jreqs, treqs):
        assert b.out_tokens == a.out_tokens, (a.req_id, a.out_tokens, b.out_tokens)
    assert teng.preemptions == jeng.preemptions
    assert teng.stats()["prefix_hit_tokens"] == jeng.stats()["prefix_hit_tokens"]
    if n_blocks is not None:
        assert teng.steps == jeng.steps


@pytest.mark.parametrize("seed,n_blocks", WORKLOADS)
def test_engine_drains_clean(runs, seed, n_blocks):
    _, (eng, reqs, _) = runs[(seed, n_blocks)]
    assert all(r.done for r in reqs)
    assert not eng.waiting and not any(eng.slots)
    pool = eng.kv.pool
    assert pool.n_free == pool.n_blocks - 1
    assert pool.tables == {_NULL_SEQ: [eng._null_block]}
    assert pool.refcounts == {eng._null_block: 1}
    assert eng.kv.lengths == {}
    for r in reqs:
        assert len(r.out_tokens) == r.max_new
        assert r.stream.closed and r.delivered == r.out_tokens
    assert eng.stats()["kernel"] == "plain"


@pytest.mark.parametrize("seed,n_blocks", WORKLOADS)
def test_pipelined_matches_sync(runs, weights, seed, n_blocks):
    _, (_, pip_reqs, _) = runs[(seed, n_blocks)]
    tcfg, tparams = weights[2], weights[3]
    sync_eng, sync_reqs, _ = _run(
        lambda **kw: GenerationEngine(tcfg, params=tparams, device="cpu", **kw),
        seed, n_blocks, pipeline=False)
    assert not sync_eng.pipeline
    for a, b in zip(sync_reqs, pip_reqs):
        assert a.out_tokens == b.out_tokens


def test_segmented_prompts_share_documents(weights):
    """Two RAG requests with the same documents in swapped order: the second
    reuses the first's document blocks, and its tokens equal a run without
    prefix sharing (segment KV is order-independent)."""
    tcfg, tparams = weights[2], weights[3]
    rng = np.random.default_rng(9)
    sysp = rng.integers(0, 90, 16)   # block-aligned segments share by key
    docs = [rng.integers(0, 90, 48), rng.integers(0, 90, 32)]
    q = rng.integers(0, 90, 5)
    prompts = [assemble_prompt(q, docs, [0, 1], sysp),
               assemble_prompt(q, docs[::-1], [1, 0], sysp)]

    def serve(sharing):
        eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2,
                               max_seq=128, prefix_sharing=sharing)
        first = eng.submit(prompts[0], max_new=4)
        eng.run_until_done()
        second = eng.submit(prompts[1], max_new=4)
        eng.run_until_done()
        return eng, first, second

    eng, a, b = serve(True)
    _, a0, b0 = serve(False)
    assert b.shared_prefix_tokens > 0
    assert (a.out_tokens, b.out_tokens) == (a0.out_tokens, b0.out_tokens)
    assert eng.warmup_step_variants() > 0
    assert eng.kv.pool.n_free == eng.kv.pool.n_blocks - 1
