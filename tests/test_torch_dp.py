"""DP replicas over one pool on one device (``DataParallelEngineGroup``),
held against the JAX package on the CPU.

* ``sharded_pool.block_range`` equals JAX's over a grid, its ``ValueError``
  included; a ``PagedKVCache`` restricted to a block range admits, refuses
  and fills exactly as JAX's does, and a cache built on a shared quantized
  box is an int8 cache.
* The group's greedy tokens equal a lone port engine's and the JAX group's
  on the shared-document RAG burst of ``tests/test_sharded_pool.py``, float
  and int8 pools, ``kernel="pallas"`` on both sides (JAX in interpret mode);
  block ownership stays disjoint, and the pool box and the params tree are
  shared.
* ``tests/test_host_tier.py``'s cross-replica workload: a document prefilled
  on replica 0 is a host hit on replica 1, with JAX's ``cross_replica_host_
  hits``, ``host_hit_tokens`` and tokens; swap sets are namespaced per
  replica (two replicas' same-numbered requests swap at once); and a
  sanitized group drains clean.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_params as jax_init_params
from repro.serving.engine import DataParallelEngineGroup as JaxGroup
from repro.serving.paged_cache import PagedKVCache as JaxCache
from repro.serving.segments import assemble_prompt as jax_assemble
from repro.serving.sharded_pool import block_range as jax_block_range
from repro_torch.analysis import KVSanitizer
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import DataParallelEngineGroup, GenerationEngine
from repro_torch.serving.paged_cache import PagedKVCache, PoolArrays
from repro_torch.serving.segments import assemble_prompt
from repro_torch.serving.sharded_pool import block_range

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


# -------------------------------------------------------------- block ranges
def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


def test_block_range_matches_jax_over_a_grid():
    cases = [(n, dp, rank) for n in (1, 2, 7, 10, 16, 33) for dp in (1, 2, 3, 5)
             for rank in (-1, 0, 1, dp - 1, dp)]
    got = [_outcome(block_range, *c) for c in cases]
    assert got == [_outcome(jax_block_range, *c) for c in cases]
    assert sum(isinstance(g, tuple) and g[0] == "ValueError" for g in got) > 0
    spans = [block_range(10, 3, r) for r in range(3)]
    assert spans == [(0, 3), (3, 6), (6, 10)]       # the remainder to the last


def test_block_range_cache_admits_as_jax():
    jcfg, tcfg = jax_smoke(jax_get_arch("smollm-135m")), smoke_variant(get_arch("smollm-135m"))
    sides = []
    for make in (lambda **kw: JaxCache(jcfg, **kw),
                 lambda **kw: PagedKVCache(tcfg, device="cpu", **kw)):
        kv = make(n_blocks=16, block_size=4, block_range=(8, 12))
        out = [kv.pool.n_owned, kv.pool.n_free]
        out.append(kv.admit_tokens(1, np.arange(8)) is not None)   # 2 blocks + 1 slack
        out.append(list(kv.pool.tables[1]))
        out.append(kv.admit_tokens(2, np.arange(8)) is None)       # range exhausted
        out.append(round(kv.utilization(), 6))
        kv.release(1)
        out.append(kv.admit_tokens(3, np.arange(12)) is not None)  # 3 blocks + 1 slack
        out.append(list(kv.pool.tables[3]))
        out.append(_outcome(lambda: make(n_blocks=16, block_size=4, block_range=(12, 20))))
        sides.append(out)
    jax_side, port = sides
    assert port[:-1] == jax_side[:-1]
    assert port[-1][0] == jax_side[-1][0] == "ValueError"
    assert all(8 <= b < 12 for b in port[3] + port[7])


def test_cache_on_a_shared_quantized_box_is_int8():
    cfg = smoke_variant(get_arch("smollm-135m"))
    a = PagedKVCache(cfg, 16, 4, 4, device="cpu", block_range=(0, 8), kv_dtype="int8")
    b = PagedKVCache(cfg, 16, 4, 4, block_range=(8, 16), arrays=a._arrays)
    assert isinstance(a._arrays, PoolArrays) and b._arrays is a._arrays
    assert b.kv_dtype == "int8" and b.quantized and b.device.type == "cpu"
    assert set(a.pool.free_list).isdisjoint(b.pool.free_list)
    b.k[0, 9] = 3                               # one box: a sees b's write
    assert int(a.k[0, 9].max()) == 3


# ------------------------------------------------------------------- groups
def _rag_prompts(vocab, assemble, n=6, seed=0):
    """``tests/test_sharded_pool.py``'s shared-document RAG burst."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, 24) for _ in range(4)]
    sys_toks = np.arange(16) % vocab
    prompts = []
    for _ in range(n):
        order = rng.permutation(4)[:2]
        prompts.append(assemble(rng.integers(0, vocab, 7), [docs[j] for j in order],
                                doc_ids=[int(j) for j in order], system_tokens=sys_toks))
    return prompts


def _owned(eng):
    pool = eng.kv.pool
    return set(pool.free_list) | set(pool.refcounts) | set(pool.cached)


@pytest.fixture(scope="module", params=[None, "int8"], ids=["float", "int8"])
def group_runs(request, weights):
    jcfg, jparams, tcfg, tparams = weights
    kv_dtype = request.param
    kw = dict(max_batch=3, max_seq=128, seed=0, kernel="pallas", kv_dtype=kv_dtype)
    lone = GenerationEngine(tcfg, params=tparams, device="cpu", **kw)
    lone_reqs = [lone.submit(p, max_new=8) for p in _rag_prompts(tcfg.vocab_size,
                                                                  assemble_prompt)]
    lone.run_until_done()
    grp = DataParallelEngineGroup(tcfg, dp=2, params=tparams, device="cpu", **kw)
    reqs = [grp.submit(p, max_new=8) for p in _rag_prompts(tcfg.vocab_size, assemble_prompt)]
    grp.run_until_done()
    jgrp = JaxGroup(jcfg, dp=2, **kw)
    for e in jgrp.engines:
        e.params = jparams
    jreqs = [jgrp.submit(p, max_new=8) for p in _rag_prompts(jcfg.vocab_size, jax_assemble)]
    jgrp.run_until_done()
    return kv_dtype, (lone, lone_reqs), (grp, reqs), (jgrp, jreqs)


def test_group_tokens_equal_the_lone_engine_and_the_jax_group(group_runs):
    _, (_, lone_reqs), (grp, reqs), (jgrp, jreqs) = group_runs
    tokens = [r.out_tokens for r in reqs]
    assert all(len(t) == 8 for t in tokens)
    assert tokens == [r.out_tokens for r in lone_reqs]
    assert tokens == [r.out_tokens for r in jreqs]
    st, jst = grp.stats(), jgrp.stats()
    for key in ("dp_degree", "tokens_out", "prefill_tokens", "preemptions", "host_hit_tokens"):
        assert st[key] == jst[key], key
    assert [s["prefix_hit_tokens"] for s in st["replicas"]] == \
        [s["prefix_hit_tokens"] for s in jst["replicas"]]
    assert all(s["tokens_out"] > 0 for s in st["replicas"])     # both replicas served


def test_group_ownership_disjoint_and_box_shared(group_runs):
    kv_dtype, _, (grp, _), (jgrp, _) = group_runs
    e0, e1 = grp.engines
    assert e0.kv._arrays is e1.kv._arrays                          # one shared pool box
    assert all(e0.params[k] is e1.params[k] for k in e0.params)    # one params tree
    assert not _owned(e0) & _owned(e1)                             # disjoint block ranges
    assert [sorted(_owned(e)) for e in grp.engines] == [sorted(_owned(e)) for e in jgrp.engines]
    assert e0._null_block != e1._null_block
    assert e0._null_block in _owned(e0) and e1._null_block in _owned(e1)
    assert e0.kv.kv_dtype == e1.kv_dtype == kv_dtype
    assert e0.flusher is e1.flusher is grp.flusher
    for e in grp.engines:                                          # drained to its scratch
        assert e.kv.pool.n_free == e.kv.pool.n_owned - 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_cross_replica_host_hits_match_jax(weights, kv_dtype):
    """``tests/test_host_tier.py::test_cross_replica_host_hits_in_dp_group``:
    a document prefilled on replica 0 is a host hit on replica 1 through the
    shared write-through store, with JAX's counters and tokens."""
    jcfg, jparams, tcfg, tparams = weights
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 300, 32) for _ in range(3)]
    out = []
    for jax_side in (True, False):
        assemble = jax_assemble if jax_side else assemble_prompt

        def prompt(order, q):
            return assemble(q, [docs[j] for j in order], doc_ids=list(order),
                            system_tokens=np.arange(16))

        kw = dict(max_batch=2, max_seq=192, host_blocks=64, kernel="pallas",
                  kv_dtype=kv_dtype)
        if jax_side:
            grp = JaxGroup(jcfg, dp=2, **kw)
            for e in grp.engines:
                e.params = jparams
        else:
            grp = DataParallelEngineGroup(tcfg, dp=2, params=tparams, device="cpu", **kw)
        p0, p1 = prompt([0, 1, 2], np.arange(8)), prompt([2, 0, 1], np.arange(8) + 50)
        r0 = grp.engines[0].submit(p0, max_new=3)
        grp.run_until_done()
        r1 = grp.engines[1].submit(p1, max_new=3)
        grp.run_until_done()
        st = grp.stats()
        out.append(dict(tokens=(r0.out_tokens, r1.out_tokens),
                        r1=(r1.host_prefix_tokens, r1.shared_prefix_tokens),
                        cross=st["cross_replica_host_hits"], hits=st["host_hit_tokens"],
                        host={k: v for k, v in st["host_store"].items()}))
    jax_side, port = out
    assert port == jax_side
    assert port["r1"][0] > 0 and port["r1"][1] == 0
    assert port["cross"] > 0 and port["hits"] == port["r1"][0]
    lone = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2, max_seq=192,
                            kernel="pallas", kv_dtype=kv_dtype)
    want = []
    for order, q in (([0, 1, 2], np.arange(8)), ([2, 0, 1], np.arange(8) + 50)):
        r = lone.submit(assemble_prompt(q, [docs[j] for j in order], doc_ids=list(order),
                                        system_tokens=np.arange(16)), max_new=3)
        lone.run_until_done()
        want.append(r.out_tokens)
    assert list(port["tokens"]) == want


def test_swap_tags_namespaced_across_replicas(weights):
    """``tests/test_host_tier.py::test_swap_tags_namespaced_across_dp_replicas``:
    replicas number requests independently but share one host store, so
    swap sets are namespaced by replica; concurrent swap-outs of
    same-numbered requests do not collide, and the tokens and swap counts
    are JAX's."""
    jcfg, jparams, tcfg, tparams = weights
    out = []
    for jax_side in (True, False):
        kw = dict(max_batch=2, max_seq=64, n_blocks_per_replica=8, preempt="swap",
                  prefix_sharing=False, kernel="pallas")
        if jax_side:
            grp = JaxGroup(jcfg, dp=2, **kw)
            for e in grp.engines:
                e.params = jparams
        else:
            grp = DataParallelEngineGroup(tcfg, dp=2, params=tparams, device="cpu", **kw)
        e0, e1 = grp.engines
        reqs = []
        for eng, off in ((e0, 0), (e1, 1)):
            reqs += [eng.submit(np.arange(30) % 90 + off + 3 * i, max_new=24) for i in range(2)]
        r0, r1 = reqs[0], reqs[2]
        assert r0.req_id == r1.req_id                      # the collision setup
        assert e0._swap_tag(r0) != e1._swap_tag(r1)
        grp.run_until_done(max_steps=2000)
        assert all(r.done for r in reqs)
        assert grp.host_store.n_swapped == 0
        out.append(([r.out_tokens for r in reqs], [e.swap_outs for e in grp.engines],
                    [e.swap_ins for e in grp.engines]))
    assert out[1] == out[0]
    assert sum(out[1][1]) >= 1


def test_sanitized_group_drains_clean(weights):
    """One sanitizer spans the group (pools, shared store, copy engines):
    the swap workload above under the shadow, no violation, and the shadow
    equal to both replicas' pools and the store at the drain."""
    _, _, tcfg, tparams = weights
    grp = DataParallelEngineGroup(tcfg, dp=2, params=tparams, device="cpu", max_batch=2,
                                  max_seq=64, n_blocks_per_replica=8, preempt="swap",
                                  prefix_sharing=False, sanitize=True)
    san = grp.sanitizer
    assert isinstance(san, KVSanitizer)
    assert all(e.sanitizer is san and e.kv.pool.sanitizer is san and e._copy.sanitizer is san
               for e in grp.engines)
    assert grp.host_store.sanitizer is san
    reqs = [eng.submit(np.arange(30) % 90 + off + 3 * i, max_new=24)
            for eng, off in zip(grp.engines, (0, 1)) for i in range(2)]
    grp.run_until_done(max_steps=2000)
    assert all(r.done for r in reqs)
    assert sum(e.swap_outs for e in grp.engines) >= 1
    assert san.violations == 0 and san.op_counts.get("host_restore", 0) > 0
    shadow = san.stats()
    assert shadow["device_allocated"] == 2                 # each replica's scratch block
    assert shadow["device_warm"] == sum(len(e.kv.pool.cached) for e in grp.engines)
    assert shadow["copy_pending"] == 0 and shadow["host_pinned"] == 0
    san.audit_host(grp.host_store)
