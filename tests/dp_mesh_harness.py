"""Rank jobs of ``tests/test_torch_dp_mesh.py`` (not collected; imports no
JAX, since every spawned rank imports this module): each runs on one rank
of a gloo group through ``repro_torch.launch.mesh.run_on_ranks``, on the
smoke variant of smollm-135m with the JAX weights as numpy."""
import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import DataParallelEngineGroup, GenerationEngine
from repro_torch.serving.segments import assemble_prompt
from repro_torch.serving.sharded_pool import ShardedPoolLayout

ARCH = "smollm-135m"
MAX_NEW = 8
GROUP = dict(max_batch=3, max_seq=128, seed=0, kernel="reference")


def config():
    return smoke_variant(get_arch(ARCH))


def rag_prompts(vocab, assemble, n=6, seed=0):
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


def cross_prompts(assemble):
    """``tests/test_host_tier.py``'s cross-replica workload: a document
    prefilled on replica 0, then the same documents reordered on replica 1."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 300, 32) for _ in range(3)]

    def prompt(order, q):
        return assemble(q, [docs[j] for j in order], doc_ids=list(order),
                        system_tokens=np.arange(16))

    return prompt([0, 1, 2], np.arange(8)), prompt([2, 0, 1], np.arange(8) + 50)


def owned(eng):
    pool = eng.kv.pool
    return sorted(set(pool.free_list) | set(pool.refcounts) | set(pool.cached))


def data_allreduce_mutant(eng):
    """The fused step with one all-reduce on the rank's "data" group: the
    step audit's data-axis contract must catch it."""
    import torch.distributed as dist

    fn = eng._ragged_step
    group = eng.pool_layout.dp_group

    def bad(*args):
        out = fn(*args)
        dist.all_reduce(torch.zeros((), device=eng.device), group=group)
        return out

    eng._ragged_step = bad


def group_run(cfg, params, layout, device, **kw):
    """The RAG burst through a group on ``layout``: tokens, routes,
    per-replica figures of the local engines, and the group's stats."""
    grp = DataParallelEngineGroup(cfg, dp=2, params=params, device=device,
                                  pool_layout=layout, **GROUP, **kw)
    reqs = [grp.submit(p, max_new=MAX_NEW) for p in rag_prompts(cfg.vocab_size,
                                                                 assemble_prompt)]
    grp.run_until_done()
    local = [e for e in grp.engines if not hasattr(e, "local") or e.local]
    return grp, {
        "tokens": [r.out_tokens for r in reqs], "routes": [grp.replica_of(r) for r in reqs],
        "stats": grp.stats(),
        "owned": {(e.kv.client_tag): owned(e) for e in local},
        "pool_blocks": {(e.kv.client_tag): tuple(e.kv.k.shape) for e in local},
        "null_block": {(e.kv.client_tag): e._null_block + e.kv.pool.base for e in local},
        "drained": all(e.kv.pool.n_free == e.kv.pool.n_owned - 1 for e in local),
    }


def mesh_job(rank, mesh, device, tree):
    """On a ("data", "model") mesh: the lone engine replicated over "data";
    the group of form (ii) with and without ``dp_blocks`` (RAG burst, the
    step programs' census by group, the audit and its data-axis mutant);
    the cross-replica host-tier workload; a sanitized swap group."""
    from repro_torch.analysis.step_audit import audit_engine

    cfg = config()
    params = params_from_numpy(cfg, tree, device)
    out = {"rank": rank}
    lone = GenerationEngine(cfg, params=params, device=device,
                            pool_layout=ShardedPoolLayout(mesh), **GROUP)
    reqs = [lone.submit(p, max_new=MAX_NEW) for p in rag_prompts(cfg.vocab_size,
                                                                  assemble_prompt)]
    lone.run_until_done()
    out["lone"] = {"tokens": [r.out_tokens for r in reqs],
                   "pool_shape": tuple(lone.kv.k.shape)}
    try:
        GenerationEngine(cfg, params=params, device=device,
                         pool_layout=ShardedPoolLayout(mesh, dp_blocks=True), **GROUP)
        out["lone_dp_blocks"] = None
    except ValueError as e:
        out["lone_dp_blocks"] = str(e)
    del lone

    for dp_blocks in (True, False):
        layout = ShardedPoolLayout(mesh, dp_blocks=dp_blocks)
        grp, res = group_run(cfg, params, layout, device)
        eng = grp.engine
        res["census"] = {w: eng.audit_collectives(w, by_group=True)
                         for w in ("fused", "decode", "pool")}
        report = audit_engine(eng, warm=False)
        res["audit_ok"], res["audit"] = report.ok, report.render()
        res["row"], res["tp_rank"] = layout.dp_rank, layout.tp_rank
        if dp_blocks:
            data_allreduce_mutant(eng)
            bad = audit_engine(eng, warm=False)
            res["mutant"] = [str(f) for f in bad.failures()]
            try:
                DataParallelEngineGroup(cfg, dp=3, params=params, device=device,
                                        pool_layout=layout, **GROUP)
                res["dp_mismatch"] = None
            except ValueError as e:
                res["dp_mismatch"] = str(e)
        out[f"group_dp_blocks_{dp_blocks}"] = res
        del grp

    grp = DataParallelEngineGroup(cfg, dp=2, params=params, device=device, max_batch=2,
                                  max_seq=192, host_blocks=64, kernel="reference",
                                  pool_layout=ShardedPoolLayout(mesh, dp_blocks=True))
    p0, p1 = cross_prompts(assemble_prompt)
    r0 = grp.engines[0].submit(p0, max_new=3)
    grp.run_until_done()
    r1 = grp.engines[1].submit(p1, max_new=3)
    grp.run_until_done()
    st = grp.stats()
    out["cross"] = dict(tokens=(r0.out_tokens, r1.out_tokens),
                        r1=(r1.host_prefix_tokens, r1.shared_prefix_tokens),
                        cross=st["cross_replica_host_hits"], hits=st["host_hit_tokens"],
                        host=dict(st["host_store"]), exchanges=list(grp.exchanges))
    del grp

    grp = DataParallelEngineGroup(cfg, dp=2, params=params, device=device, max_batch=2,
                                  max_seq=64, n_blocks_per_replica=8, preempt="swap",
                                  prefix_sharing=False, sanitize=True, kernel="reference",
                                  pool_layout=ShardedPoolLayout(mesh, dp_blocks=True))
    reqs = [grp.engines[d].submit(np.arange(30) % 90 + off + 3 * i, max_new=24)
            for d, off in ((0, 0), (1, 1)) for i in range(2)]
    grp.run_until_done(max_steps=2000)
    san = grp.sanitizer
    san.audit_host(grp.host_store)
    out["sanitized"] = {"tokens": [r.out_tokens for r in reqs], "done": all(r.done for r in reqs),
                        "violations": san.violations, "shadow": san.stats(),
                        "swap_outs": grp.engine.swap_outs,
                        "op_counts": dict(san.op_counts)}
    return out


def tp_group_job(rank, mesh, device, tree):
    """On a ("model",) mesh: the group of form (i), every replica on this
    rank's head shard of one box, with a write-through host tier."""
    cfg = config()
    params = params_from_numpy(cfg, tree, device)
    grp, res = group_run(cfg, params, ShardedPoolLayout(mesh), device, host_blocks=64)
    e0, e1 = grp.engines
    res["box_shared"] = e0.kv._arrays is e1.kv._arrays
    res["params_shared"] = all(e0.params[k] is e1.params[k] for k in e0.params)
    res["pool_shape"] = tuple(e0.kv.k.shape)
    res["host_shape"] = tuple(grp.host_store.k.shape)
    return res
