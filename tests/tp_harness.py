"""Rank jobs of ``tests/test_torch_tp.py`` (not collected; imports no JAX,
since every spawned rank imports this module): each runs on one rank of a
gloo group through ``repro_torch.launch.mesh.run_on_ranks``."""
import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.segments import assemble_prompt
from repro_torch.serving.sharded_pool import ShardedPoolLayout


def tp_config(arch, **over):
    return smoke_variant(get_arch(arch)).replace(**over)


def rag_prompts(vocab, assemble, n=5):
    """``tests/test_sharded_pool.py``'s shared-document RAG burst (its
    subprocess's ``prompts()``), with the given ``assemble_prompt``."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, vocab, 24) for _ in range(4)]
    r = np.random.default_rng(1)
    out = []
    for _ in range(n):
        order = r.permutation(4)[:2]
        out.append(assemble(r.integers(0, vocab, 7), [docs[j] for j in order],
                            doc_ids=[int(j) for j in order],
                            system_tokens=np.arange(16) % vocab))
    return out


def serve_job(rank, mesh, device, arch, over, tree, max_new):
    """The sharded engine on this rank's shard of the numpy weights
    ``tree``: greedy tokens on the RAG burst, hit rate, each step program's
    census, the step audit, the pool shard's shape, and the refusals."""
    from repro_torch.analysis.step_audit import audit_engine

    cfg = tp_config(arch, **over)
    layout = ShardedPoolLayout(mesh)
    params = params_from_numpy(cfg, tree, device)
    eng = GenerationEngine(cfg, params=params, max_batch=3, max_seq=128, seed=0,
                           pool_layout=layout, kernel="reference", device=device)
    reqs = [eng.submit(p, max_new=max_new) for p in rag_prompts(cfg.vocab_size, assemble_prompt)]
    eng.run_until_done()
    census = {w: eng.audit_collectives(w) for w in ("fused", "decode", "pool")}
    report = audit_engine(eng, warm=False)
    refusals = {}
    for name, kw in (("pallas", {"kernel": "pallas"}),
                     ("int8", {"kernel": "reference", "kv_dtype": "int8"})):
        try:
            GenerationEngine(cfg, max_batch=3, max_seq=128, pool_layout=layout, device=device,
                             **kw)
            refusals[name] = None
        except ValueError as e:
            refusals[name] = str(e)
    return {"tokens": [r.out_tokens for r in reqs], "hit_rate": eng.measured_hit_rate(),
            "census": census, "audit_ok": report.ok, "audit": report.render(),
            "pool_shape": tuple(eng.kv.k.shape), "stats_tp": eng.stats()["tp_degree"],
            "refusals": refusals, "step_cfg_heads": (eng._step_cfg.num_heads,
                                                     eng._step_cfg.num_kv_heads)}


def block_job(rank, mesh, device, x, w_in, w_out):
    """The explicit TP block (``make_tp_block``) and the DTensor block on
    this rank, each with its collective census."""
    from repro_torch.models.shardmap_tp import count_collectives, make_tp_block, \
        shard_tp_weights, tp_block_dtensor

    x, w_in, w_out = (torch.from_numpy(a) for a in (x, w_in, w_out))
    wi, wo = shard_tp_weights(mesh, w_in, w_out)
    block = make_tp_block(mesh)
    out = block(x, wi, wo)
    census = count_collectives(block, (x, wi, wo))
    dblock = tp_block_dtensor(mesh)
    dout = dblock(x, w_in, w_out)
    dcensus = count_collectives(dblock, (x, w_in, w_out))
    return {"out": out.numpy(), "census": census, "dtensor_out": dout.numpy(),
            "dtensor_census": dcensus}


def serve_and_block_job(rank, mesh, device, serve_args, block_args):
    """``serve_job`` then ``block_job`` on the same ranks (one spawn)."""
    return {"serve": serve_job(rank, mesh, device, *serve_args),
            "block": block_job(rank, mesh, device, *block_args)}
