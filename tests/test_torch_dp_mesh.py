"""The data axis of a serving mesh (spawned gloo ranks on the CPU) held
against the JAX package.

* ``ShardedPoolLayout(dp_blocks=)`` and ``make_pool_layout(dp_blocks=)``
  against JAX's, the degenerate cases included; ``pool_shape`` against the
  shard that JAX's ``pool_pspecs(dp_blocks=, n_blocks=)`` spec gives on a
  (2, 2) grid of axis sizes, divisible and indivisible block counts; the
  dry run's ``--serve-shard`` pool bytes from ``pool_shape``.
* On (dp 2, tp 1) and (dp 2, tp 2) meshes of spawned ranks, smollm-135m's
  smoke variant on JAX's weights and ``tests/test_sharded_pool.py``'s RAG
  burst (``kernel="reference"`` on both sides):
  - the lone engine (replicated over "data") and the group of form (ii)
    (one replica a mesh row), ``dp_blocks`` true and false: every rank's
    tokens equal JAX's lone engine's and JAX's ``DataParallelEngineGroup(
    cfg, dp=2)``'s; routes, each replica's owned block set in global ids,
    its scratch block and the stats keys are JAX's; with ``dp_blocks`` each
    rank's pool holds only its block range;
  - the census by group: 2 x num_layers all-reduces of the Megatron
    formula's bytes on the "model" group, none on the "data" group, none in
    the pool roundtrip; the step audit holds, and a mutant that all-reduces
    once on the "data" group inside the fused step is a finding;
  - ``tests/test_torch_dp.py``'s cross-replica host-tier workload: JAX's
    tokens and counters (replica 0 finishes before replica 1's request
    arrives, so the rows' one-step exchange lag does not show);
  - a sanitized swap group drains clean on every rank, with JAX's tokens.
* Form (i) (a "model"-only layout, every replica on each TP rank): tokens,
  routes and ``cross_replica_host_hits`` equal JAX's group's.
"""
import types

import jax
import numpy as np
import pytest

import dp_mesh_harness as H
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import init_params as jax_init_params
from repro.models.sharding import pool_pspecs as jax_pool_pspecs
from repro.serving.engine import DataParallelEngineGroup as JaxGroup
from repro.serving.engine import GenerationEngine as JaxEngine
from repro.serving.segments import assemble_prompt as jax_assemble
from repro.serving.sharded_pool import ShardedPoolLayout as JaxLayout
from repro.serving.sharded_pool import make_pool_layout as jax_make_pool_layout
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import AbstractMesh, run_on_ranks
from repro_torch.models.shardmap_tp import megatron_collectives
from repro_torch.serving.sharded_pool import ShardedPoolLayout, make_pool_layout

MESHES = {"dp2_tp1": (1, 2), "dp2_tp2": (2, 2)}          # name: (tp, dp)


# ------------------------------------------------------------------ layouts
def _jax_mesh(sizes):
    """A stand-in with the two attributes JAX's layout reads, so that its
    properties can be held on meshes larger than this host's one device."""
    return types.SimpleNamespace(axis_names=tuple(sizes), devices=np.empty(tuple(sizes.values())))


@pytest.mark.parametrize("sizes", [{"model": 2}, {"data": 2, "model": 1},
                                   {"data": 2, "model": 2}, {"data": 1, "model": 1}])
@pytest.mark.parametrize("dp_blocks", [False, True])
def test_layout_properties_against_jax(sizes, dp_blocks):
    mine = ShardedPoolLayout(AbstractMesh(tuple(sizes), tuple(sizes.values())), dp_blocks)
    theirs = JaxLayout(_jax_mesh(sizes), dp_blocks=dp_blocks)
    assert (mine.axis_sizes, mine.tp_degree, mine.dp_degree, mine.dp_blocks) == \
        (theirs.axis_sizes, theirs.tp_degree, theirs.dp_degree, theirs.dp_blocks)


def test_make_pool_layout_against_jax():
    for kw in ({}, {"tp": 1}, {"tp": 1, "dp": 1}, {"tp": 1, "dp": 1, "dp_blocks": True},
               {"tp": None, "dp": 1, "dp_blocks": True}):
        assert make_pool_layout(**kw) is None and jax_make_pool_layout(**kw) is None, kw
    for dp_blocks in (False, True):
        jl = jax_make_pool_layout(mesh=make_mesh_compat((1, 1), ("data", "model")),
                                  dp_blocks=dp_blocks)
        ml = make_pool_layout(mesh=AbstractMesh(("data", "model"), (1, 1)), dp_blocks=dp_blocks)
        assert (ml.dp_blocks, ml.axis_sizes) == (jl.dp_blocks, jl.axis_sizes)
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_pool_layout(tp=2, dp=2, dp_blocks=True)        # no process group here


def _jax_shard(cfg, sizes, dp_blocks, n_blocks, bs=16):
    spec = jax_pool_pspecs(cfg, sizes, dp_blocks=dp_blocks, n_blocks=n_blocks)
    full = (cfg.num_layers, n_blocks, bs, cfg.num_kv_heads, cfg.head_dim)
    return tuple(d // (sizes.get(a, 1) if a else 1) for d, a in zip(full, spec))


@pytest.mark.parametrize("kvh", [2, 3])
@pytest.mark.parametrize("n_blocks", [10, 11, 56])
@pytest.mark.parametrize("dp_blocks", [False, True])
def test_pool_shape_against_jax_pool_pspecs(kvh, n_blocks, dp_blocks):
    from repro_torch.configs import get_arch, smoke_variant

    sizes = {"data": 2, "model": 2}
    jcfg = jax_smoke(jax_get_arch("smollm-135m")).replace(num_kv_heads=kvh, num_heads=2 * kvh)
    tcfg = smoke_variant(get_arch("smollm-135m")).replace(num_kv_heads=kvh, num_heads=2 * kvh)
    lay = ShardedPoolLayout(AbstractMesh(("data", "model"), (2, 2)), dp_blocks=dp_blocks)
    got = lay.pool_shape(tcfg, n_blocks, 16)
    assert got == _jax_shard(jcfg, sizes, dp_blocks, n_blocks)
    assert lay.splits_blocks(tcfg, n_blocks) == (dp_blocks and n_blocks % 2 == 0)


def test_dryrun_serve_shard_pool_bytes_from_pool_shape():
    from repro_torch.configs import SHAPES, get_arch

    r = D.dryrun("qwen2.5-3b", "decode_32k", verbose=False, serve_shard=True)
    p = r["pool"]
    cfg = get_arch("qwen2.5-3b").replace(dtype="bfloat16")
    shape = SHAPES["decode_32k"]
    rows = shape.global_batch // 16
    per = rows * (shape.seq_len // 16 + 1) + 1
    lay = ShardedPoolLayout(AbstractMesh(("data", "model"), (16, 16)), dp_blocks=True)
    local = lay.pool_shape(cfg, 16 * per, 16)
    assert p["modelled"] and p["n_blocks"] == 16 * per
    assert p["shape_per_rank"] == local == (cfg.num_layers, per, 16, cfg.num_kv_heads,
                                            cfg.head_dim)
    assert p["bytes_per_rank"] == 2 * int(np.prod(local)) * 2
    assert not D.dryrun("rwkv6-7b", "decode_32k", verbose=False,
                        serve_shard=True)["pool"]["modelled"]
    assert "pool" not in D.dryrun("smollm-135m", "train_4k", verbose=False, serve_shard=True)


# --------------------------------------------------------------- JAX side
def _owned(eng):
    pool = eng.kv.pool
    return sorted(set(pool.free_list) | set(pool.refcounts) | set(pool.cached))


def _jax_route(grp, req):
    return next(i for i, e in enumerate(grp.engines) if any(r is req for r in e.finished))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX lone engine and groups on the workloads the ranks run, and
    the weights as numpy."""
    cfg = jax_smoke(jax_get_arch(H.ARCH))
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    prompts = H.rag_prompts(cfg.vocab_size, jax_assemble)
    out = {"tree": jax.tree.map(np.asarray, params)}

    lone = JaxEngine(cfg, params=params, **H.GROUP)
    reqs = [lone.submit(p, max_new=H.MAX_NEW) for p in prompts]
    lone.run_until_done()
    out["lone"] = [r.out_tokens for r in reqs]

    for tag, kw in (("group", {}), ("group_host", {"host_blocks": 64})):
        grp = JaxGroup(cfg, dp=2, **H.GROUP, **kw)
        for e in grp.engines:
            e.params = params
        reqs = [grp.submit(p, max_new=H.MAX_NEW) for p in prompts]
        grp.run_until_done()
        st = grp.stats()
        out[tag] = {"tokens": [r.out_tokens for r in reqs],
                    "routes": [_jax_route(grp, r) for r in reqs], "stats": st,
                    "owned": [_owned(e) for e in grp.engines],
                    "null_block": [e._null_block for e in grp.engines]}

    grp = JaxGroup(cfg, dp=2, max_batch=2, max_seq=192, host_blocks=64, kernel="reference")
    for e in grp.engines:
        e.params = params
    p0, p1 = H.cross_prompts(jax_assemble)
    r0 = grp.engines[0].submit(p0, max_new=3)
    grp.run_until_done()
    r1 = grp.engines[1].submit(p1, max_new=3)
    grp.run_until_done()
    st = grp.stats()
    out["cross"] = dict(tokens=(r0.out_tokens, r1.out_tokens),
                        r1=(r1.host_prefix_tokens, r1.shared_prefix_tokens),
                        cross=st["cross_replica_host_hits"], hits=st["host_hit_tokens"],
                        host=dict(st["host_store"]))

    grp = JaxGroup(cfg, dp=2, max_batch=2, max_seq=64, n_blocks_per_replica=8,
                   preempt="swap", prefix_sharing=False, kernel="reference")
    for e in grp.engines:
        e.params = params
    reqs = [grp.engines[d].submit(np.arange(30) % 90 + off + 3 * i, max_new=24)
            for d, off in ((0, 0), (1, 1)) for i in range(2)]
    grp.run_until_done(max_steps=2000)
    out["swap_tokens"] = [r.out_tokens for r in reqs]
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    """{mesh name: each rank's ``mesh_job`` results}, one spawn a mesh."""
    return {name: run_on_ranks(H.mesh_job, tp, "cpu", jax_side["tree"], dp=dp)
            for name, (tp, dp) in MESHES.items()}


@pytest.fixture(scope="module")
def form_i(jax_side):
    return run_on_ranks(H.tp_group_job, 2, "cpu", jax_side["tree"])


# ------------------------------------------------------------ lone engine
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_lone_engine_on_a_data_axis_mesh(ranks, jax_side, mesh):
    tp, _ = MESHES[mesh]
    cfg = H.config()
    for r in ranks[mesh]:
        assert r["lone"]["tokens"] == jax_side["lone"]
        G, nb, _, kvh, _ = r["lone"]["pool_shape"]       # every block, its heads
        assert (G, nb, kvh) == (cfg.num_layers, 3 * (8 + 1) + 1, cfg.num_kv_heads // tp)
        assert "DataParallelEngineGroup" in r["lone_dp_blocks"]


# ---------------------------------------------------------- form (ii)
@pytest.mark.parametrize("dp_blocks", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_group_rows_tokens_equal_jax(ranks, jax_side, mesh, dp_blocks):
    want = jax_side["group"]
    assert want["tokens"] == jax_side["lone"]         # placement changes no math in JAX
    for r in ranks[mesh]:
        g = r[f"group_dp_blocks_{dp_blocks}"]
        assert g["tokens"] == want["tokens"]
        assert g["routes"] == want["routes"]
        st, jst = g["stats"], want["stats"]
        assert st.keys() == jst.keys()
        for key in ("dp_degree", "tokens_out", "prefill_tokens", "preemptions",
                    "host_hit_tokens"):
            assert st[key] == jst[key], key
        assert [s["prefix_hit_tokens"] for s in st["replicas"]] == \
            [s["prefix_hit_tokens"] for s in jst["replicas"]]
        assert [s["steps"] for s in st["replicas"]] == [s["steps"] for s in jst["replicas"]]


@pytest.mark.parametrize("dp_blocks", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_group_rows_own_jax_block_ranges(ranks, jax_side, mesh, dp_blocks):
    tp, _ = MESHES[mesh]
    cfg = H.config()
    want = jax_side["group"]
    per = 3 * (8 + 1) + 1
    for r in ranks[mesh]:
        g = r[f"group_dp_blocks_{dp_blocks}"]
        d = r["group_dp_blocks_True"]["row"]
        assert list(g["owned"]) == [d]                    # the rank's row is its replica
        assert g["owned"][d] == want["owned"][d]          # global ids, as JAX's
        assert g["null_block"][d] == want["null_block"][d]
        assert g["drained"]
        G, nb, _, kvh, _ = g["pool_blocks"][d]
        assert (G, kvh) == (cfg.num_layers, cfg.num_kv_heads // tp)
        assert nb == (per if dp_blocks else 2 * per)      # only its range with dp_blocks


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_group_census_by_group_and_audit(ranks, mesh):
    tp, _ = MESHES[mesh]
    cfg = H.config()
    fused = megatron_collectives(cfg, 3 * 64, 4, tp)     # B * C packed tokens, f32
    decode = megatron_collectives(cfg, 3, 4, tp)
    for r in ranks[mesh]:
        for dp_blocks in (True, False):
            g = r[f"group_dp_blocks_{dp_blocks}"]
            c = g["census"]
            for prog, want in (("fused", fused), ("decode", decode)):
                model = c[prog]["model"]
                assert (model.get("all-reduce", 0), model.get("all-reduce_bytes", 0)) == \
                    (want["all-reduce"], want["all-reduce_bytes"]), (prog, c[prog])
                assert set(c[prog]) == {"model", "data"} and not c[prog]["data"], c[prog]
                assert set(k for k in model if not k.endswith("_bytes")) <= {"all-reduce"}
            assert not any(c["pool"].values()), c["pool"]
            assert g["audit_ok"], g["audit"]
        mutant = r["group_dp_blocks_True"]["mutant"]
        assert len(mutant) == 1 and "fused_ragged" in mutant[0], mutant
        assert "1 collective(s) on the data group" in mutant[0]
        assert "each row is one replica" in r["group_dp_blocks_True"]["dp_mismatch"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cross_replica_host_hits_on_the_rows(ranks, jax_side, mesh):
    want = jax_side["cross"]
    for r in ranks[mesh]:
        got = {k: v for k, v in r["cross"].items() if k != "exchanges"}
        assert got == want
        assert got["cross"] > 0 and got["r1"][0] > 0 and got["r1"][1] == 0
        n_blocks = sum(n for n, _ in r["cross"]["exchanges"])
        assert n_blocks == want["host"]["puts"]          # every put crossed once


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sanitized_rows_drain_clean(ranks, jax_side, mesh):
    for r in ranks[mesh]:
        s = r["sanitized"]
        assert s["done"] and s["tokens"] == jax_side["swap_tokens"]
        assert s["violations"] == 0 and s["swap_outs"] >= 1
        assert s["op_counts"].get("host_restore", 0) > 0
        shadow = s["shadow"]
        assert shadow["device_allocated"] == 1           # the row's scratch block
        assert shadow["copy_pending"] == 0 and shadow["host_pinned"] == 0


# ------------------------------------------------------------- form (i)
def test_tp_only_layout_group_is_jax_group(form_i, jax_side):
    want = jax_side["group_host"]
    cfg = H.config()
    for r in form_i:
        assert r["tokens"] == want["tokens"] == jax_side["lone"]
        assert r["routes"] == want["routes"]
        assert r["stats"]["cross_replica_host_hits"] == \
            want["stats"]["cross_replica_host_hits"] > 0
        assert r["stats"]["host_hit_tokens"] == want["stats"]["host_hit_tokens"]
        assert [r["owned"][d] for d in (0, 1)] == want["owned"]
        assert r["box_shared"] and r["params_shared"] and r["drained"]
        assert r["pool_shape"][3] == r["host_shape"][3] == cfg.num_kv_heads // 2
