"""Tensor-parallel paged serving over torch.distributed (gloo, spawned
ranks on the CPU) held against the JAX package.

* tp=2 on smollm-135m's smoke variant and tp=4 on JAX's
  ``replace(smoke_variant(qwen2.5-3b), num_heads=8, num_kv_heads=4)``: on
  ``tests/test_sharded_pool.py``'s shared-document RAG burst, every rank's
  greedy tokens equal the unsharded JAX engine's (``kernel="reference"``
  on both sides, the same weights) and each other's, hit rates equal;
  each rank holds KVH / tp heads of every block.
* the step programs' collective census at tp 1 / 2 / 4: 2 x num_layers
  all-reduces of the Megatron formula's bytes on the fused and decode
  programs, none on the pool roundtrip, no all-gather; the step audit
  holds on every rank.
* ``ShardedPoolLayout.validate`` rejects kv_heads=3 at tp=4; the int8 and
  Pallas refusals carry JAX's messages; a lone engine on a data-axis
  layout serves as the unsharded one, a group takes a TP-only layout, and
  ``dp_blocks`` without a group is refused; ``make_pool_layout``'s
  degenerate case is None; a stack the Megatron pair does not cover
  refuses a tensor-parallel group.
* the explicit TP block (``make_tp_block``) against ``tp_block_reference``
  within 1e-5, one all-reduce; the DTensor block beside it.
* ``launch.serve --tp 2`` and ``--tp 2 --dp 2`` on the CPU and their
  refusals.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import tp_harness as H
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.launch.mesh import make_serving_mesh as jax_serving_mesh
from repro.models import init_params as jax_init_params
from repro.serving.engine import GenerationEngine as JaxEngine
from repro.serving.segments import assemble_prompt as jax_assemble
from repro.serving.sharded_pool import ShardedPoolLayout as JaxLayout
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.launch.mesh import AbstractMesh, make_serving_mesh, run_on_ranks
from repro_torch.models.shardmap_tp import megatron_collectives, tp_block_reference
from repro_torch.serving.engine import DataParallelEngineGroup, GenerationEngine
from repro_torch.serving.sharded_pool import ShardedPoolLayout, make_pool_layout

CASES = {2: ("smollm-135m", {}), 4: ("qwen2.5-3b", {"num_heads": 8, "num_kv_heads": 4})}
MAX_NEW = 6


def _jax_run(arch, over):
    """The unsharded JAX engine (``kernel="reference"``, its default) on
    the RAG burst; returns (weights as numpy, tokens, hit rate)."""
    cfg = jax_smoke(jax_get_arch(arch)).replace(**over)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    eng = JaxEngine(cfg, params=params, max_batch=3, max_seq=128, seed=0)
    reqs = [eng.submit(p, max_new=MAX_NEW) for p in H.rag_prompts(cfg.vocab_size, jax_assemble)]
    eng.run_until_done()
    return (jax.tree.map(np.asarray, params), [r.out_tokens for r in reqs],
            eng.measured_hit_rate())


@pytest.fixture(scope="module")
def runs():
    """{tp: (JAX tokens, JAX hit rate, the ranks' results)}; tp 4 also runs
    the TP block."""
    out = {}
    rng = np.random.default_rng(3)
    block = tuple(rng.standard_normal(s).astype(np.float32) * sc
                  for s, sc in (((4, 64), 1.0), ((64, 256), 0.1), ((256, 64), 0.1)))
    for tp, (arch, over) in CASES.items():
        tree, tokens, hit = _jax_run(arch, over)
        serve_args = (arch, over, tree, MAX_NEW)
        if tp == 4:
            ranks = run_on_ranks(H.serve_and_block_job, tp, "cpu", serve_args, block)
        else:
            ranks = [{"serve": r} for r in run_on_ranks(H.serve_job, tp, "cpu", *serve_args)]
        out[tp] = (tokens, hit, ranks, tree, block)
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_tokens_equal_the_jax_unsharded_engine(runs, tp):
    tokens, hit, ranks, _, _ = runs[tp]
    assert hit > 0.1, hit                  # the burst really shares prefixes
    for r in ranks:
        s = r["serve"]
        assert s["tokens"] == tokens
        assert abs(s["hit_rate"] - hit) < 1e-9
        assert s["stats_tp"] == tp


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_ranks_hold_their_heads(runs, tp):
    arch, over = CASES[tp]
    cfg = H.tp_config(arch, **over)
    for r in runs[tp][2]:
        s = r["serve"]
        G, _, bs, kvh, hd = s["pool_shape"]
        assert (G, bs, kvh, hd) == (cfg.num_layers, 16, cfg.num_kv_heads // tp, cfg.head_dim)
        assert s["step_cfg_heads"] == (cfg.num_heads // tp, cfg.num_kv_heads // tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_census_is_the_megatron_pair(runs, tp):
    arch, over = CASES[tp]
    cfg = H.tp_config(arch, **over)
    T = 3 * 64                               # B * C packed tokens, pack_align 4
    for r in runs[tp][2]:
        c = r["serve"]["census"]
        fused = megatron_collectives(cfg, T, 4, tp)
        decode = megatron_collectives(cfg, 3, 4, tp)
        assert fused["all-reduce"] == 2 * cfg.num_layers
        assert (c["fused"]["all-reduce"], c["fused"]["all-reduce_bytes"]) == \
            (fused["all-reduce"], fused["all-reduce_bytes"])
        assert (c["decode"]["all-reduce"], c["decode"]["all-reduce_bytes"]) == \
            (decode["all-reduce"], decode["all-reduce_bytes"])
        for prog in c.values():
            assert prog["all-gather"] == prog["all-to-all"] == prog["reduce-scatter"] == 0
        assert not any(c["pool"].values()), c["pool"]
        assert r["serve"]["audit_ok"], r["serve"]["audit"]


def test_tp1_layout_is_the_unsharded_engine_bit_for_bit(runs):
    """A world-size-1 layout: tokens and pools equal the layout-less
    engine's; no collective anywhere."""
    arch, over = CASES[2]
    cfg = H.tp_config(arch, **over)
    from repro_torch.params import params_from_numpy

    tree = runs[2][3]
    prompts = H.rag_prompts(cfg.vocab_size, H.assemble_prompt)
    ref = GenerationEngine(cfg, params=params_from_numpy(cfg, tree, "cpu"), max_batch=3,
                           max_seq=128, seed=0, kernel="reference", device="cpu")
    ref_reqs = [ref.submit(p, max_new=MAX_NEW) for p in prompts]
    ref.run_until_done()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        lay = make_pool_layout(mesh=make_serving_mesh(tp=1))
        eng = GenerationEngine(cfg, params=params_from_numpy(cfg, tree, "cpu"), max_batch=3,
                               max_seq=128, seed=0, kernel="reference", device="cpu",
                               pool_layout=lay)
        reqs = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
        eng.run_until_done()
        assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
        assert torch.equal(eng.kv.k, ref.kv.k) and torch.equal(eng.kv.v, ref.kv.v)
        assert eng.stats()["tp_degree"] == 1
        for which in ("fused", "decode", "pool"):
            assert not any(eng.audit_collectives(which).values()), which
    finally:
        dist.destroy_process_group()


def test_tp_block_against_the_reference(runs):
    x, w_in, w_out = (torch.from_numpy(a) for a in runs[4][4])
    want = tp_block_reference(x, w_in, w_out).numpy()
    for r in runs[4][2]:
        b = r["block"]
        np.testing.assert_allclose(b["out"], want, atol=1e-5, rtol=1e-5)
        assert b["census"]["all-reduce"] == 1
        assert b["census"]["all-reduce_bytes"] == x.numel() * 4
        assert sum(v for k, v in b["census"].items() if not k.endswith("_bytes")) == 1
        # the DTensor block: the same numbers; its schedule, as DTensor
        # propagates it, is one all-reduce of the partial sum too, beside
        # what its placement sends (x broadcast from rank 0, a scatter of
        # each weight, which the census files under "other")
        np.testing.assert_allclose(b["dtensor_out"], want, atol=1e-5, rtol=1e-5)
        kinds = {k: v for k, v in b["dtensor_census"].items() if v and not k.endswith("_bytes")}
        assert kinds == {"all-reduce": 1, "broadcast": 1, "other": 2}, b["dtensor_census"]
        assert b["dtensor_census"]["all-reduce_bytes"] == x.numel() * 4


def test_refusals_carry_jax_messages(runs):
    jcfg = jax_smoke(jax_get_arch("smollm-135m"))
    want = {}
    for name, kw in (("pallas", {"kernel": "pallas"}),
                     ("int8", {"kernel": "reference", "kv_dtype": "int8"})):
        with pytest.raises(ValueError) as e:
            JaxEngine(jcfg, max_batch=3, max_seq=128, pool_layout=JaxLayout(jax_serving_mesh(1)),
                      **kw)
        want[name] = str(e.value)
    for tp in (2, 4):
        for r in runs[tp][2]:
            assert r["serve"]["refusals"] == want


def test_validate_and_the_data_axis():
    cfg = H.tp_config("qwen2.5-3b", num_heads=8, num_kv_heads=4)
    lay = ShardedPoolLayout(AbstractMesh(("model",), (4,)))
    lay.validate(cfg)
    with pytest.raises(ValueError, match="num_kv_heads=3 does not divide the model axis"):
        lay.validate(cfg.replace(num_kv_heads=3, num_heads=9))
    assert lay.pool_shape(cfg, 10, 16) == (2, 10, 16, 1, cfg.head_dim)
    assert lay.entry_shape(cfg, 3, 40) == (2, 3, 40, 1, cfg.head_dim)
    # a lone engine on a (2, 1) data-axis layout is replicated over "data"
    # (a "model" axis of one rank needs no process group): the unsharded
    # engine's tokens; a group takes a TP-only layout (one rank here; tp 2
    # in tests/test_torch_dp_mesh.py)
    small = H.tp_config("smollm-135m")
    kw = dict(max_batch=2, max_seq=64, kernel="reference", device="cpu")
    prompts = [np.arange(20) % 97, np.arange(9) + 3]

    def serve(eng):
        reqs = [eng.submit(p, max_new=4) for p in prompts]
        eng.run_until_done()
        return [r.out_tokens for r in reqs]

    want = serve(GenerationEngine(small, **kw))
    data_axis = ShardedPoolLayout(AbstractMesh(("data", "model"), (2, 1)))
    eng = GenerationEngine(small, pool_layout=data_axis, **kw)
    assert serve(eng) == want and eng.kv.k.shape[1] == 2 * (4 + 1) + 1
    grp = DataParallelEngineGroup(small, dp=2, pool_layout=ShardedPoolLayout(
        AbstractMesh(("model",), (1,))), **kw)
    assert serve(grp) == want and grp.engines[0].kv._arrays is grp.engines[1].kv._arrays
    split = ShardedPoolLayout(data_axis.mesh, dp_blocks=True)
    with pytest.raises(ValueError, match="DataParallelEngineGroup"):
        GenerationEngine(small, pool_layout=split, n_blocks=12, **kw)
    # 11 blocks do not divide over 2 rows: they stay whole, as in JAX
    assert GenerationEngine(small, pool_layout=split, n_blocks=11, **kw).kv.k.shape[1] == 11
    assert make_pool_layout() is None
    assert make_pool_layout(tp=1) is None
    assert make_pool_layout(tp=1, dp=1) is None


# the archs whose every projection the Megatron pair covers (dense
# full-attention GQA decoders with an MLP)
TP_STACKS = {"smollm-135m", "qwen2.5-3b", "phi3-medium-14b", "internvl2-1b"}


@pytest.mark.parametrize("arch", sorted(TORCH_ARCHS))
def test_tp_group_only_where_the_megatron_pair_covers_every_projection(arch):
    """A stack given a tensor-parallel group must not return a rank's
    partial sum: MoE, MLA, hybrid, RWKV-6, windowed, chunked and
    cross-attention stacks refuse one before any layer runs."""
    from repro_torch.configs import get_arch as torch_get_arch
    from repro_torch.configs import smoke_variant
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.models import transformer as tfm

    cfg = smoke_variant(torch_get_arch(arch))
    if arch in TP_STACKS:
        tfm._check_tp(cfg, object())
        return
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    caches = init_cache(cfg, 2, 16, "cpu")
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="tensor-parallel layers cover dense"):
        decode_step(cfg, params, caches, torch.zeros((2, 1), dtype=torch.int32), pos,
                    tp_group=object())


def test_serve_tp_cli(capfd):
    from repro_torch.launch import serve

    serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--tp", "2",
                "--n-requests", "3", "--max-new", "4"])
    out = capfd.readouterr().out
    assert "tp=2" in out and "fused-step collectives: {'all-reduce': 4" in out
    # a (2, 2) mesh: each row one replica over its block range
    serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--tp", "2", "--dp",
                "2", "--n-requests", "4", "--max-new", "4"])
    out = capfd.readouterr().out
    assert "dp=2 tp=2" in out and "this rank's pool (2, 69, 16, 1, 64)" in out
    assert "collectives by group: {'model': {'all-reduce': 4, 'all-reduce_bytes': " in out
    assert "'data': {}}" in out
    for dp in ("1", "2"):
        for extra, msg in ((["--kernel", "pallas"], "--kernel pallas is single-device"),
                           (["--kv-dtype", "int8"], "--kv-dtype int8 is single-device")):
            with pytest.raises(SystemExit, match=msg):
                serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--tp", "2",
                            "--dp", dp, *extra])


def test_rank_device_takes_one_card_a_rank(monkeypatch):
    """On ``cuda`` rank r takes cuda:r and too few visible GPUs raise (no
    silent sharing); an indexed device is taken by every rank, as asked."""
    from repro_torch.launch.mesh import rank_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 GPUs, 1 visible"):
        rank_device("cuda", 1, 2)
    assert rank_device("cuda", 0, 1) == torch.device("cuda", 0)
    assert rank_device("cuda:0", 1, 2) == torch.device("cuda", 0)
    assert rank_device("cpu", 1, 2) == torch.device("cpu")
