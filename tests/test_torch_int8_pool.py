"""The port's int8 paged pools against the JAX package on the CPU.

* The quantized writes (``_quantized_scatter``, ``write_paged_packed_q``),
  ``dequantize_blocks`` and ``reset_block_scales`` on a reused block, on
  seeded numpy inputs: int8 payloads equal and scales equal in float32, bit
  for bit (duplicate lanes, pads routed to the null block, scale growth that
  requantizes old slots, zero scales). Where several lanes write one slot
  with different values (pads into the null block's slot 0) neither side
  fixes which write wins, and that slot is left out; nothing reads it.
* The int8 stacks (``prefill_packed``/``decode_step_paged`` with scale
  pools) against JAX's (Pallas kernels in interpret mode): logits at 1e-4
  (two float32 stacks summing in different orders); the K/V the stacks
  quantize differ by float32 rounding, so pools agree within one int8 code
  and scales at 1e-5 relative.
* The int8 engine against the JAX int8 engine (``kernel="pallas"``) on the
  invariant-harness workloads (full pool, tiny pool, long decodes under
  swap): identical StepPlans, greedy tokens and counters; pipelined equal to
  sync; and greedy agreement with the float engine at or above the JAX
  package's pinned floor of 0.75 (``INT8_GREEDY_FLOOR``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import decode_step_paged as jax_decode
from repro.models import init_params as jax_init_params
from repro.models import prefill_packed as jax_prefill
from repro.serving import paged_cache as jpc
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models import decode_step_paged, prefill_packed
from repro_torch.params import params_from_numpy
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving.engine import _NULL_SEQ, GenerationEngine

torch.set_num_threads(1)

INT8_GREEDY_FLOOR = 0.75   # tests/test_engine_invariants.py
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SCALE_TOL = dict(rtol=1e-5, atol=0)


# ---------------------------------------------------------------- scatters
def _pool(rng, G, nb, bs, kvh, hd, zero_blocks=()):
    pool = rng.integers(-127, 128, (G, nb, bs, kvh, hd)).astype(np.int8)
    sc = rng.uniform(0.001, 0.05, (G, nb, kvh)).astype(np.float32)
    for b in zero_blocks:          # fresh blocks: zero payload and scale
        pool[:, b] = 0
        sc[:, b] = 0.0
    return pool, sc


def _contested(dest):
    """Flat slots written by more than one lane (which write wins is
    unspecified on both sides)."""
    u, c = np.unique(np.asarray(dest), return_counts=True)
    return set(u[c > 1].tolist())


def _assert_pools_equal(got, want, contested, bs):
    got, want = np.asarray(got), np.asarray(want)
    G, nb = want.shape[0], want.shape[1]
    g = got.reshape(G, nb * bs, *want.shape[3:])
    w = want.reshape(G, nb * bs, *want.shape[3:])
    keep = np.array([i not in contested for i in range(nb * bs)])
    np.testing.assert_array_equal(g[:, keep], w[:, keep])


# (seed, N lanes, value scale, zero blocks, dest kind)
SCATTER_CASES = [
    (0, 6, 0.02, (), "distinct"),        # small values: scales mostly hold
    (1, 9, 5.0, (), "same_block"),       # several lanes in one block: growth
    (2, 7, 1.0, (2, 3), "distinct"),     # zero scales: ratio 1, fresh blocks
    (3, 12, 3.0, (0,), "pads"),          # pads into the null block (block 0)
    (4, 5, 0.0, (1,), "distinct"),       # all-zero values into a zero block
]


def _dest(rng, kind, N, nb, bs):
    if kind == "same_block":
        b = int(rng.integers(1, nb))
        return (b * bs + rng.permutation(bs)[:N % bs + 2]).astype(np.int32)
    if kind == "pads":
        d = rng.choice(np.arange(bs, nb * bs), N - 4, replace=False)
        return np.concatenate([d, np.zeros(4, np.int64)]).astype(np.int32)
    return rng.choice(nb * bs, N, replace=False).astype(np.int32)


@pytest.mark.parametrize("seed,N,scale,zero,kind", SCATTER_CASES)
def test_quantized_scatter_matches_jax_bit_for_bit(seed, N, scale, zero, kind):
    rng = np.random.default_rng(seed)
    G, nb, bs, kvh, hd = 2, 6, 4, 2, 8
    pool, sc = _pool(rng, G, nb, bs, kvh, hd, zero)
    dest = _dest(rng, kind, N, nb, bs)
    vals = (scale * rng.standard_normal((G, len(dest), kvh, hd))).astype(np.float32)
    jp, js = jpc._quantized_scatter(jnp.asarray(pool), jnp.asarray(sc),
                                    jnp.asarray(dest), jnp.asarray(vals))
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(sc.copy())
    out = tpc._quantized_scatter(tp, ts, torch.from_numpy(dest), torch.from_numpy(vals))
    assert out[0] is tp and out[1] is ts            # in place
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _assert_pools_equal(tp, jp, _contested(dest), bs)
    if scale >= 1.0:   # the scale grew somewhere, so old slots were requantized
        grown = ts.numpy() > sc
        assert grown.any()
        touched = np.unique(dest // bs)
        assert not np.array_equal(tp.numpy()[:, touched], pool[:, touched])


def tie_case(seed, G=2, nb=6, bs=4, kvh=2, hd=8):
    """A quantized write whose every entry lands exactly on a .5 code: one
    lane a fresh block, each (lane, head) holding +-127/128 (so the new
    scale is exactly 2**-7) and (n + 0.5)/128 elsewhere. Returns numpy
    (pool, scales, dest, vals)."""
    rng = np.random.default_rng(seed)
    pool = np.zeros((G, nb, bs, kvh, hd), np.int8)
    sc = np.zeros((G, nb, kvh), np.float32)
    dest = (np.arange(1, nb) * bs + rng.integers(0, bs, nb - 1)).astype(np.int32)
    n = rng.integers(-127, 127, (G, nb - 1, kvh, hd))
    vals = ((n + 0.5) / 128.0).astype(np.float32)
    vals[..., 0] = rng.choice([-127.0, 127.0], (G, nb - 1, kvh)) / 128.0
    return pool, sc, dest, vals


def test_quantized_scatter_rounds_ties_to_even_as_jax():
    pool, sc, dest, vals = tie_case(11)
    jp, js = jpc._quantized_scatter(jnp.asarray(pool), jnp.asarray(sc),
                                    jnp.asarray(dest), jnp.asarray(vals))
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(sc.copy())
    tpc._quantized_scatter(tp, ts, torch.from_numpy(dest), torch.from_numpy(vals))
    assert (ts.numpy()[:, 1:] == 2.0 ** -7).all()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    flat = tp.numpy().reshape(2, -1, 2, 8)[:, dest, :, 1:]
    assert (flat % 2 == 0).all()          # every .5 went to the even code


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_paged_packed_q_matches_jax_bit_for_bit(seed):
    """Packed tokens of three rows through RAW tables (an unbacked -1
    entry and pad tokens both go to the null block), several tokens per
    block, into one layer's int8 slice with partly zero scales."""
    rng = np.random.default_rng(seed)
    nb, bs, kvh, hd, null = 10, 4, 2, 16, 0
    pool, sc = _pool(rng, 1, nb, bs, kvh, hd, zero_blocks=(4, 5))
    pool, sc = pool[0], sc[0]
    tables = np.asarray([[3, 4, -1, 7], [5, 1, 2, -1], [6, -1, -1, -1]], np.int32)
    row_of = np.asarray([0] * 6 + [1] * 7 + [2] * 3 + [-1, -1], np.int32)
    slots = np.asarray(list(range(2, 8)) + list(range(0, 7)) + [0, 1, 2] + [0, 0], np.int32)
    slots[5] = 9                                   # row 0's table entry 2 is -1
    new = (rng.standard_normal((len(row_of), kvh, hd)) * rng.uniform(0.1, 4)).astype(np.float32)
    jp, js = jpc.write_paged_packed_q(jnp.asarray(pool), jnp.asarray(sc), jnp.asarray(tables),
                                      jnp.asarray(row_of), jnp.asarray(slots),
                                      jnp.asarray(new), bs, null)
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(sc.copy())
    tpc.write_paged_packed_q(tp, ts, torch.from_numpy(tables), torch.from_numpy(row_of),
                             torch.from_numpy(slots), torch.from_numpy(new), bs, null)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _assert_pools_equal(tp[None], np.asarray(jp)[None], {null * bs}, bs)
    assert ts[null].gt(0).all()     # pads grew the null block's scale


def test_dequantize_blocks_matches_jax():
    rng = np.random.default_rng(7)
    blocks = rng.integers(-127, 128, (2, 3, 4, 2, 8)).astype(np.int8)
    scales = rng.uniform(0, 0.05, (2, 3, 2)).astype(np.float32)
    scales[0, 1] = 0.0
    want = np.asarray(jpc.dequantize_blocks(jnp.asarray(blocks), jnp.asarray(scales)))
    got = tpc.dequantize_blocks(torch.from_numpy(blocks), torch.from_numpy(scales))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_reset_block_scales_on_a_reused_block():
    """A block released by one sequence and handed to the next keeps no
    trace of its old tenant's absmax: admission resets the scales of every
    fresh block, and the next write starts the running max from zero."""
    jcfg = jax_smoke(jax_get_arch("smollm-135m"))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    bs = 4
    jc = jpc.PagedKVCache(jcfg, n_blocks=6, block_size=bs, max_blocks_per_seq=4,
                          kv_dtype="int8")
    tc = tpc.PagedKVCache(tcfg, n_blocks=6, block_size=bs, max_blocks_per_seq=4,
                          kv_dtype="int8", device="cpu")
    assert tc.quantized and tc.k.dtype == torch.int8 and tc.kv_dtype == "int8"
    assert tuple(tc.k_scale.shape) == tuple(jc.k_scale.shape) == (2, 6, 2)
    rng = np.random.default_rng(3)
    G, kvh, hd = 2, tcfg.num_kv_heads, tcfg.head_dim
    for tenant, amp in ((1, 8.0), (2, 0.01)):          # a loud tenant, then a quiet one
        toks = rng.integers(0, 90, 6)
        ja, ta = jc.admit_tokens(tenant, toks), tc.admit_tokens(tenant, toks)
        assert ja.n_shared == ta.n_shared == 0
        assert jc.pool.tables[tenant] == tc.pool.tables[tenant]
        blocks = tc.pool.tables[tenant]
        dest = np.asarray([blocks[i // bs] * bs + i % bs for i in range(6)], np.int32)
        vals = (amp * rng.standard_normal((G, 6, kvh, hd))).astype(np.float32)
        jc.k, jc.k_scale = jpc._quantized_scatter(jc.k, jc.k_scale, jnp.asarray(dest),
                                                  jnp.asarray(vals))
        tpc._quantized_scatter(tc.k, tc.k_scale, torch.from_numpy(dest),
                               torch.from_numpy(vals))
        np.testing.assert_array_equal(tc.k_scale.numpy(), np.asarray(jc.k_scale))
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        jc.release(tenant)
        tc.release(tenant)
    # the quiet tenant reused the loud one's blocks and its scales are its own
    assert float(tc.k_scale[:, blocks].max()) <= 0.01 * 6 / 127


# ------------------------------------------------------------------ stacks
BS, MB, NB, NULL = 16, 4, 14, 0


def _setup(arch, seed):
    jcfg = jax_smoke(jax_get_arch(arch))
    tcfg = smoke_variant(get_arch(arch))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tcfg, tree, "cpu")
    shape = (jcfg.num_layers, NB, BS, jcfg.num_kv_heads, jcfg.head_dim)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, shape[:2] + shape[3:4]).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, shape[:2] + shape[3:4]).astype(np.float32)
    ks[:, 9] = vs[:, 9] = 0.0                 # a fresh block
    k[:, 9] = v[:, 9] = 0
    return jcfg, tcfg, jparams, tparams, (k, v, ks, vs), rng


def _assert_int8_state(got, want):
    """Pools within one code (the stacks' K/V differ by float32 rounding
    before they are quantized), scales at 1e-5 relative. The null block
    (block 0) is left out: only pad tokens write it and nothing reads it,
    and from the second layer on a pad token's hidden state is whatever its
    fully masked attention gives, which the two sides need not agree on."""
    tk, tv, tks, tvs = (t.numpy() for t in got)
    jk, jv, jks, jvs = (np.asarray(a) for a in want)
    for g, w in ((tk, jk), (tv, jv)):
        diff = np.abs(g[:, 1:].astype(np.int32) - w[:, 1:].astype(np.int32))
        assert diff.max() <= 1, diff.max()
        assert (diff == 0).mean() > 0.999
    np.testing.assert_allclose(tks[:, 1:], jks[:, 1:], **SCALE_TOL)
    np.testing.assert_allclose(tvs[:, 1:], jvs[:, 1:], **SCALE_TOL)


@pytest.mark.parametrize("arch,seed", [("qwen2.5-3b", 0), ("smollm-135m", 1)])
def test_int8_prefill_packed_matches_jax(arch, seed):
    jcfg, tcfg, jp, tp, pools, rng = _setup(arch, seed)
    tables = np.full((3, MB), -1, np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :2] = [5, 9]           # block 9 is fresh: zero scales
    tables[2, :1] = [11]
    row_of = np.asarray([0] + [1] * 10 + [2] * 6 + [-1, -1], np.int32)
    slots = np.asarray([20] + list(range(8, 18)) + list(range(6)) + [0, 0], np.int32)
    positions = slots.copy()
    p_end = np.zeros_like(slots)
    s_start = np.zeros_like(slots)
    tokens = rng.integers(0, jcfg.vocab_size, len(slots)).astype(np.int32)
    plan = (tables, tokens, row_of, slots, positions, p_end, s_start)
    jl, *jstate = jax_prefill(
        jcfg, jp, jnp.asarray(pools[0]), jnp.asarray(pools[1]), *map(jnp.asarray, plan),
        block_size=BS, null_block=NULL, impl="pallas", interpret=True,
        k_scales=jnp.asarray(pools[2]), v_scales=jnp.asarray(pools[3]))
    tstate = [torch.from_numpy(a.copy()) for a in pools]
    tl = prefill_packed(tcfg, tp, tstate[0], tstate[1], *map(torch.from_numpy, plan),
                        block_size=BS, null_block=NULL, k_scales=tstate[2],
                        v_scales=tstate[3])
    valid = row_of >= 0
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **LOGIT_TOL)
    _assert_int8_state(tstate, jstate)
    assert (tstate[2].numpy()[:, 9] > 0).all()          # the fresh block's scale grew


@pytest.mark.parametrize("arch,seed", [("qwen2.5-3b", 2), ("smollm-135m", 3)])
def test_int8_decode_step_paged_matches_jax(arch, seed):
    jcfg, tcfg, jp, tp, pools, rng = _setup(arch, seed)
    tables = np.full((3, MB), NULL, np.int32)
    tables[0, :3] = [3, 7, 11]
    tables[1, :2] = [5, 9]           # decodes into the fresh block 9
    pos = np.asarray([37, 16, 0], np.int32)   # row 2 inactive
    tokens = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    jl, *jstate = jax_decode(
        jcfg, jp, jnp.asarray(pools[0]), jnp.asarray(pools[1]), jnp.asarray(tables),
        jnp.asarray(tokens), jnp.asarray(pos), block_size=BS, null_block=NULL,
        interpret=True, k_scales=jnp.asarray(pools[2]), v_scales=jnp.asarray(pools[3]))
    tstate = [torch.from_numpy(a.copy()) for a in pools]
    tl = decode_step_paged(tcfg, tp, tstate[0], tstate[1], torch.from_numpy(tables),
                           torch.from_numpy(tokens), torch.from_numpy(pos),
                           block_size=BS, null_block=NULL, k_scales=tstate[2],
                           v_scales=tstate[3])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_int8_state(tstate, jstate)


# ------------------------------------------------------------------ engine
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


def _run(make_engine, seed, n_blocks, pipeline=True, long_decode=False,
         preempt="recompute", **kw):
    """The invariant harness's bursty workload (``_run_workload``), greedy."""
    rng = np.random.default_rng(seed)
    eng = make_engine(max_batch=3, max_seq=96, n_blocks=n_blocks,
                      prefill_chunk_size=16, token_budget=20, scheduler="fifo",
                      interleave=True, preempt=preempt, pipeline=pipeline, **kw)
    plans = _capture_plans(eng)
    ctx = rng.integers(0, 90, size=32).astype(np.int32)
    reqs = []
    for _ in range(4):
        for _ in range(int(rng.integers(1, 4))):
            if long_decode:
                prompt = rng.integers(0, 90, size=int(rng.integers(3, 13)))
                max_new = int(rng.integers(28, 39))
            else:
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


_FIELDS = ("tokens", "starts", "temps", "tables", "prev_slots", "n_valid",
           "positions", "p_end", "s_start", "row_of", "slots", "decode_idx",
           "last_idx")


def _assert_same_plans(jplans, tplans):
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


# (seed, n_blocks, long_decode, preempt): full pool, tiny pool (backpressure
# and recompute), long decodes that preempt by swap
WORKLOADS = [(0, None, False, "recompute"), (2, 8, False, "recompute"),
             (5, 6, True, "swap")]


@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, tree, tcfg, params_from_numpy(tcfg, tree, "cpu")


@pytest.fixture(scope="module")
def runs(weights):
    jcfg, tree, tcfg, tparams = weights
    jparams = jax.tree.map(jnp.asarray, tree)
    out = {}
    for seed, nb, long_decode, preempt in WORKLOADS:
        kw = dict(long_decode=long_decode, preempt=preempt, kv_dtype="int8")
        jax_run = _run(lambda **a: JaxEngine(jcfg, params=jparams, kernel="pallas", **a),
                       seed, nb, **kw)
        tor_run = _run(lambda **a: GenerationEngine(tcfg, params=tparams, device="cpu", **a),
                       seed, nb, **kw)
        out[seed] = (jax_run, tor_run)
    return out


@pytest.mark.parametrize("seed,n_blocks,long_decode,preempt", WORKLOADS)
def test_int8_engine_plans_and_tokens_match_jax(runs, seed, n_blocks, long_decode, preempt):
    (jeng, jreqs, jplans), (teng, treqs, tplans) = runs[seed]
    assert teng.kv.quantized and teng.stats()["kv_dtype"] == "int8"
    _assert_same_plans(jplans, tplans)
    for a, b in zip(jreqs, treqs):
        assert b.out_tokens == a.out_tokens, (a.req_id, a.out_tokens, b.out_tokens)
    tst, jst = teng.stats(), jeng.stats()
    for key in ("steps", "preemptions", "swap_outs", "swap_ins", "prefix_hit_tokens",
                "host_hit_tokens", "prefill_tokens"):
        assert tst[key] == jst[key], key
    if long_decode:
        assert tst["swap_outs"] >= 1 and tst["host_store"]["n_swapped"] == 0


@pytest.mark.parametrize("seed,n_blocks,long_decode,preempt", WORKLOADS)
def test_int8_engine_drains_clean(runs, seed, n_blocks, long_decode, preempt):
    _, (eng, reqs, _) = runs[seed]
    assert all(r.done and len(r.out_tokens) == r.max_new for r in reqs)
    pool = eng.kv.pool
    assert pool.n_free == pool.n_blocks - 1
    assert pool.tables == {_NULL_SEQ: [eng._null_block]}
    assert eng.kv.lengths == {}
    assert eng.stats()["kernel"] == "plain"


@pytest.mark.parametrize("seed,n_blocks,long_decode,preempt", WORKLOADS)
def test_int8_pipelined_matches_sync(runs, weights, seed, n_blocks, long_decode, preempt):
    _, (_, pip_reqs, _) = runs[seed]
    tcfg, tparams = weights[2], weights[3]
    sync_eng, sync_reqs, _ = _run(
        lambda **a: GenerationEngine(tcfg, params=tparams, device="cpu", **a),
        seed, n_blocks, pipeline=False, long_decode=long_decode, preempt=preempt,
        kv_dtype="int8")
    assert not sync_eng.pipeline
    for a, b in zip(sync_reqs, pip_reqs):
        assert a.out_tokens == b.out_tokens


@pytest.mark.parametrize("seed,n_blocks,long_decode,preempt", WORKLOADS)
def test_int8_greedy_agreement_with_float(runs, weights, seed, n_blocks, long_decode,
                                          preempt):
    _, (_, q_reqs, _) = runs[seed]
    tcfg, tparams = weights[2], weights[3]
    _, f_reqs, _ = _run(
        lambda **a: GenerationEngine(tcfg, params=tparams, device="cpu", **a),
        seed, n_blocks, long_decode=long_decode, preempt=preempt)
    match = total = 0
    for a, b in zip(f_reqs, q_reqs):
        n = min(len(a.out_tokens), len(b.out_tokens))
        match += sum(int(x == y) for x, y in zip(a.out_tokens[:n], b.out_tokens[:n]))
        total += n
    assert match / max(total, 1) >= INT8_GREEDY_FLOOR, match / max(total, 1)


def test_quant_config_routes_to_int8_pools(weights):
    """A ``kv_cache_quant`` config serves on the paged backend with int8
    pools, as in JAX; on the dense backend it keeps the int8 dense cache
    (held against JAX in tests/test_torch_int8_dense.py)."""
    tcfg, tparams = weights[2], weights[3]
    qcfg = tcfg.replace(kv_cache_quant=True)
    eng = GenerationEngine(qcfg, params=tparams, device="cpu", max_batch=2, max_seq=64)
    assert eng.backend == "paged" and eng.kv_dtype == "int8" and eng.kv.quantized
    assert eng.stats()["kv_dtype"] == "int8"
    r = eng.submit(np.arange(12) % 50, max_new=4)
    eng.run_until_done()
    assert r.done and len(r.out_tokens) == 4
    dense = GenerationEngine(qcfg, params=tparams, device="cpu", backend="dense", max_batch=2,
                             max_seq=64)
    assert dense.backend == "dense" and dense.cache[0]["k"].dtype == torch.int8
    r = dense.submit(np.arange(12) % 50, max_new=4)
    dense.run_until_done()
    assert r.done and len(r.out_tokens) == 4
