"""The port's host-memory block tier and swap/cost preemption against the
JAX package on the CPU.

* ``HostBlockStore``: one seeded sequence of operations (puts, reads,
  re-heats, swap reserves, fills, restores, drops, all-or-nothing refusals)
  on the port's store and on ``repro.serving.host_tier.HostBlockStore``
  gives the same answers, slots, LRU order and counters, and the same slab
  contents: float32 and int8 (with scales) exactly, bfloat16 compared
  through its 16 bits.
* The engine under ``preempt="swap"`` and ``"cost"``, float and int8 pools,
  on the invariant harness's long-decode workloads with a 6-block pool,
  against the JAX engine (``kernel="pallas"``, interpret mode) with the same
  weights: identical StepPlans, greedy tokens, preemption/swap counts,
  cost-model choices and host hit tokens, and a store with no swap set left
  after the drain. ``cost`` reads the runner's per-token step time, which
  is pinned to one value on both sides (a wall-clock quantity otherwise).
* A warm block evicted from the pool demotes to the host tier and comes
  back as a host hit (``tests/test_host_tier.py``), float and int8, with the
  same counters and tokens as the JAX engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_params as jax_init_params
from repro.serving.engine import GenerationEngine as JaxEngine
from repro.serving.host_tier import HostBlockStore as JaxStore
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import _NULL_SEQ, GenerationEngine
from repro_torch.serving.host_tier import HostBlockStore

torch.set_num_threads(1)


# ------------------------------------------------------------------ store
def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """Bits of a bf16 tensor as uint16, anything else as itself."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _block(rng, shape, dtype_name):
    """The same block content for both stores: (numpy for JAX, torch)."""
    if dtype_name == "int8":
        a = rng.integers(-127, 128, shape).astype(np.int8)
        return a, torch.from_numpy(a.copy())
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype_name == "bfloat16":
        return a.astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return a, torch.from_numpy(a.copy())


def _state(store):
    return (list(store.free), list(store._lru), dict(store._by_key),
            {k: list(v) for k, v in store._swap.items()}, store.stats())


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_host_store_matches_jax_op_for_op(dtype_name):
    G, bs, KVH, hd, n = 2, 4, 2, 8, 6
    jdt = {"float32": np.float32, "bfloat16": jnp.bfloat16, "int8": np.int8}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[dtype_name]
    js = JaxStore((G, bs, KVH, hd), jdt, n_blocks=n)
    ts = HostBlockStore((G, bs, KVH, hd), tdt, n_blocks=n)
    quant = dtype_name == "int8"
    assert ts.quantized == js.quantized == quant
    rng = np.random.default_rng({"float32": 0, "bfloat16": 1, "int8": 2}[dtype_name])
    keys = [bytes([i]) * 20 for i in range(9)]
    tags = [("c", i) for i in range(4)]

    def scales(k):
        if not quant:
            return (None, None), (None, None)
        a = rng.uniform(0, 0.05, (G, KVH) if k is None else (G, k, KVH)).astype(np.float32)
        b = rng.uniform(0, 0.05, a.shape).astype(np.float32)
        return (a, b), (torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))

    refused = 0
    for step in range(120):
        op = rng.choice(["put", "put", "read", "touch", "reserve", "fill", "restore",
                         "drop", "save"])
        if op == "put":
            key = keys[int(rng.integers(len(keys)))]
            (jk, tk), (jv, tv) = (_block(rng, (G, bs, KVH, hd), dtype_name) for _ in range(2))
            (jks, jvs), (tks, tvs) = scales(None)
            a = js.put(key, jk, jv, owner=step % 3, k_scale=jks, v_scale=jvs)
            b = ts.put(key, tk, tv, owner=step % 3, k_scale=tks, v_scale=tvs)
        elif op == "read":
            resident = [k for k in keys if js.contains(k)]
            if not resident:
                continue
            pick = [resident[i] for i in rng.permutation(len(resident))[:2]]
            a = tuple(_jax_bits(x) for x in js.read(pick, owner=step % 3))
            b = tuple(_as_numpy(x) for x in ts.read(pick, owner=step % 3))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
            a = b = len(a)
        elif op == "touch":
            key = keys[int(rng.integers(len(keys)))]
            js.touch(key)
            ts.touch(key)
            a, b = js.contains(key), ts.contains(key)
        elif op in ("reserve", "save"):
            tag = tags[int(rng.integers(len(tags)))]
            if tag in js._swap:
                with pytest.raises(ValueError):
                    ts.reserve_seq(tag, 1)
                continue
            k = int(rng.integers(0, 9))       # 7 and 8 never fit in 6 slots
            if op == "reserve":
                a, b = js.reserve_seq(tag, k), ts.reserve_seq(tag, k)
            else:
                if k == 0:
                    continue
                (jk, tk), (jv, tv) = (_block(rng, (G, k, bs, KVH, hd), dtype_name)
                                      for _ in range(2))
                (jks, jvs), (tks, tvs) = scales(k)
                a = js.save_seq(tag, jk, jv, jks, jvs)
                b = ts.save_seq(tag, tk, tv, tks, tvs)
            refused += a is None or a is False
        elif op == "fill":
            live = [t for t in tags if t in js._swap]
            if not live:
                continue
            tag = live[0]
            k = js.saved_blocks(tag)
            (jk, tk), (jv, tv) = (_block(rng, (G, k, bs, KVH, hd), dtype_name)
                                  for _ in range(2))
            (jks, jvs), (tks, tvs) = scales(k)
            js.fill_seq(tag, jk, jv, jks, jvs)
            ts.fill_seq(tag, tk, tv, tks, tvs)
            a = b = k
        elif op == "restore":
            live = [t for t in tags if t in js._swap]
            if not live:
                continue
            a = tuple(_jax_bits(x) for x in js.restore_seq(live[-1]))
            b = tuple(_as_numpy(x) for x in ts.restore_seq(live[-1]))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
            a = b = len(a)
        else:
            tag = tags[int(rng.integers(len(tags)))]
            js.drop_seq(tag)
            ts.drop_seq(tag)
            a = b = None
        assert b == a, (step, op)
        assert _state(ts) == _state(js), (step, op)
        assert len(ts.free) + ts.n_keyed + ts.n_swapped == n
    # the run exercised what it is meant to: refusals, evictions, swaps
    st = ts.stats()
    assert refused > 0
    assert st["evictions"] > 0 and st["swap_outs"] > 0 and st["swap_ins"] > 0 and st["hits"] > 0
    np.testing.assert_array_equal(_as_numpy(ts.k), _jax_bits(js.k))
    np.testing.assert_array_equal(_as_numpy(ts.v), _jax_bits(js.v))
    if quant:
        np.testing.assert_array_equal(ts.k_scale.numpy(), js.k_scale)
        np.testing.assert_array_equal(ts.v_scale.numpy(), js.v_scale)


def test_host_store_for_config_mirrors_the_pool():
    cfg = smoke_variant(get_arch("smollm-135m"))
    jcfg = jax_smoke(jax_get_arch("smollm-135m"))
    for kv_dtype in (None, "int8"):
        ts = HostBlockStore.for_config(cfg, 5, 16, kv_dtype=kv_dtype)
        js = JaxStore.for_config(jcfg, 5, 16, kv_dtype=kv_dtype)
        assert tuple(ts.k.shape) == js.k.shape and ts.quantized == js.quantized
        assert ts.block_bytes == 2 * js.k[:, 0].nbytes + (
            2 * js.k_scale[:, 0].nbytes if js.quantized else 0)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, tree, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


def _pin_token_time(eng, value):
    """Hold the runner's per-token step time (the cost model's input) at
    ``value`` through the run."""
    runner = eng.runner
    orig = runner.materialize

    def materialize(ex):
        out = orig(ex)
        runner.token_time_ema = value
        return out

    runner.materialize = materialize
    runner.token_time_ema = value


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


def _long_decode_run(eng, seed):
    """The harness's long-decode workload (``_run_workload(long_decode=
    True)``), greedy: decodes outgrow admission's slack block on a tiny
    pool, so the pool runs dry mid-decode and preempts."""
    rng = np.random.default_rng(seed)
    plans = _capture_plans(eng)
    reqs = []
    for _ in range(4):
        for _ in range(int(rng.integers(1, 4))):
            prompt = rng.integers(0, 90, size=int(rng.integers(3, 13)))
            reqs.append(eng.submit(prompt, max_new=int(rng.integers(28, 39)),
                                   temperature=0.0, priority=float(rng.random())))
        for _ in range(int(rng.integers(0, 4))):
            eng.step()
    eng.run_until_done(max_steps=2000)
    return reqs, plans


_FIELDS = ("tokens", "starts", "temps", "tables", "prev_slots", "n_valid",
           "positions", "p_end", "s_start", "row_of", "slots", "decode_idx",
           "last_idx")

# (preempt, kv_dtype, seed, scheduler, pinned per-token seconds): the cost
# cases pick a mix of swaps and recomputes (float, seed 6), all recompute
# (float, seed 5) and all swap (int8, seed 5: half the bytes to copy)
CASES = [
    ("swap", None, 5, "fifo", None),
    ("swap", "int8", 6, "edf_slack", None),
    ("cost", None, 6, "edf_slack", 6e-7),
    ("cost", None, 5, "fifo", 3e-7),
    ("cost", "int8", 5, "fifo", 3e-7),
]


@pytest.fixture(scope="module")
def runs(weights):
    jcfg, _, jparams, tcfg, tparams = weights
    out = {}
    for case in CASES:
        preempt, kv_dtype, seed, scheduler, tok_s = case
        kw = dict(max_batch=3, max_seq=96, n_blocks=6, prefill_chunk_size=16,
                  token_budget=20, scheduler=scheduler, preempt=preempt, kv_dtype=kv_dtype)
        sides = []
        for eng in (JaxEngine(jcfg, params=jparams, kernel="pallas", **kw),
                    GenerationEngine(tcfg, params=tparams, device="cpu", **kw)):
            if tok_s is not None:
                _pin_token_time(eng, tok_s)
            sides.append((eng, *_long_decode_run(eng, seed)))
        out[case] = sides
    return out


_COUNTERS = ("steps", "preemptions", "swap_outs", "swap_ins", "swap_reshared_blocks",
             "cost_swap_choices", "cost_recompute_choices", "prefix_hit_tokens",
             "host_hit_tokens", "prefill_tokens", "tokens_out")


@pytest.mark.parametrize("case", CASES)
def test_swap_and_cost_engines_match_jax(runs, case):
    (jeng, jreqs, jplans), (teng, treqs, tplans) = runs[case]
    assert len(tplans) == len(jplans) > 0
    for jp, tp in zip(jplans, tplans):
        assert (tp.plan_id, tp.kind, tp.n_tokens) == (jp.plan_id, jp.kind, jp.n_tokens)
        for name in _FIELDS:
            a, b = getattr(jp, name), getattr(tp, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=f"plan {jp.plan_id} {name}")
    for a, b in zip(jreqs, treqs):
        assert b.out_tokens == a.out_tokens, (a.req_id, a.out_tokens, b.out_tokens)
    tst, jst = teng.stats(), jeng.stats()
    for key in _COUNTERS:
        assert tst[key] == jst[key], (key, tst[key], jst[key])
    assert tst["host_store"] == jst["host_store"]
    assert tst["kv_dtype"] == jst["kv_dtype"]
    assert tst["preemptions"] >= 1


@pytest.mark.parametrize("case", CASES)
def test_swap_and_cost_engines_drain_clean(runs, case):
    _, (eng, reqs, _) = runs[case]
    preempt, kv_dtype = case[0], case[1]
    assert all(r.done and len(r.out_tokens) == r.max_new for r in reqs)
    hs = eng.host_store
    assert hs is not None and hs.n_swapped == 0
    assert len(hs.free) + hs.n_keyed == hs.n_blocks
    assert eng.swap_ins == eng.swap_outs
    assert eng._copy.backlog == 0
    pool = eng.kv.pool
    assert pool.n_free == pool.n_blocks - 1
    assert pool.tables == {_NULL_SEQ: [eng._null_block]}
    assert eng.kv.lengths == {}
    assert eng.kv.quantized == (kv_dtype == "int8")
    if preempt == "swap":
        assert eng.swap_outs >= 1 and eng.swap_out_bytes > 0
        assert eng.swap_in_bytes + eng.swap_reshared_blocks * hs.block_bytes \
            == eng.swap_out_bytes


def test_cost_model_choices_follow_the_pinned_step_time(runs):
    """Float seed 5 at 3e-7 s a token: every victim recomputes; the same
    run on int8 pools (half the bytes to copy) swaps every victim; float
    seed 6 at 6e-7 s mixes both."""
    st = {case: runs[case][1][0].stats() for case in CASES if case[0] == "cost"}
    mixed, all_re, all_swap = (st[c] for c in CASES[2:])
    assert mixed["cost_swap_choices"] > 0 and mixed["cost_recompute_choices"] > 0
    assert all_re["cost_swap_choices"] == 0 and all_re["cost_recompute_choices"] > 0
    assert all_swap["cost_swap_choices"] > 0 and all_swap["cost_recompute_choices"] == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_warm_eviction_demotes_and_admission_promotes(weights, kv_dtype):
    """A document evicted from the warm pool LRU comes back as a host-tier
    hit: admission promotes its blocks (one copy, no prefill), the tokens
    equal the JAX engine's, and the promotion re-publishes the keys so a
    third request hits on the device."""
    jcfg, _, jparams, tcfg, tparams = weights
    ctx = np.arange(64) % 90
    out = []
    for make in (lambda **kw: JaxEngine(jcfg, params=jparams, kernel="pallas", **kw),
                 lambda **kw: GenerationEngine(tcfg, params=tparams, device="cpu", **kw)):
        eng = make(max_batch=1, max_seq=128, n_blocks=10, host_blocks=32, kv_dtype=kv_dtype)
        r1 = eng.submit(np.concatenate([ctx, [5]]), max_new=2)
        eng.run_until_done()
        puts0 = eng.host_store.puts
        for i in range(3):   # fresh prompts until the ctx blocks are reclaimed
            eng.submit(np.arange(40) % 90 + 100 + 17 * i, max_new=2)
            eng.run_until_done()
        puts1 = eng.host_store.puts
        before = eng.prefill_tokens
        r2 = eng.submit(np.concatenate([ctx, [6]]), max_new=3)
        eng.run_until_done()
        r3 = eng.submit(np.concatenate([ctx, [7]]), max_new=2)
        eng.run_until_done()
        out.append(dict(
            puts=(puts0, puts1), prefill=eng.prefill_tokens - before,
            r2=(r2.host_prefix_tokens, r2.shared_prefix_tokens, r2.out_tokens),
            r3=(r3.host_prefix_tokens, r3.shared_prefix_tokens, r3.out_tokens),
            r1=r1.out_tokens, host=eng.host_store.stats(),
            rates=(eng.latency_summary()["host_hit_rate"], eng.measured_host_hit_rate(
                min_tokens=1))))
    jax_side, port = out
    assert port == jax_side
    assert port["puts"][0] == 0 and port["puts"][1] > 0      # demoted on eviction
    host, shared = port["r2"][:2]
    assert host > 0 and host + shared >= 48                  # promoted, not prefilled
    assert port["r3"][0] == 0 and port["r3"][1] >= 48        # device hit after promotion
    assert port["rates"][0] > 0
