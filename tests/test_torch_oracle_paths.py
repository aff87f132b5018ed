"""The paged engine's oracle paths in the port against the JAX package on the
CPU.

* The functions the oracle steps run, on the same seeded numpy inputs:
  the chunk writes and gathers of ``serving.paged_cache`` (float pools bit
  for bit, int8 pools through ``_quantized_scatter`` bit for bit, padding
  rows routed to the scratch block, -1 table entries), ``paged_validity``,
  ``models.attention.chunk_decode_attention`` and ``models.prefill_chunk``
  (per-row starts, segmented spans, the pad-vocab bias) within
  ``tests/test_kernel_conformance.py``'s ``TOL``; the int8 views within its
  ``QTOL`` of the float ones.
* The engine under ``interleave=False`` (recompute and swap),
  ``ragged=False, kernel="reference"`` and ``kernel="reference"`` on the
  invariant harness's workloads (``tests/test_engine_invariants.py``,
  seeds 2, 3 and 5), against the JAX engine with the same settings and
  weights: identical StepPlans, greedy tokens and counters, and a pool that
  drains clean.
* The ragged <-> padded round trip of ``tests/test_engine_invariants.py``
  within the port, and ``kernel="reference"`` token-identical to
  ``kernel="pallas"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_params as jax_init_params
from repro.models import prefill_chunk as jax_prefill_chunk
from repro.models.attention import chunk_decode_attention as jax_chunk_attention
from repro.serving import paged_cache as jpc
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models import prefill_chunk
from repro_torch.models.attention import chunk_decode_attention
from repro_torch.params import params_from_numpy, torch_dtype
from repro_torch.serving import paged_cache as tpc
from repro_torch.serving.control_plane import padded_plan_difference
from repro_torch.serving.engine import _NULL_SEQ, GenerationEngine
from torch_harness import bursty_workload, record_plans

torch.set_num_threads(1)

# as tests/test_kernel_conformance.py
TOL = dict(rtol=2e-5, atol=2e-5)
QTOL = dict(rtol=0.05, atol=0.08)

G, NB, BS, KVH, HD = 2, 12, 4, 2, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _float_pool(rng):
    return rng.standard_normal((G, NB, BS, KVH, HD)).astype(np.float32)


def _int8_pool(rng):
    codes = rng.integers(-127, 128, (G, NB, BS, KVH, HD)).astype(np.int8)
    scales = rng.uniform(0.0, 0.02, (G, NB, KVH)).astype(np.float32)
    scales[:, 3] = 0.0                     # a freshly reset block
    return codes, scales


def _row(rng, n_backed, mb):
    row = np.full((mb,), -1, np.int32)
    row[:n_backed] = rng.permutation(np.arange(1, NB))[:n_backed]
    return row


def _tables(rng, n_backed, mb):
    ids = rng.permutation(np.arange(1, NB))
    tables = np.full((len(n_backed), mb), -1, np.int32)
    off = 0
    for b, n in enumerate(n_backed):
        tables[b, :n] = ids[off:off + n] if off + n <= len(ids) else ids[:n]
        off += n
    return tables


# ------------------------------------------------------------ pool writes
@pytest.mark.parametrize("pos", [0, 5, 11])
def test_write_paged_matches_jax(pos):
    rng = np.random.default_rng(pos)
    pool, row = _float_pool(rng), _row(rng, 3, 5)
    new = rng.standard_normal((G, KVH, HD)).astype(np.float32)
    want = jpc.write_paged(jnp.asarray(pool), jnp.asarray(row), pos, jnp.asarray(new), BS)
    got = tpc.write_paged(_t(pool), _t(row), pos, _t(new), BS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start,n_valid", [(0, None), (2, 3), (5, 7), (8, 0)])
def test_write_paged_chunk_matches_jax(start, n_valid):
    rng = np.random.default_rng(10 + start)
    pool, row, C = _float_pool(rng), _row(rng, 3, 5), 7
    new = rng.standard_normal((G, C, KVH, HD)).astype(np.float32)
    want = jpc.write_paged_chunk(jnp.asarray(pool), jnp.asarray(row), start,
                                 jnp.asarray(new), BS, n_valid, 0)
    got = tpc.write_paged_chunk(_t(pool), _t(row), start, _t(new), BS, n_valid, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batch_case(seed):
    """Three rows: a prefill chunk across blocks, a decode row (one valid
    token), a padding row (no valid token); tables with -1 tails."""
    rng = np.random.default_rng(seed)
    C, mb = 6, 5
    tables = _tables(rng, [3, 2, 1], mb)
    starts = np.array([1, 6, 0], np.int32)
    n_valid = np.array([6, 1, 0], np.int32)
    new = rng.standard_normal((G, 3, C, KVH, HD)).astype(np.float32)
    return rng, tables, starts, n_valid, new


@pytest.mark.parametrize("masked", [False, True])
def test_write_paged_chunk_batch_matches_jax(masked):
    rng, tables, starts, n_valid, new = _batch_case(20)
    pool = _float_pool(rng)
    nv = n_valid if masked else None
    want = jpc.write_paged_chunk_batch(jnp.asarray(pool), jnp.asarray(tables),
                                       jnp.asarray(starts), jnp.asarray(new), BS,
                                       None if nv is None else jnp.asarray(nv), 0)
    got = tpc.write_paged_chunk_batch(_t(pool), _t(tables), _t(starts), _t(new), BS,
                                      None if nv is None else _t(nv), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start,n_valid", [(0, None), (2, 5), (9, 1)])
def test_write_paged_chunk_q_is_bit_exact(start, n_valid):
    rng = np.random.default_rng(30 + start)
    (codes, scales), row, C = _int8_pool(rng), _row(rng, 4, 5), 6
    new = (rng.standard_normal((G, C, KVH, HD)) * 0.8).astype(np.float32)
    new[0, 0, 0, :2] = [1.27, -2.54]        # exact .5 ties after scaling
    wp, ws = jpc.write_paged_chunk_q(jnp.asarray(codes), jnp.asarray(scales),
                                     jnp.asarray(row), start, jnp.asarray(new), BS,
                                     n_valid, 0)
    pool_in, sc_in = _t(codes), _t(scales)
    gp, gs = tpc.write_paged_chunk_q(pool_in, sc_in, _t(row), start, _t(new), BS, n_valid, 0)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # new tensors, as the JAX function returns: the inputs are untouched
    np.testing.assert_array_equal(pool_in.numpy(), codes)
    np.testing.assert_array_equal(sc_in.numpy(), scales)


def test_write_paged_chunk_batch_q_is_bit_exact():
    rng, tables, starts, n_valid, new = _batch_case(40)
    codes, scales = _int8_pool(rng)
    wp, ws = jpc.write_paged_chunk_batch_q(jnp.asarray(codes), jnp.asarray(scales),
                                           jnp.asarray(tables), jnp.asarray(starts),
                                           jnp.asarray(new), BS, jnp.asarray(n_valid), 0)
    gp, gs = tpc.write_paged_chunk_batch_q(_t(codes), _t(scales), _t(tables), _t(starts),
                                           _t(new), BS, _t(n_valid), 0)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ---------------------------------------------------------------- gathers
def test_gathers_and_validity_match_jax():
    rng = np.random.default_rng(50)
    pool = _float_pool(rng)
    codes, scales = _int8_pool(rng)
    row = _row(rng, 3, 5)
    row[1] = -1                                        # an interior hole
    tables = _tables(rng, [3, 1, 0], 5)
    jp, tp = jnp.asarray(pool), _t(pool)
    np.testing.assert_array_equal(tpc.gather_paged(tp, _t(row), 4).numpy(),
                                  np.asarray(jpc.gather_paged(jp, jnp.asarray(row), 4)))
    np.testing.assert_array_equal(tpc.gather_paged_batch(tp, _t(tables)).numpy(),
                                  np.asarray(jpc.gather_paged_batch(jp, jnp.asarray(tables))))
    for sc in (None, scales):
        src = pool if sc is None else codes
        want = jpc.gather_paged_dq(jnp.asarray(src), None if sc is None else jnp.asarray(sc),
                                   jnp.asarray(row), 5)
        got = tpc.gather_paged_dq(_t(src), None if sc is None else _t(sc), _t(row), 5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = jpc.gather_paged_batch_dq(jnp.asarray(src), None if sc is None
                                         else jnp.asarray(sc), jnp.asarray(tables))
        got = tpc.gather_paged_batch_dq(_t(src), None if sc is None else _t(sc), _t(tables))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for length in (0, 5, 9, 20):
        np.testing.assert_array_equal(
            tpc.paged_validity(_t(row), length, BS, 5).numpy(),
            np.asarray(jpc.paged_validity(jnp.asarray(row), length, BS, 5)))


# ------------------------------------------------- the per-sequence API
def _np32(a):
    """A pool, scale pool or view of either package as float32 numpy (bf16
    widens exactly; int8 codes compare as their values)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _same_cache_state(jkv, tkv, seqs):
    """Pools, scale pools, tables, refcounts, free blocks and lengths bit
    for bit, and each live sequence's view and validity."""
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(jkv, name), getattr(tkv, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert str(b.dtype).split(".")[-1] == str(a.dtype), (name, b.dtype, a.dtype)
            np.testing.assert_array_equal(_np32(b), _np32(a), err_msg=name)
    assert tkv.pool.tables == jkv.pool.tables
    assert tkv.pool.refcounts == jkv.pool.refcounts
    assert tkv.pool.free_list == jkv.pool.free_list
    assert list(tkv.pool.cached) == list(jkv.pool.cached)
    assert tkv.lengths == jkv.lengths
    for seq in seqs:
        for name, a, b in zip(("k", "v", "valid"), jkv.sequence_view(seq),
                              tkv.sequence_view(seq)):
            assert str(b.dtype).split(".")[-1] == str(a.dtype), (name, b.dtype, a.dtype)
            np.testing.assert_array_equal(_np32(b), _np32(a), err_msg=f"seq {seq} {name}")


@pytest.mark.parametrize("dtype,kv_dtype", [("float32", None), ("bfloat16", None),
                                            ("float32", "int8")])
def test_per_sequence_api_matches_jax(dtype, kv_dtype):
    """``PagedKVCache``'s per-sequence API against JAX's on the same calls:
    two sequences admitted (prompt + one block of slack), prefilled, and
    decoded token by token past their reservation (``extend_for`` adds a
    block), a release whose blocks the other sequence's next block and a
    later admission reuse (an int8 pool resets their scales), and an
    admission refused for want of blocks. After each stage the pools, scales, tables,
    refcounts, free list, lengths and every live view are bit for bit."""
    jcfg = jax_smoke(jax_get_arch("smollm-135m")).replace(dtype=dtype)
    tcfg = smoke_variant(get_arch("smollm-135m")).replace(dtype=dtype)
    n_blocks, bs, mb = 12, 4, 6
    jkv = jpc.PagedKVCache(jcfg, n_blocks, bs, mb, kv_dtype=kv_dtype)
    tkv = tpc.PagedKVCache(tcfg, n_blocks, bs, mb, device="cpu", kv_dtype=kv_dtype)
    shape = (tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim)
    rng = np.random.default_rng(70)

    def entries(n):
        """k and v for n positions, (G, n, KVH, hd); a wide spread of
        magnitudes so the running-max scales move."""
        kv = rng.standard_normal((2, shape[0], n, *shape[1:])) * rng.uniform(0.1, 4.0, (1, 1, n, 1, 1))
        return kv.astype(np.float32)

    def both(op, *args):
        """The same call on both caches (arrays in the model's dtype); their
        answers must agree."""
        jout = getattr(jkv, op)(*(jnp.asarray(a, jcfg.dtype) if isinstance(a, np.ndarray)
                                  else a for a in args))
        tout = getattr(tkv, op)(*(torch.from_numpy(a).to(torch_dtype(tcfg))
                                  if isinstance(a, np.ndarray) else a for a in args))
        assert tout == jout, (op, args[0], tout, jout)

    both("admit", 1, 6)                  # 10 slots reserved: 3 blocks
    both("admit", 2, 9)                  # 13: 4 blocks
    for seq, n in ((1, 6), (2, 9)):
        k, v = entries(n)
        both("write_prefill", seq, k, v)
    _same_cache_state(jkv, tkv, (1, 2))
    for step in range(8):                # seq 1 to 14 (a 4th block at 12),
        for seq in (1, 2):               # seq 2 to 17 (a 5th at 16)
            k, v = entries(1)
            both("write_token", seq, k[:, 0], v[:, 0])
        if step in (5, 7):
            _same_cache_state(jkv, tkv, (1, 2))
    assert len(tkv.pool.tables[1]) == 4 and len(tkv.pool.tables[2]) == 5
    freed = list(tkv.pool.tables[1])
    both("release", 1)
    for _ in range(4):                   # seq 2 to 21: its 6th block at 20 is
        k, v = entries(1)                # one seq 1 wrote
        both("write_token", 2, k[:, 0], v[:, 0])
    assert tkv.pool.tables[2][-1] in freed
    both("admit", 3, 11)                 # 15 slots: 4 blocks, seq 1's others
    k, v = entries(11)
    both("write_prefill", 3, k, v)
    for _ in range(2):
        k, v = entries(1)
        both("write_token", 3, k[:, 0], v[:, 0])
    both("admit", 4, 20)                 # refused: 24 slots, 2 blocks free
    _same_cache_state(jkv, tkv, (2, 3))
    both("release", 2)
    both("release", 3)
    assert tkv.pool.n_free == n_blocks
    _same_cache_state(jkv, tkv, ())


# ---------------------------------------------------------- chunk attention
def _spans_mask(rng, B, C, Sc, starts):
    """Per-query masks as the engine builds them: causal over slots, with
    a segmented row (prelude end + own segment start)."""
    s = np.arange(Sc)[None, None]
    slots = starts[:, None] + np.arange(C)[None]
    p_end = np.zeros((B, C), np.int32)
    s_start = np.zeros((B, C), np.int32)
    p_end[0] = 3
    s_start[0] = max(int(starts[0]) - 1, 0)
    valid = (s < p_end[:, :, None]) | ((s >= s_start[:, :, None]) & (s <= slots[:, :, None]))
    return valid, p_end, s_start


@pytest.mark.parametrize("seed,H,kvh", [(0, 4, 2), (1, 4, 1), (2, 2, 2)])
def test_chunk_decode_attention_matches_jax(seed, H, kvh):
    rng = np.random.default_rng(seed)
    B, C, Sc, hd = 3, 5, 24, 16
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sc, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sc, kvh, hd)).astype(np.float32)
    valid, _, _ = _spans_mask(rng, B, C, Sc, np.array([6, 0, 17]))
    want = jax_chunk_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid))
    got = chunk_decode_attention(_t(q), _t(k), _t(v), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunk_attention_over_int8_views_within_qtol():
    """The oracle steps' read of an int8 pool (dequantizing gather, then
    the masked softmax) against JAX on the same codes (TOL), and within the
    quantization budget (QTOL) of the float values the codes came from."""
    rng = np.random.default_rng(60)
    B, C, mb = 2, 4, 3
    pool = rng.standard_normal((G, NB, BS, KVH, HD)).astype(np.float32)
    scales = np.abs(pool).max(axis=(2, 4)) / 127.0                       # (G, NB, KVH)
    codes = np.clip(np.round(pool / scales[:, :, None, :, None]), -127, 127).astype(np.int8)
    tables = _tables(rng, [3, 2], mb)
    q = rng.standard_normal((B, C, 2 * KVH, HD)).astype(np.float32)
    valid, _, _ = _spans_mask(rng, B, C, mb * BS, np.array([5, 2]))
    valid &= (tables.repeat(BS, axis=1) >= 0)[:, None, :]
    view = tpc.gather_paged_batch_dq(_t(codes), _t(scales), _t(tables))[0]
    got = chunk_decode_attention(_t(q), view, view, _t(valid))
    jview = jpc.gather_paged_batch_dq(jnp.asarray(codes), jnp.asarray(scales),
                                      jnp.asarray(tables))[0]
    want = jax_chunk_attention(jnp.asarray(q), jview, jview, jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fview = jpc.gather_paged_batch(jnp.asarray(pool), jnp.asarray(tables))[0]
    exact = jax_chunk_attention(jnp.asarray(q), fview, fview, jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(exact), **QTOL)


# --------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, tree, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


@pytest.mark.parametrize("case", ["per_row", "scalar", "segmented", "pad_vocab"])
def test_prefill_chunk_matches_jax(weights, case):
    jcfg, tree, jparams, tcfg, tparams = weights
    if case == "pad_vocab":   # logical vocab below the 128-padded table: -1e30 there
        jcfg, tcfg = jcfg.replace(vocab_size=500), tcfg.replace(vocab_size=500)
    rng = np.random.default_rng({"per_row": 0, "scalar": 1, "segmented": 2, "pad_vocab": 3}[case])
    L, B, C, Sc = jcfg.num_layers, 3, 8, 40
    kvh, hd = jcfg.num_kv_heads, jcfg.head_dim
    k = rng.standard_normal((L, B, Sc, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, Sc, kvh, hd)).astype(np.float32)
    tokens = rng.integers(0, 500, (B, C)).astype(np.int32)
    extra = ()
    if case == "scalar":
        pos = 9
        starts = np.full((B,), pos, np.int32)
    else:
        starts = np.array([0, 13, 30], np.int32)
        pos = starts
    if case == "segmented":
        _, p_end, s_start = _spans_mask(rng, B, C, Sc, starts)
        positions = (starts[:, None] + np.arange(C)[None]).astype(np.int32)
        positions[0] -= 2                  # rope positions decoupled from slots
        extra = (positions, p_end, s_start)
    jpos = pos if np.ndim(pos) == 0 else jnp.asarray(pos)
    want_logits, want_caches = jax_prefill_chunk(
        jcfg, jparams, ({"k": jnp.asarray(k), "v": jnp.asarray(v)},), jnp.asarray(tokens),
        jpos, *(jnp.asarray(a) for a in extra))
    tpos = pos if np.ndim(pos) == 0 else _t(pos)
    logits, caches = prefill_chunk(tcfg, tparams, ({"k": _t(k), "v": _t(v)},), _t(tokens),
                                   tpos, *(_t(a) for a in extra))
    assert tuple(logits.shape) == (B, C, tcfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(caches[0][name].numpy(), np.asarray(want_caches[0][name]),
                                   **TOL)
    if case == "pad_vocab":
        assert bool((logits[..., 500:] < -1e29).all())


# -------------------------------------------------------------- the engine
def _workload(eng, seed, long_decode):
    """The harness's bursty workload, greedy, and the plans it builds."""
    plans = record_plans(eng)
    return bursty_workload(eng, seed, long_decode), plans


MODES = {
    "sequential": dict(interleave=False, kernel="reference"),
    "sequential_pallas": dict(interleave=False, kernel="pallas"),
    "padded": dict(ragged=False, kernel="reference"),
    "reference": dict(kernel="reference"),
}
# (mode, seed, n_blocks, long_decode, preempt): seed 2 backpressures on 8
# blocks, seed 3 is the harness's sequential case, seed 5's long decodes run
# a 6-block pool dry (preemption)
CASES = [
    ("sequential", 2, 8, False, "recompute"),
    ("sequential", 3, 8, False, "recompute"),
    ("sequential", 5, 6, True, "recompute"),
    ("sequential_pallas", 5, 6, True, "swap"),
    ("padded", 2, 8, False, "recompute"),
    ("padded", 3, 8, False, "recompute"),
    ("padded", 5, 6, True, "swap"),
    ("reference", 2, 8, False, "recompute"),
    ("reference", 3, 8, False, "recompute"),
    ("reference", 5, 6, True, "swap"),
]


@pytest.fixture(scope="module")
def runs(weights):
    jcfg, _, jparams, tcfg, tparams = weights
    out = {}
    for case in CASES:
        mode, seed, nb, long_decode, preempt = case
        kw = dict(max_batch=3, max_seq=96, n_blocks=nb, prefill_chunk_size=16,
                  token_budget=20, scheduler="fifo", preempt=preempt, **MODES[mode])
        out[case] = [(eng, *_workload(eng, seed, long_decode)) for eng in (
            JaxEngine(jcfg, params=jparams, **kw),
            GenerationEngine(tcfg, params=tparams, device="cpu", **kw))]
    return out


_FIELDS = ("tokens", "starts", "temps", "tables", "prev_slots", "n_valid",
           "positions", "p_end", "s_start", "row_of", "slots", "decode_idx",
           "last_idx")
_COUNTERS = ("steps", "preemptions", "swap_outs", "swap_ins", "swap_reshared_blocks",
             "prefix_hit_tokens", "host_hit_tokens", "prefill_tokens", "tokens_out",
             "fused_slot_tokens", "fused_valid_tokens", "interleave", "ragged")


@pytest.mark.parametrize("case", CASES)
def test_oracle_engine_matches_jax(runs, case):
    (jeng, jreqs, jplans), (teng, treqs, tplans) = runs[case]
    assert len(tplans) == len(jplans)
    kinds = {p.kind for p in tplans}
    if case[0].startswith("sequential"):
        assert not teng.interleave and not tplans     # no control-plane plans
    else:
        assert kinds == {"fused" if case[0] == "padded" else "ragged", "decode"}
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
    assert tst["kernel_impl"] == jst["kernel"] == MODES[case[0]]["kernel"]
    assert tst["kernel"] == "plain"
    if case[2] == 6:
        assert tst["preemptions"] >= 1
    if case[4] == "swap":
        assert tst["swap_outs"] >= 1 and tst["host_store"] == jst["host_store"]


@pytest.mark.parametrize("case", CASES)
def test_oracle_engine_drains_clean(runs, case):
    _, (eng, reqs, _) = runs[case]
    assert all(r.done and (r.truncated or len(r.out_tokens) == r.max_new) for r in reqs)
    assert not eng.waiting and not any(eng.slots)
    pool = eng.kv.pool
    assert pool.n_free == pool.n_blocks - 1
    assert pool.tables == {_NULL_SEQ: [eng._null_block]}
    assert pool.refcounts == {eng._null_block: 1}
    assert eng.kv.lengths == {}
    assert eng._copy.backlog == 0
    if eng.host_store is not None:
        assert eng.host_store.n_swapped == 0 and eng.swap_ins == eng.swap_outs


# -------------------------------------------------- layouts within the port
@pytest.mark.parametrize("seed,n_blocks", [(0, None), (2, 8)])
def test_ragged_plan_round_trips_to_padded_layout(weights, seed, n_blocks):
    """The packed layout re-encodes the padded one: unpacking every ragged
    StepPlan gives the padded plan's rows, starts and n_valid step for step,
    and the tokens are identical."""
    tcfg, tparams = weights[3], weights[4]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 90, size=int(rng.integers(3, 40))) for _ in range(6)]
    max_new = [int(rng.integers(2, 9)) for _ in prompts]

    def run(**kw):
        eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=3, max_seq=96,
                               n_blocks=n_blocks, prefill_chunk_size=16, token_budget=20, **kw)
        plans = record_plans(eng)
        reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, max_new)]
        eng.run_until_done(max_steps=1000)
        return eng, reqs, plans

    rag_eng, rag_reqs, rag_plans = run()
    pad_eng, pad_reqs, pad_plans = run(ragged=False, kernel="reference")
    assert len(rag_plans) == len(pad_plans)
    saw_mixed = False
    for rp, fp in zip(rag_plans, pad_plans):
        diff = padded_plan_difference(rp, fp)
        assert diff is None, diff
        if fp.kind == "decode":
            continue
        saw_mixed = True
        assert rp.tokens.shape[0] <= fp.tokens.size
        assert rp.tokens.shape[0] % rag_eng.pack_align == 0
    assert saw_mixed
    for a, b in zip(rag_reqs, pad_reqs):
        assert a.out_tokens == b.out_tokens, (a.req_id, a.out_tokens, b.out_tokens)
    assert rag_eng.stats()["padded_token_fraction"] < pad_eng.stats()["padded_token_fraction"]


@pytest.mark.parametrize("seed,n_blocks,long_decode,preempt",
                         [(0, None, False, "recompute"), (2, 8, False, "recompute"),
                          (5, 6, True, "swap"), (6, 6, True, "recompute")])
def test_reference_kernel_matches_pallas_within_the_port(weights, seed, n_blocks,
                                                         long_decode, preempt):
    """On float pools the gather oracles and the kernel wrappers give the
    same greedy tokens and the same plan sequence."""
    tcfg, tparams = weights[3], weights[4]
    out = []
    for kernel in ("pallas", "reference"):
        eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=3, max_seq=96,
                               n_blocks=n_blocks, prefill_chunk_size=16, token_budget=20,
                               preempt=preempt, kernel=kernel)
        reqs, plans = _workload(eng, seed, long_decode)
        out.append(([r.out_tokens for r in reqs], [(p.kind, p.n_tokens) for p in plans],
                    eng.stats()["kernel_impl"]))
    (pal_tok, pal_plans, pal_k), (ref_tok, ref_plans, ref_k) = out
    assert (pal_k, ref_k) == ("pallas", "reference")
    assert pal_tok == ref_tok and pal_plans == ref_plans


def test_pallas_kernel_requires_the_ragged_layout(weights):
    tcfg = weights[3]
    with pytest.raises(ValueError, match="ragged"):
        GenerationEngine(tcfg, device="cpu", ragged=False)
    with pytest.raises(ValueError, match="unknown kernel"):
        GenerationEngine(tcfg, device="cpu", kernel="mosaic-gpu")
    eng = GenerationEngine(tcfg, device="cpu", ragged=False, kernel="reference")
    assert eng.warmup_step_variants() == 0 and not eng.ragged
