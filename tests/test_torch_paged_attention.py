"""The port's paged attention against the JAX package: the plain PyTorch
versions (what the CPU wrappers run, and the yardstick the CUDA kernels are
held to on the card) against the Pallas kernels in interpret mode and
against the JAX gather oracles, on seeded ragged geometry — RAW -1 holes,
packed pad tokens, segmented spans, G in {1, 2, 4}, non-power-of-two block
counts, int8 pools with scales — and the packed pool scatter, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jka
from repro.serving.paged_cache import write_paged_packed as jax_write_packed
from repro_torch.kernels import decode_attention as tka
from repro_torch.serving.paged_cache import write_paged_packed

torch.set_num_threads(1)

# as tests/test_kernel_conformance.py: f32, summation order differs
TOL = dict(rtol=2e-5, atol=2e-5)


def _pools(rng, n_blocks, bs, kvh, hd, int8):
    if int8:
        k = rng.integers(-127, 128, (n_blocks, bs, kvh, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (n_blocks, bs, kvh, hd)).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (n_blocks, kvh)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (n_blocks, kvh)).astype(np.float32)
        return k, v, ks, vs
    k = rng.standard_normal((n_blocks, bs, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, kvh, hd)).astype(np.float32)
    return k, v, None, None


def _tables(rng, lengths, bs, mb, n_blocks, holes):
    tables = np.full((len(lengths), mb), -1, np.int32)
    free = list(rng.permutation(n_blocks))
    for b, ln in enumerate(lengths):
        need = -(-int(ln) // bs)
        for j in range(need):
            tables[b, j] = free.pop()
        if holes and need > 2:  # interior unbacked page below the length
            tables[b, rng.integers(1, need - 1)] = -1
    return tables


def _both(*arrays):
    """numpy -> (jax tuple, torch tuple); None passes through."""
    j = tuple(None if a is None else jnp.asarray(a) for a in arrays)
    t = tuple(None if a is None else torch.from_numpy(np.array(a)) for a in arrays)
    return j, t


DECODE_CASES = [
    # (seed, B, kvh, g, hd, bs, mb, n_blocks, holes, int8)
    (0, 3, 2, 1, 32, 8, 5, 15, False, False),
    (1, 3, 1, 4, 64, 16, 3, 11, True, False),
    (3, 2, 2, 2, 32, 8, 5, 13, True, True),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax(case):
    seed, B, kvh, g, hd, bs, mb, n_blocks, holes, int8 = case
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, mb * bs + 1, size=B).astype(np.int32)
    k, v, ks, vs = _pools(rng, n_blocks, bs, kvh, hd, int8)
    tables = _tables(rng, lengths, bs, mb, n_blocks, holes)
    q = rng.standard_normal((B, kvh * g, hd)).astype(np.float32)
    (jq, jk, jv, jt, jl, jks, jvs), (tq, tk, tv, tt, tl, tks, tvs) = _both(
        q, k, v, tables, lengths, ks, vs)
    got = tka.paged_decode_attention(tq, tk, tv, tt, tl, k_scale=tks, v_scale=tvs)
    pallas = jka.paged_decode_attention(jq, jk, jv, jt, jl, k_scale=jks,
                                        v_scale=jvs, interpret=True)
    oracle = jka.ref_paged_decode_attention(jq, jk, jv, jt, jl, k_scale=jks,
                                            v_scale=jvs)
    assert got.shape == (B, kvh * g, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


def _chunk_arrays(rng, B, bs, mb, pad_tokens, segmented):
    lengths = rng.integers(1, mb * bs + 1, size=B).astype(np.int32)
    row_of, slots, p_end, s_start = [], [], [], []
    for b, ln in enumerate(lengths):
        if rng.random() < 0.4 or ln < 3:          # decode row: one token
            row_of.append(b)
            slots.append(int(ln) - 1)
            p_end.append(0)
            s_start.append(0)
            continue
        c = int(rng.integers(1, min(int(ln), 6) + 1))
        p0 = int(ln) - c
        for s in range(p0, p0 + c):
            row_of.append(b)
            slots.append(s)
            if segmented and p0 > 1:
                pe = int(rng.integers(1, p0 + 1))
                p_end.append(pe)
                s_start.append(int(rng.integers(pe, s + 1)))
            else:
                p_end.append(0)
                s_start.append(0)
    for _ in range(pad_tokens):
        row_of.append(-1)
        slots.append(0)
        p_end.append(0)
        s_start.append(0)
    mk = lambda xs: np.asarray(xs, np.int32)
    return lengths, mk(row_of), mk(slots), mk(p_end), mk(s_start)


CHUNK_CASES = [
    # (seed, B, kvh, g, hd, bs, mb, n_blocks, pad_tokens, segmented, holes, int8)
    (0, 3, 2, 1, 32, 8, 5, 15, 0, False, False, False),
    (1, 3, 1, 4, 64, 16, 3, 11, 3, False, True, False),
    (3, 3, 2, 2, 32, 8, 5, 17, 1, True, True, False),
    (4, 2, 2, 2, 32, 8, 5, 11, 2, True, False, True),
]


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_plain_matches_jax(case):
    seed, B, kvh, g, hd, bs, mb, n_blocks, pads, seg, holes, int8 = case
    rng = np.random.default_rng(seed)
    lengths, row_of, slots, p_end, s_start = _chunk_arrays(rng, B, bs, mb, pads, seg)
    k, v, ks, vs = _pools(rng, n_blocks, bs, kvh, hd, int8)
    tables = _tables(rng, lengths, bs, mb, n_blocks, holes)
    if holes:
        # a token's own slot must stay backed: re-back any hole a token sits in
        for t in np.nonzero(row_of >= 0)[0]:
            j = slots[t] // bs
            if tables[row_of[t], j] < 0:
                tables[row_of[t], j] = tables[row_of[t], 0]
    T = len(row_of)
    q = rng.standard_normal((T, kvh * g, hd)).astype(np.float32)
    args = (q, k, v, tables, row_of, slots, p_end, s_start, ks, vs)
    (jq, jk, jv, jt, jr, jsl, jpe, jss, jks, jvs), \
        (tq, tk, tv, tt, tr, tsl, tpe, tss, tks, tvs) = _both(*args)
    got = tka.paged_chunk_attention(tq, tk, tv, tt, tr, tsl, tpe, tss,
                                    k_scale=tks, v_scale=tvs).numpy()
    pallas = np.asarray(jka.paged_chunk_attention(
        jq, jk, jv, jt, jr, jsl, jpe, jss, k_scale=jks, v_scale=jvs,
        interpret=True))
    oracle = np.asarray(jka.ref_paged_chunk_attention(
        jq, jk, jv, jt, jr, jsl, jpe, jss, k_scale=jks, v_scale=jvs))
    valid = row_of >= 0
    np.testing.assert_allclose(got[valid], pallas[valid], **TOL)
    np.testing.assert_allclose(got[valid], oracle[valid], **TOL)
    # pad tokens: zeros, as the CUDA kernel writes them
    assert np.all(got[~valid] == 0.0)


def test_plain_versions_keep_bf16():
    """bf16 q and pools: output dtype follows q, values track the f32 run
    within bf16 rounding (probabilities are cast to bf16 before the value
    product, as in the JAX oracles)."""
    rng = np.random.default_rng(7)
    lengths, row_of, slots, p_end, s_start = _chunk_arrays(rng, 3, 8, 5, 2, True)
    k, v, _, _ = _pools(rng, 13, 8, 2, 32, False)
    tables = _tables(rng, lengths, 8, 5, 13, False)
    q = rng.standard_normal((len(row_of), 4, 32)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    f32 = tka.paged_chunk_attention(t(q), t(k), t(v), t(tables), t(row_of),
                                    t(slots), t(p_end), t(s_start))
    bf = tka.paged_chunk_attention(
        t(q).bfloat16(), t(k).bfloat16(), t(v).bfloat16(), t(tables),
        t(row_of), t(slots), t(p_end), t(s_start))
    assert bf.dtype == torch.bfloat16
    # 2e-2: bf16 inputs, bf16 probabilities and a bf16 output rounding
    np.testing.assert_allclose(bf.float().numpy(), f32.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_paged_packed_matches_jax_bit_exact(seed):
    rng = np.random.default_rng(seed)
    n_blocks, bs, kvh, hd, mb, null = 11, 8, 2, 16, 4, 0
    lengths, row_of, slots, _, _ = _chunk_arrays(rng, 3, bs, mb, 3, False)
    tables = _tables(rng, lengths, bs, mb, n_blocks, holes=False)
    tables[tables == null] = n_blocks - 1 if n_blocks - 1 not in tables else -1
    # one unbacked destination: a token whose block entry is -1
    b0 = int(row_of[0])
    tables_raw = tables.copy()
    tables_raw[b0, slots[0] // bs] = -1
    pool = rng.standard_normal((n_blocks, bs, kvh, hd)).astype(np.float32)
    new = rng.standard_normal((len(row_of), kvh, hd)).astype(np.float32)
    want = np.asarray(jax_write_packed(
        jnp.asarray(pool), jnp.asarray(tables_raw), jnp.asarray(row_of),
        jnp.asarray(slots), jnp.asarray(new), bs, null))
    got_t = torch.from_numpy(pool.copy())
    out = write_paged_packed(got_t, torch.from_numpy(tables_raw),
                             torch.from_numpy(row_of), torch.from_numpy(slots),
                             torch.from_numpy(new), bs, null)
    assert out is got_t  # in place
    got = got_t.numpy()
    # every block but the scratch block is bit-identical; racy duplicate
    # writes (pad tokens, unbacked entries) only ever land in the scratch
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_array_equal(got[null, 1:], pool[null, 1:])


# (SMs, B, KVH, slots): the paged serve's decode on the H100 (B 8, KVH 2, 128
# blocks of 16), hymba's 1024-slot ring (KVH 5), short and ragged rows, many
# rows, one very long row, a card of one SM
SPLIT_CASES = [(132, 8, 2, 2048), (132, 8, 5, 1024), (132, 8, 2, 300), (132, 8, 2, 16),
               (132, 8, 2, 2200), (132, 64, 8, 2048), (132, 1, 1, 100000), (1, 1, 1, 17)]


def _check_split(sms, B, KVH, slots):
    n_split, chunk = tka.decode_split(sms, B, KVH, slots)
    assert n_split >= 1 and chunk > 0 and chunk % 16 == 0       # whole 16-slot blocks
    assert (n_split - 1) * chunk < slots <= n_split * chunk     # all covered, none empty
    assert chunk >= 128 or n_split == 1
    if slots >= 128 * -(-2 * sms // (B * KVH)):                 # the slots allow it
        assert n_split * KVH * B >= 2 * sms                     # two blocks per SM


@pytest.mark.parametrize("sms,B,KVH,slots", SPLIT_CASES)
def test_decode_split_rule(sms, B, KVH, slots):
    _check_split(sms, B, KVH, slots)


def test_decode_split_rule_over_a_sweep():
    for sms in (1, 8, 132):
        for B in (1, 3, 8, 64):
            for KVH in (1, 2, 5):
                for slots in list(range(1, 300, 7)) + [1023, 1024, 2047, 2048, 2049]:
                    _check_split(sms, B, KVH, slots)


def test_decode_split_at_the_serve_shapes():
    # phase 2 of chip_smoke.py: 16 splits of 128 slots, 256 blocks
    assert tka.decode_split(132, 8, 2, 128 * 16) == (16, 128)
    # hymba's decode over its 1024-slot ring: 8 even splits, 320 blocks
    assert tka.decode_split(132, 8, 5, 1024) == (8, 128)
