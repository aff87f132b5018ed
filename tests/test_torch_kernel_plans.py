"""How the port's attention and top-k kernels cut their work, on the CPU
(no kernel is launched): the chunk kernel's tile plan (``chunk_tile_plan``,
the rule its plan kernel applies on the card) and split count
(``chunk_split``), the dense decode kernel's per-row splits
(``dense_decode_split``, ``dense_decode_chunk``, the rule its warps apply on
the card), and the top-k kernel's query tiles, corpus slices and ring
stages (``topk_plan``). The card tests hold the kernels' own plans and
outputs to these (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as ka
from repro_torch.kernels import topk_retrieval as tk


def _row_of(xs):
    return torch.tensor(xs, dtype=torch.int32)


def _runs(*parts):
    """row_of of consecutive runs: (row, n) pairs; row -1 are pads."""
    return _row_of([r for r, n in parts for _ in range(n)])


# the engine's mixed step at qwen2.5-3b's heads: one row prefills a 256-token
# chunk, seven rows decode one token each, pads up to pack_align 4
MIXED_STEP = _runs((0, 256), *((b, 1) for b in range(1, 8)), (-1, 1))

ROW_OF_CASES = {
    "run_1": _runs((0, 1)),
    "run_15": _runs((0, 15)),
    "run_16": _runs((0, 16)),
    "run_17": _runs((0, 17)),
    "run_256": _runs((0, 256)),
    "mixed_step": MIXED_STEP,
    "decode_first": _runs(*((b, 1) for b in range(1, 4)), (0, 256), *((b, 1) for b in range(4, 8)),
                          (-1, 3)),
    "interleaved": _row_of([0, 1, 0, 1, 2, 0, 0, 1, 1, 1]),
    "pads_in_the_middle": _runs((2, 5), (-1, 3), (2, 20), (-1, 2), (1, 1)),
    "row_split_across_runs": _runs((3, 10), (4, 2), (3, 30)),
    "all_pads": _runs((-1, 7)),
    "T_1": _runs((5, 1)),
    "T_1_pad": _runs((-1, 1)),
}


def _check_plan(row_of, G):
    size = ka.chunk_tile_tokens(G)
    starts, counts = ka.chunk_tile_plan(row_of, G)
    r = row_of.tolist()
    covered = np.zeros(len(r), np.int64)
    for s, n in zip(starts.tolist(), counts.tolist()):
        assert 1 <= n <= size and n * G <= 128            # at most 16 tokens, 128 query rows
        toks = range(s, s + n)
        assert all(r[t] == r[s] >= 0 for t in toks)        # one row, no pad
        assert s // size == (s + n - 1) // size            # inside one aligned window
        covered[s:s + n] += 1
    want = np.array([x >= 0 for x in r], np.int64)         # every non-pad token once
    np.testing.assert_array_equal(covered, want)
    assert list(starts) == sorted(starts.tolist())
    return starts, counts


@pytest.mark.parametrize("G", [1, 5, 8, 20])
@pytest.mark.parametrize("case", sorted(ROW_OF_CASES))
def test_chunk_tile_plan_covers_each_token_once(case, G):
    _check_plan(ROW_OF_CASES[case], G)


def test_chunk_tile_plan_of_the_mixed_step():
    starts, counts = _check_plan(MIXED_STEP, 8)
    # sixteen 16-token tiles of the prefill chunk, then one per decode row
    assert starts.tolist() == list(range(0, 256, 16)) + list(range(256, 263))
    assert counts.tolist() == [16] * 16 + [1] * 7


def _packing(rng, B, budget):
    """row_of as the control plane packs a mixed step: active rows in slot
    order, each as one run (a prefill chunk or one decode token), pads up
    to a multiple of 4 at the tail."""
    parts = []
    for b in range(B):
        kind = rng.integers(0, 3)
        if kind == 1:
            parts.append((b, 1))
        elif kind == 2:
            parts.append((b, int(rng.integers(1, budget + 1))))
    T = sum(n for _, n in parts)
    pad = -(-max(T, 1) // 4) * 4 - T
    return _runs(*parts, (-1, pad))


def test_chunk_tile_plan_stays_within_the_grid_bound():
    """Packings as the control plane makes them: the tiles never pass the
    bound the wrapper sizes its grid from (``chunk_split``), so one pass of
    the grid covers them."""
    rng = np.random.default_rng(17)
    for _ in range(300):
        B = int(rng.integers(1, 17))
        row_of = _packing(rng, B, int(rng.choice([3, 17, 64, 256])))
        for G in (1, 5, 8, 20):
            starts, _ = _check_plan(row_of, G)
            _, tiles = ka.chunk_split(132, row_of.numel(), B, 2, G, 2304)
            assert starts.numel() <= tiles


@pytest.mark.parametrize("sms,T,B,KVH,G,slots,want", [
    (132, 264, 8, 2, 8, 144 * 16, (3, 25)),     # the engine's mixed step (qwen2.5-3b)
    (132, 303, 8, 2, 8, 144 * 16, (3, 27)),     # chip_smoke.py phase 2's ragged case
    (132, 4096, 8, 2, 8, 144 * 16, (1, 264)),   # a long chunk fills the card alone
    (132, 1, 1, 1, 1, 16, (1, 2)),              # no more splits than 64-slot tiles
    (1, 20, 2, 3, 3, 2304, (1, 4)),             # a card of one SM
])
def test_chunk_split(sms, T, B, KVH, G, slots, want):
    n_split, tiles = ka.chunk_split(sms, T, B, KVH, G, slots)
    assert (n_split, tiles) == want
    assert tiles == -(-T // ka.chunk_tile_tokens(G)) + B
    if n_split > 1:                              # only where the tiles alone leave SMs idle
        assert (n_split - 1) * tiles * KVH < sms


def _check_dense_split(length, n_split):
    chunk = ka.dense_decode_chunk(length, n_split)
    assert chunk % 16 == 0 and chunk >= 16
    covered = np.zeros(length, np.int64)
    for sp in range(n_split):
        lo, hi = sp * chunk, min((sp + 1) * chunk, length)
        assert hi - lo <= chunk
        if lo < hi:
            covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)      # every valid slot in exactly one split
    # the least such chunk: one tile less would leave slots uncovered
    assert chunk == 16 or (chunk - 16) * n_split < length


@pytest.mark.parametrize("length", [1, 15, 16, 17, 300, 323, 340, 1024, 1280, 2047, 2048])
@pytest.mark.parametrize("n_split", [1, 2, 7, 14, 33, 128])
def test_dense_decode_chunk_covers_each_slot_once(length, n_split):
    _check_dense_split(length, n_split)


@pytest.mark.parametrize("sms,B,KVH,G,Sc,want", [
    (132, 8, 2, 8, 2048, 17),     # qwen2.5-3b's dense serve
    (132, 8, 5, 5, 1024, 7),      # hymba-1.5b's 1024-slot ring
    (132, 8, 2, 20, 2048, 9),     # 20 heads a KV head: two groups of up to 16
    (132, 8, 2, 8, 40, 3),        # never more splits than 16-slot tiles
    (132, 512, 8, 8, 2048, 1),
])
def test_dense_decode_split(sms, B, KVH, G, Sc, want):
    n_split = ka.dense_decode_split(sms, B, KVH, G, Sc)
    assert n_split == want
    for length in (1, 17, Sc // 2 + 1, Sc):
        _check_dense_split(length, n_split)


# ---------------------------------------------------------------------------
# top-k retrieval: query tiles, corpus slices, ring stages
# ---------------------------------------------------------------------------

def _check_topk_plan(sms, B, N, d, k, item):
    plan = tk.topk_plan(sms, B, N, d, k, item)
    # every query in exactly one tile, no tile empty
    assert plan.q_tiles * tk.QUERY_TILE >= B > (plan.q_tiles - 1) * tk.QUERY_TILE
    # every 128-doc tile in exactly one slice, no slice empty
    n_tiles = -(-N // tk.TILE_DOCS)
    covered = np.zeros(n_tiles, np.int64)
    for j in range(plan.n_slices):
        lo, hi = j * plan.tiles_per_slice, min((j + 1) * plan.tiles_per_slice, n_tiles)
        assert lo < hi
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)
    # one wave of blocks, one an SM; shared memory within the block's 227 KB
    assert plan.q_tiles * plan.n_slices <= max(sms, plan.q_tiles)
    assert 2 <= plan.stages <= tk._MAX_STAGES
    assert tk.topk_smem_bytes(d, k, item, plan.stages) <= 227 * 1024
    assert tk.merge_smem_bytes(plan.n_slices, k) <= 227 * 1024
    assert plan.list_k >= k and plan.list_k in (32, 64, 128)
    return plan


@pytest.mark.parametrize("item", [4, 2])
@pytest.mark.parametrize("k", [1, 10, 100, 128])
@pytest.mark.parametrize("B", [1, 32, 33, 64])
@pytest.mark.parametrize("N", [1, 127, 128, 129, 1000, 777 * 128 + 5, 1 << 21])
def test_topk_plan_covers_every_doc_and_query_once(N, B, k, item):
    if k > N:
        k = N
    _check_topk_plan(132, B, N, 768, k, item)


def test_topk_plan_at_the_retrieval_phase():
    """B 32, N 2^21, d 768: one slice an SM, whole tiles, and a ring of at
    least 3 stages (48 KB in flight) at every k: 5 with f32 docs (beside
    their d_lo buffer), 6 with bf16."""
    for k in (10, 64, 100, 128):
        for item, stages in ((4, 5), (2, 6)):
            plan = _check_topk_plan(132, 32, 1 << 21, 768, k, item)
            assert (plan.q_tiles, plan.n_slices, plan.tiles_per_slice) == (1, 132, 125)
            assert plan.stages == stages
    # two query tiles share the card: 66 slices each
    plan = _check_topk_plan(132, 33, 1 << 21, 768, 100, 4)
    assert (plan.q_tiles, plan.n_slices) == (2, 66)
    # more query tiles than SMs: one slice each
    plan = _check_topk_plan(132, 32 * 200, 1 << 21, 768, 10, 4)
    assert (plan.q_tiles, plan.n_slices) == (200, 1)


def test_topk_plan_rejects_what_does_not_fit():
    with pytest.raises(ValueError):        # the query tile alone passes 227 KB
        tk.topk_plan(132, 32, 1 << 20, 2048, 10, 4)
    tk.topk_plan(132, 32, 1 << 20, 1024, 128, 4)     # the widest rows that fit at k 128
