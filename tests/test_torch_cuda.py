"""The CUDA kernels (paged attention with the chunk kernel's tile plan,
dense flash and decode attention with and without a sliding window, the
flash backward, top-k retrieval, the RWKV-6 WKV recurrence, the selective
scan) against their plain versions, on the card; the engine's int8 pools,
swap, oracle paths and KV sanitizer, the sliding-window and MoE stacks, and
train steps and the forward-only wrappers' grad guards on the card. Marked ``cuda``: each test skips (from inside a
fixture) where no GPU is visible, as in this repository's CPU runs. On a GPU
machine:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which a GPU machine
need not have.)
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as ka
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import rwkv6_scan as kw
from repro_torch.kernels import ssm_scan as ks
from repro_torch.kernels import topk_retrieval as tk
from repro_torch.serving.control_plane import padded_plan_difference

pytestmark = pytest.mark.cuda

# (atol, rtol) by (pool dtype, q dtype). f32: summation order. bf16 pools:
# the plain version's bf16 probabilities and the output rounding. int8 pools
# with bf16 q: the plain version keeps f32 probabilities on the dequantised
# pool, so only the bf16 output rounding (half an ulp, 2**-9 relative) differs.
TOL = {(torch.float32, torch.float32): (1e-4, 1e-4),
       (torch.bfloat16, torch.bfloat16): (2e-2, 2e-2),
       (torch.int8, torch.float32): (1e-4, 1e-4),
       (torch.int8, torch.bfloat16): (1e-3, 8e-3)}
# bf16 kernels against the plain version on the same values in f32 (f32
# probabilities): the bf16 output rounding only
BF16_OUT_TOL = (1e-3, 8e-3)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(seed, hd, pool_dtype, q_dtype, B=5, KVH=2, G=4, mb=9, bs=16):
    g = torch.Generator().manual_seed(seed)
    n_blocks = B * mb + 1
    lengths = torch.randint(1, mb * bs + 1, (B,), generator=g)
    tables = torch.full((B, mb), -1, dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    cur = 0
    for b, ln in enumerate(lengths.tolist()):
        need = -(-ln // bs)
        tables[b, :need] = perm[cur:cur + need].int()
        cur += need
        if need > 3:
            tables[b, 2] = -1                      # interior RAW hole
    row_of, slots, p_end, s_start = [], [], [], []
    for b, ln in enumerate(lengths.tolist()):
        c = min(ln, 5) if b % 2 else 1             # prefill chunk or decode row
        for s in range(ln - c, ln):
            row_of.append(b)
            slots.append(s)
            seg = b == 3 and ln - c > 4
            p_end.append(2 if seg else 0)
            s_start.append(ln - c - 1 if seg else 0)
    row_of += [-1, -1]
    slots += [0, 0]
    p_end += [0, 0]
    s_start += [0, 0]
    shape = (n_blocks, bs, KVH, hd)
    if pool_dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        ks = torch.rand((n_blocks, KVH), generator=g) * 0.02
        vs = torch.rand((n_blocks, KVH), generator=g) * 0.02
    else:
        k = torch.randn(shape, generator=g).to(pool_dtype)
        v = torch.randn(shape, generator=g).to(pool_dtype)
        ks = vs = None
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32)
    return dict(
        q_dec=torch.randn((B, KVH * G, hd), generator=g).to(q_dtype),
        q_chunk=torch.randn((len(row_of), KVH * G, hd), generator=g).to(q_dtype),
        k=k, v=v, ks=ks, vs=vs, tables=tables, lengths=lengths.int(),
        row_of=i32(row_of), slots=i32(slots), p_end=i32(p_end), s_start=i32(s_start))


def _close(got, want, valid, tol):
    atol, rtol = tol
    got, want = got.float()[valid], want.float()[valid]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _on(c, device, float_dtype=None):
    """The case's tensors on ``device``; q and float pools cast to
    ``float_dtype`` when given."""
    out = {}
    for k, v in c.items():
        if v is not None and float_dtype is not None and k in ("q_dec", "q_chunk", "k", "v") \
                and v.is_floating_point():
            v = v.to(float_dtype)
        out[k] = v.to(device) if v is not None else None
    return out


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pool_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.int8, torch.float32), (torch.int8, torch.bfloat16)])
def test_kernels_match_plain_versions(gpu, hd, pool_dtype, q_dtype):
    c = _on(_case(hd, hd, pool_dtype, q_dtype), gpu)
    tol = TOL[(pool_dtype, q_dtype)]
    n_dec, n_chunk = ka.paged_decode_attention.launches, ka.paged_chunk_attention.launches
    got = ka.paged_decode_attention(c["q_dec"], c["k"], c["v"], c["tables"], c["lengths"],
                                    k_scale=c["ks"], v_scale=c["vs"])
    want = ka.ref_paged_decode_attention(c["q_dec"], c["k"], c["v"], c["tables"],
                                         c["lengths"], k_scale=c["ks"], v_scale=c["vs"])
    _close(got, want, slice(None), tol)
    args = (c["q_chunk"], c["k"], c["v"], c["tables"], c["row_of"], c["slots"],
            c["p_end"], c["s_start"])
    got = ka.paged_chunk_attention(*args, k_scale=c["ks"], v_scale=c["vs"])
    want = ka.ref_paged_chunk_attention(*args, k_scale=c["ks"], v_scale=c["vs"])
    valid = c["row_of"] >= 0
    _close(got, want, valid, tol)
    assert (got[~valid] == 0).all()
    assert ka.paged_decode_attention.launches == n_dec + 1
    assert ka.paged_chunk_attention.launches == n_chunk + 1


@pytest.mark.parametrize("hd", [64, 128])
def test_bf16_kernels_match_f32_plain_versions(gpu, hd):
    c = _on(_case(hd + 1, hd, torch.bfloat16, torch.bfloat16), gpu)
    f = _on(c, gpu, torch.float32)
    got = ka.paged_decode_attention(c["q_dec"], c["k"], c["v"], c["tables"], c["lengths"])
    want = ka.ref_paged_decode_attention(f["q_dec"], f["k"], f["v"], f["tables"], f["lengths"])
    _close(got, want, slice(None), BF16_OUT_TOL)
    keys = ("k", "v", "tables", "row_of", "slots", "p_end", "s_start")
    got = ka.paged_chunk_attention(c["q_chunk"], *(c[k] for k in keys))
    want = ka.ref_paged_chunk_attention(f["q_chunk"], *(f[k] for k in keys))
    _close(got, want, c["row_of"] >= 0, BF16_OUT_TOL)


# The split decode at the paged serve's table width: mb 128 entries of 16
# slots, 16 splits of 8 entries at B 8, KVH 2 on an H100. Lengths at and
# around block and split edges; -1 holes on split boundaries (entries 8 and
# 16) of the two longest rows and on row 5's last block; row 6's table ends
# after two splits, so its tail splits hold only holes.
SPLIT_LENGTHS = [2048, 1, 16, 17, 128, 129, 777, 2047]


def _split_case(seed, hd, pool_dtype, q_dtype, KVH=2, G=8, mb=128, bs=16):
    g = torch.Generator().manual_seed(seed)
    B = len(SPLIT_LENGTHS)
    n_blocks = B * mb + 1
    tables = torch.full((B, mb), -1, dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    cur = 0
    for b, ln in enumerate(SPLIT_LENGTHS):
        need = -(-ln // bs)
        tables[b, :need] = perm[cur:cur + need].int()
        cur += need
    tables[[0, 7], 8] = -1
    tables[[0, 7], 16] = -1
    tables[5, 8] = -1
    tables[6, 16:] = -1
    shape = (n_blocks, bs, KVH, hd)
    if pool_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((n_blocks, KVH), generator=g) * 0.02 + 1e-3 for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=g).to(pool_dtype) for _ in range(2))
        ks = vs = None
    q = torch.randn((B, KVH * G, hd), generator=g).to(q_dtype)
    return dict(q_dec=q, k=k, v=v, ks=ks, vs=vs, tables=tables,
                lengths=torch.tensor(SPLIT_LENGTHS, dtype=torch.int32))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pool_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.int8, torch.float32), (torch.int8, torch.bfloat16)])
def test_split_decode_kernel_at_split_edges(gpu, hd, pool_dtype, q_dtype):
    c = _on(_split_case(hd + 3, hd, pool_dtype, q_dtype), gpu)
    args = (c["q_dec"], c["k"], c["v"], c["tables"], c["lengths"])
    before = ka.paged_decode_attention.launches
    got = ka.paged_decode_attention(*args, k_scale=c["ks"], v_scale=c["vs"])
    torch.cuda.synchronize()
    assert ka.paged_decode_attention.launches == before + 1
    want = ka.ref_paged_decode_attention(*args, k_scale=c["ks"], v_scale=c["vs"])
    _close(got, want, slice(None), TOL[(pool_dtype, q_dtype)])
    if pool_dtype == torch.bfloat16:
        f = _on(c, gpu, torch.float32)
        want = ka.ref_paged_decode_attention(f["q_dec"], f["k"], f["v"], f["tables"],
                                             f["lengths"])
        _close(got, want, slice(None), BF16_OUT_TOL)


def test_kernels_reject_what_they_do_not_take(gpu):
    c = _case(0, 64, torch.float32, torch.float32)
    q, k, v = c["q_dec"].to(gpu), c["k"].to(gpu), c["v"].to(gpu)
    tables, lengths = c["tables"].to(gpu), c["lengths"].to(gpu)
    with pytest.raises(ValueError):      # int64 tables
        ka.paged_decode_attention(q, k, v, tables.long(), lengths)
    with pytest.raises(ValueError):      # a block size the kernels are not built for
        ka.paged_decode_attention(q, k[:, :8].contiguous(), v[:, :8].contiguous(),
                                  tables, lengths)
    with pytest.raises(ValueError):      # mixed devices
        ka.paged_decode_attention(q, k, v, tables.cpu(), lengths)
    with pytest.raises(ValueError):      # a float pool in another dtype than q
        ka.paged_decode_attention(q, k.bfloat16(), v.bfloat16(), tables, lengths)


# The chunk kernel's tile plan on the card against its mirror
# (``chunk_tile_plan``), on packings the control plane makes and on ones it
# does not: rows interleaved, pads in the middle, a row split across runs.
PLAN_ROW_OF = {
    "mixed_step": [0] * 256 + list(range(1, 8)) + [-1],
    "runs_1_15_16_17": [0] + [1] * 15 + [2] * 16 + [3] * 17 + [-1] * 3,
    "interleaved": [0, 1, 0, 1, 2, 0, 0, 1, 1, 1],
    "pads_in_the_middle": [2] * 5 + [-1] * 3 + [2] * 20 + [-1] * 2 + [1],
    "row_split_across_runs": [3] * 10 + [4] * 2 + [3] * 30,
    "all_pads": [-1] * 7,
    "T_1": [5],
    "long": [b % 5 for b in range(3000)] + [7] * 1500,
}


@pytest.mark.parametrize("G", [1, 5, 8, 20])
@pytest.mark.parametrize("case", sorted(PLAN_ROW_OF))
def test_chunk_tile_plan_kernel_matches_its_mirror(gpu, case, G):
    from repro_torch.kernels._build import load_library

    row_of = torch.tensor(PLAN_ROW_OF[case], dtype=torch.int32, device=gpu)
    T = row_of.numel()
    plan = torch.full((1 + 2 * T,), -7, dtype=torch.int32, device=gpu)
    err = load_library("paged_attention").lib.pa_chunk_tile_plan(
        row_of.data_ptr(), T, G, plan.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    starts, counts = ka.chunk_tile_plan(row_of, G)
    n = int(plan[0])
    assert n == starts.numel()
    got = plan[1:1 + 2 * n].view(n, 2).long()
    assert torch.equal(got[:, 0], starts) and torch.equal(got[:, 1], counts)


def _chunk_case(seed, hd, pool_dtype, q_dtype, row_of, rows, G=8, KVH=2, holes=(), spans=None,
                mb=144, bs=16):
    """Pools and packed arrays for ``row_of``: rows[b] = (the row's length
    after this step, its packed tokens) sets each row's slots (its tokens
    are its last slots, in packed order); ``holes`` (row, entry) are -1
    table entries; ``spans`` {token: (p_end, s_start)} segmented spans."""
    g = torch.Generator().manual_seed(seed)
    B = max(rows) + 1
    n_blocks = B * mb + 1
    tables = torch.full((B, mb), -1, dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    cur = 0
    for b, (ln, _) in rows.items():
        need = -(-ln // bs)
        tables[b, :need] = perm[cur:cur + need].int()
        cur += need
    for b, j in holes:
        tables[b, j] = -1
    nxt = {b: ln - n for b, (ln, n) in rows.items()}
    slots, p_end, s_start = [], [], []
    for t, r in enumerate(row_of):
        if r < 0:
            slots.append(0)
        else:
            slots.append(nxt[r])
            nxt[r] += 1
        pe, ss = (spans or {}).get(t, (0, 0))
        p_end.append(pe)
        s_start.append(ss)
    shape = (n_blocks, bs, KVH, hd)
    if pool_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((n_blocks, KVH), generator=g) * 0.02 + 1e-3 for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=g).to(pool_dtype) for _ in range(2))
        ks = vs = None
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32)
    return dict(q_chunk=torch.randn((len(row_of), KVH * G, hd), generator=g).to(q_dtype),
                k=k, v=v, ks=ks, vs=vs, tables=tables, row_of=i32(row_of), slots=i32(slots),
                p_end=i32(p_end), s_start=i32(s_start))


def _check_chunk(c, tol, bf16_vs_f32):
    gpu = c["q_chunk"].device
    args = (c["q_chunk"], c["k"], c["v"], c["tables"], c["row_of"], c["slots"], c["p_end"],
            c["s_start"])
    before = ka.paged_chunk_attention.launches
    got = ka.paged_chunk_attention(*args, k_scale=c["ks"], v_scale=c["vs"])
    torch.cuda.synchronize()
    assert ka.paged_chunk_attention.launches == before + 1
    valid = c["row_of"] >= 0
    want = ka.ref_paged_chunk_attention(*args, k_scale=c["ks"], v_scale=c["vs"])
    _close(got, want, valid, tol)
    assert (got[~valid] == 0).all()                 # pad tokens: exactly zero
    if bf16_vs_f32:
        f = _on(c, gpu, torch.float32)
        want = ka.ref_paged_chunk_attention(
            f["q_chunk"], f["k"], f["v"], f["tables"], f["row_of"], f["slots"], f["p_end"],
            f["s_start"])
        _close(got, want, valid, BF16_OUT_TOL)


# the engine's mixed step: row 0 prefills 256 plain-causal tokens at slots
# 1024-1279, rows 1-7 decode one token each at lengths 300-340, one pad
# (pack_align 4); -1 holes in two decode rows' tables below their slots; a
# run of prefill tokens in the middle of a tile and one lone token with
# segmented spans unlike their neighbours'
MIXED_ROWS = {0: (1280, 256), **{b: (300 + 6 * (b - 1) + (b % 3), 1) for b in range(1, 8)}}
MIXED_ROW_OF = [0] * 256 + list(range(1, 8)) + [-1]
MIXED_HOLES = ((2, 3), (5, 10))
MIXED_SPANS = {**{t: (512, 1100) for t in range(100, 108)}, 130: (1024, 1150)}


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pool_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.int8, torch.float32), (torch.int8, torch.bfloat16)])
def test_chunk_kernel_at_the_mixed_step(gpu, hd, pool_dtype, q_dtype):
    c = _on(_chunk_case(hd + 5, hd, pool_dtype, q_dtype, MIXED_ROW_OF, MIXED_ROWS,
                        holes=MIXED_HOLES, spans=MIXED_SPANS), gpu)
    _check_chunk(c, TOL[(pool_dtype, q_dtype)], pool_dtype == torch.bfloat16)


# row_of the control plane never makes: (row_of, rows) with rows[b] = (the
# row's length after the step, its packed tokens)
ODD_PACKINGS = {
    "interleaved": ([0, 1, 0, 1, 2, 0, 0, 1, 1, 1], {0: (700, 4), 1: (40, 5), 2: (17, 1)}),
    "pads_in_the_middle": ([2] * 5 + [-1] * 3 + [2] * 20 + [-1] * 2 + [1],
                           {2: (333, 25), 1: (1, 1)}),
    "row_split_across_runs": ([3] * 10 + [4] * 2 + [3] * 30, {3: (2048, 40), 4: (16, 2)}),
    "runs_1_15_16_17": ([0] + [1] * 15 + [2] * 16 + [3] * 17 + [-1] * 3,
                        {0: (1, 1), 1: (15, 15), 2: (600, 16), 3: (1111, 17)}),
    "T_1": ([5], {5: (77, 1)}),
}


@pytest.mark.parametrize("G", [1, 5, 8, 20])
@pytest.mark.parametrize("case", sorted(ODD_PACKINGS))
def test_chunk_kernel_for_any_row_of(gpu, case, G):
    row_of, rows = ODD_PACKINGS[case]
    c = _on(_chunk_case(G, 128, torch.bfloat16, torch.bfloat16, row_of, rows, G=G), gpu)
    _check_chunk(c, TOL[(torch.bfloat16, torch.bfloat16)], True)


# ---------------------------------------------------------------------------
# flash_attention and decode_attention (the dense backend)
# ---------------------------------------------------------------------------

# f32: summation order; bf16: the plain version's bf16 probabilities (the
# kernels keep f32 ones, so against the plain version in f32 only the
# output rounding differs: BF16_OUT_TOL)
DENSE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


@pytest.mark.parametrize("causal", [True, False])
# 64: one whole 64-row tile, 65: one row past it; 1, 37, 200 and 1100 are
# no multiple of the tile
@pytest.mark.parametrize("S", [1, 37, 64, 65, 200, 1100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_kernel_matches_plain_version(gpu, hd, dtype, S, causal):
    g = torch.Generator().manual_seed(S * hd + causal)
    q, k, v = (torch.randn((2, S, n, hd), generator=g).to(dtype).to(gpu) for n in (8, 2, 2))
    before = kf.flash_attention.launches
    got = kf.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kf.flash_attention.launches == before + 1
    _close(got, kf.ref_flash_attention(q, k, v, causal), slice(None), DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = kf.ref_flash_attention(q.float(), k.float(), v.float(), causal)
        _close(got, want, slice(None), BF16_OUT_TOL)


@pytest.mark.parametrize("Sc,lengths", [
    (40, [1, 17, 40]),
    (300, [300, 299, 1, 64, 129]),          # Sc not a multiple of the 16-slot tile
    (2048, [2048, 1536, 1024, 777, 512, 300, 129, 1]),
    # the 16-slot tile's edges, the serve steps' 300-340, the whole cache
    (1000, [1, 15, 16, 17, 300, 323, 340, 1000]),
])
@pytest.mark.parametrize("H,KVH", [(16, 2), (25, 5), (40, 2)])   # G 8, 5, and 20 (two groups)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_dense_decode_kernel_matches_plain_version(gpu, hd, dtype, H, KVH, Sc, lengths):
    g = torch.Generator().manual_seed(Sc + hd + H)
    B = len(lengths)
    q = torch.randn((B, H, hd), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((B, Sc, KVH, hd), generator=g).to(dtype).to(gpu) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=gpu)
    before = ka.decode_attention.launches
    got = ka.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ka.decode_attention.launches == before + 1
    _close(got, ka.ref_decode_attention(q, k, v, lens), slice(None), DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
        _close(got, want, slice(None), BF16_OUT_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_at_hymba_heads(gpu, dtype):
    """hymba-1.5b's decode: H 25 over KVH 5 (G = 5), hd 64, a 1024-slot ring
    whose lengths min(pos + 1, 1024) mix full rings with short rows."""
    lengths = [1024, 1024, 1, 1024, 37, 1024, 300, 1024]
    g = torch.Generator().manual_seed(25)
    B = len(lengths)
    q = torch.randn((B, 25, 64), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((B, 1024, 5, 64), generator=g).to(dtype).to(gpu) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=gpu)
    before = ka.decode_attention.launches
    got = ka.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ka.decode_attention.launches == before + 1
    _close(got, ka.ref_decode_attention(q, k, v, lens), slice(None), DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
        _close(got, want, slice(None), BF16_OUT_TOL)


def test_dense_kernels_reject_what_they_do_not_take(gpu):
    q = torch.randn((1, 16, 4, 64), device=gpu)
    kv = torch.randn((1, 16, 2, 64), device=gpu)
    with pytest.raises(ValueError):      # a head_dim the kernels are not built for
        kf.flash_attention(q[..., :32].contiguous(), kv[..., :32].contiguous(),
                           kv[..., :32].contiguous())
    with pytest.raises(ValueError):      # k/v in another dtype than q
        kf.flash_attention(q, kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError):      # S_kv != S
        kf.flash_attention(q, kv[:, :8].contiguous(), kv[:, :8].contiguous())
    lens = torch.tensor([3], dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError):      # int64 lengths
        ka.decode_attention(q[:, 0].contiguous(), kv, kv, lens.long())
    with pytest.raises(ValueError):      # mixed devices
        ka.decode_attention(q[:, 0].contiguous(), kv, kv, lens.cpu())


# ---------------------------------------------------------------------------
# topk_retrieval
# ---------------------------------------------------------------------------

# scores (of unit rows, as the index holds them): the kernel sums each
# product in another order than the plain version's matrix product; ids:
# two docs may swap only where the plain version's scores of the two lie
# within TOPK_SWAP_TOL
TOPK_ATOL = 1e-4
TOPK_SWAP_TOL = 1e-5


def _check_topk(got, want, q, docs, exact_ids=False):
    (gs, gi), (ws, wi) = got, want
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32 and gs.shape == ws.shape
    torch.testing.assert_close(gs, ws, atol=TOPK_ATOL, rtol=0)
    if exact_ids:
        assert torch.equal(gi, wi)
        return
    full = q.float() @ docs.float().T
    diff = gi != wi
    gap = (full.gather(1, gi.long()) - full.gather(1, wi.long())).abs()
    assert bool((gap[diff] <= TOPK_SWAP_TOL).all()), gap[diff]
    assert all(len(set(r.tolist())) == gi.shape[1] for r in gi)   # no id twice


@pytest.mark.parametrize("docs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,d,k", [
    (1, 1000, 64, 1),        # one query, N not a multiple of the 256-doc tile
    (5, 4096, 768, 10),
    (40, 3000, 128, 100),    # more than one 32-query tile
    (33, 777, 32, 128),      # the largest k
])
def test_topk_kernel_matches_plain_version(gpu, docs_dtype, B, N, d, k):
    g = torch.Generator().manual_seed(B * N + d)
    unit = lambda x: x / x.norm(dim=1, keepdim=True)   # rows as the index holds them
    q = unit(torch.randn((B, d), generator=g)).to(gpu)
    docs = unit(torch.randn((N, d), generator=g)).to(docs_dtype).to(gpu)
    before = tk.topk_retrieval.launches
    got = tk.topk_retrieval(q, docs, k)
    torch.cuda.synchronize()
    assert tk.topk_retrieval.launches == before + 1
    _check_topk(got, tk.ref_topk_retrieval(q, docs, k), q, docs)


@pytest.mark.parametrize("docs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_topk_kernel_breaks_ties_to_the_lower_id(gpu, docs_dtype, k):
    """Small-integer rows, many duplicated: every product is exact, so equal
    scores are exactly equal and the ids must match one for one."""
    g = torch.Generator().manual_seed(k)
    base = torch.randint(-2, 3, (64, 96), generator=g).float()
    docs = base[torch.randint(0, 64, (5000,), generator=g)].to(docs_dtype).to(gpu)
    q = torch.randint(-2, 3, (7, 96), generator=g).float().to(gpu)
    got = tk.topk_retrieval(q, docs, k)
    _check_topk(got, tk.ref_topk_retrieval(q, docs, k), q, docs, exact_ids=True)


@pytest.mark.parametrize("docs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,d,k", [
    (5, 128 * 300 + 77, 768, 10),    # 300 tiles: 132 slices, N not a multiple of the tile
    (5, 128 * 300 + 77, 768, 100),
    (33, 50_000, 768, 100),          # two query tiles, the second holding one query
    (64, 20_000, 256, 10),           # two full query tiles
    (32, 30_000, 768, 128),          # the largest k at the retrieval phase's width
    (3, 4_000, 72, 16),              # d not a multiple of a stage's columns (zero fill)
])
def test_topk_kernel_across_slices_and_query_tiles(gpu, docs_dtype, B, N, d, k):
    g = torch.Generator().manual_seed(B * 7 + N + d + k)
    unit = lambda x: x / x.norm(dim=1, keepdim=True)
    q = unit(torch.randn((B, d), generator=g)).to(gpu)
    docs = unit(torch.randn((N, d), generator=g)).to(docs_dtype).to(gpu)
    plan = tk.topk_plan(torch.cuda.get_device_properties(gpu).multi_processor_count,
                        B, N, d, k, docs.element_size())
    assert plan.n_slices > 1
    got = tk.topk_retrieval(q, docs, k)
    torch.cuda.synchronize()
    _check_topk(got, tk.ref_topk_retrieval(q, docs, k), q, docs)


@pytest.mark.parametrize("docs_dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_on_near_duplicate_docs(gpu, docs_dtype):
    """Each row repeated with perturbations of 1e-6: neighbours' scores lie
    closer than the tolerance, so their ids may swap, but only within
    TOPK_SWAP_TOL of the plain scores."""
    g = torch.Generator().manual_seed(3)
    base = torch.randn((500, 768), generator=g)
    docs = base.repeat(40, 1) + 1e-6 * torch.randn((20_000, 768), generator=g)
    docs = (docs / docs.norm(dim=1, keepdim=True)).to(docs_dtype).to(gpu)
    q = base[:16].to(gpu) / base[:16].norm(dim=1, keepdim=True).to(gpu)
    for k in (10, 100):
        got = tk.topk_retrieval(q, docs, k)
        _check_topk(got, tk.ref_topk_retrieval(q, docs, k), q, docs)


def test_topk_plan_mirrors_the_kernel(gpu):
    """The wrapper's plan sizes (kernels/topk_retrieval.py) are the
    kernel's."""
    from repro_torch.kernels._build import load_library

    lib = load_library("topk_retrieval").lib
    assert (lib.tk_max_k(), lib.tk_docs_per_tile(), lib.tk_query_tile()) == (
        tk.MAX_K, tk.TILE_DOCS, tk.QUERY_TILE)
    for code, item in ((0, 4), (1, 2)):
        for d in (8, 72, 768, 1024):
            for k in (1, 10, 33, 100, 128):
                for stages in (2, 4, 6):
                    assert lib.tk_smem_bytes(code, d, k, stages) == tk.topk_smem_bytes(
                        d, k, item, stages)
    for n in (1, 2, 7, 66, 132, 256):
        for k in (10, 64, 128):
            assert lib.tk_merge_smem_bytes(n, k) == tk.merge_smem_bytes(n, k)


def test_topk_kernel_rejects_what_it_does_not_take(gpu):
    q = torch.randn((2, 64), device=gpu)
    docs = torch.randn((500, 64), device=gpu)
    with pytest.raises(ValueError):      # k above the kernel's 128
        tk.topk_retrieval(q, docs, 129)
    with pytest.raises(ValueError):      # k above N
        tk.topk_retrieval(q, docs[:50], 51)
    with pytest.raises(ValueError):      # d not a multiple of 8
        tk.topk_retrieval(q[:, :12].contiguous(), docs[:, :12].contiguous(), 5)
    with pytest.raises(ValueError):      # a docs dtype the kernel is not built for
        tk.topk_retrieval(q, docs.half(), 5)
    with pytest.raises(ValueError):      # mixed devices
        tk.topk_retrieval(q.cpu(), docs, 5)


# ---------------------------------------------------------------------------
# RWKV-6 WKV recurrence
# ---------------------------------------------------------------------------

# f32 arithmetic on both sides (bf16 r, k and v are widened exactly):
# summation order only
WKV_TOL = (1e-4, 1e-4)


def _wkv_case(seed, B, S, H, hd, dtype, decay, device):
    g = torch.Generator().manual_seed(seed)
    r, k = (0.5 * torch.randn((B, S, H, hd), generator=g) for _ in range(2))
    v = torch.randn((B, S, H, hd), generator=g)
    if decay is None:    # realistic Finch decay: w = exp(-exp(z)), z ~ N(0, 0.5)
        w = torch.exp(-torch.exp(0.5 * torch.randn((B, S, H, hd), generator=g)))
    else:
        w = torch.full((B, S, H, hd), decay)
    u = 0.3 * torch.randn((H, hd), generator=g)
    state0 = 0.5 * torch.randn((B, H, hd, hd), generator=g)
    to = lambda x, dt=torch.float32: x.to(dt).to(device)
    return to(r, dtype), to(k, dtype), to(v, dtype), to(w), to(u), to(state0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,decay", [
    (1, 2048, 64, 64, None),    # rwkv6-7b prefill
    (1, 37, 64, 64, None),      # S not a multiple of the 32-step chunk
    (8, 1, 64, 64, None),       # rwkv6-7b decode, max_batch 8
    (1, 64, 4, 64, 0.45),       # tests/test_kernels.py:71, adversarial decay
    (2, 100, 4, 64, 1e-6),      # decays near 0
    (2, 33, 8, 32, None),       # the smoke variant's head_dim
], ids=["prefill2048", "prefill37", "decode", "w0.45", "w1e-6", "hd32"])
def test_wkv_kernel_matches_plain_version(gpu, dtype, B, S, H, hd, decay):
    r, k, v, w, u, state0 = _wkv_case(S + B, B, S, H, hd, dtype, decay, gpu)
    before = kw.rwkv6_chunked.launches
    y, st = kw.rwkv6_chunked(r, k, v, w, u, state0)
    torch.cuda.synchronize()
    assert kw.rwkv6_chunked.launches == before + 1
    y_ref, st_ref = kw.ref_rwkv6_chunked(r, k, v, w, u, state0)
    assert y.dtype == st.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y, y_ref, atol=WKV_TOL[0], rtol=WKV_TOL[1])
    torch.testing.assert_close(st, st_ref, atol=WKV_TOL[0], rtol=WKV_TOL[1])
    # zero state (no state0), and the state updated in place
    y0, st0 = kw.rwkv6_chunked(r, k, v, w, u)
    y0_ref, st0_ref = kw.ref_rwkv6_chunked(r, k, v, w, u)
    torch.testing.assert_close(y0, y0_ref, atol=WKV_TOL[0], rtol=WKV_TOL[1])
    torch.testing.assert_close(st0, st0_ref, atol=WKV_TOL[0], rtol=WKV_TOL[1])
    inplace = state0.clone()
    y1, st1 = kw.rwkv6_chunked(r, k, v, w, u, inplace, state_out=inplace)
    torch.cuda.synchronize()
    assert st1 is inplace
    torch.testing.assert_close(y1, y, atol=0, rtol=0)
    torch.testing.assert_close(inplace, st, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,decay", [
    (1, 1, 64, 64, None),       # one step: the kernel without staging
    (1, 33, 64, 64, None),      # one segment (segments are >= 32 steps)
    (1, 255, 64, 64, None),     # 7 segments of 37 (at most 255 // 32), the last 33
    (1, 257, 64, 64, None),     # 8 segments of 33, the last 26
    (1, 1519, 64, 64, None),    # the longest rwkv serve prompt
    (1, 2048, 64, 64, 1e-6),    # decays near 0 across every segment
    (2, 100, 8, 32, None),      # the smoke variant's head_dim, 3 segments
], ids=["S1", "S33", "S255", "S257", "S1519", "S2048-w1e-6", "hd32-S100"])
def test_wkv_kernel_at_segment_edges(gpu, dtype, B, S, H, hd, decay):
    """Lengths about the edges of ``wkv_segments``, the state updated in
    place; the wrapper cuts S by the rule at this card's slots, whose
    segments cover the S steps, each segment holding at least one."""
    r, k, v, w, u, state0 = _wkv_case(S + 7, B, S, H, hd, dtype, decay, gpu)
    inplace = state0.clone()
    y, st = kw.rwkv6_chunked(r, k, v, w, u, inplace, state_out=inplace)
    torch.cuda.synchronize()
    assert st is inplace
    slots = kw.output_slots(r.device.index, dtype, hd)
    n_seg, seg_len = kw.wkv_segments(slots, B, H, S)
    assert (n_seg - 1) * seg_len < S <= n_seg * seg_len
    y_ref, st_ref = kw.ref_rwkv6_chunked(r, k, v, w, u, state0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y, y_ref, atol=WKV_TOL[0], rtol=WKV_TOL[1])
    torch.testing.assert_close(st, st_ref, atol=WKV_TOL[0], rtol=WKV_TOL[1])


def test_wkv_kernel_rejects_what_it_does_not_take(gpu):
    r, k, v, w, u, state0 = _wkv_case(0, 1, 8, 2, 64, torch.float32, None, gpu)
    with pytest.raises(ValueError):      # w in bf16
        kw.rwkv6_chunked(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError):      # r, k and v in different dtypes
        kw.rwkv6_chunked(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError):      # a head_dim the kernel is not built for
        kw.rwkv6_chunked(*(x[..., :48].contiguous() for x in (r, k, v, w)), u[:, :48])
    with pytest.raises(ValueError):      # a non-contiguous input
        kw.rwkv6_chunked(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError):      # a state of another shape
        kw.rwkv6_chunked(r, k, v, w, u, state0[:, :1].contiguous())
    with pytest.raises(ValueError):      # mixed devices
        kw.rwkv6_chunked(r, k, v, w.cpu(), u)
    with pytest.raises(ValueError):      # no time steps
        kw.rwkv6_chunked(*(x[:, :0].contiguous() for x in (r, k, v, w)), u)


@pytest.mark.parametrize("window", [64, 1024])
@pytest.mark.parametrize("S", [1, 37, 200, 1100, 1664])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_flash_kernel_matches_plain_version(gpu, dtype, S, window):
    """hymba-1.5b's heads (H 25 over KVH 5, hd 64) with a sliding window;
    1100 > 1024 crosses the full-width window; 1664 is the hymba serve's
    longest prefill (128 meta + 1536 tokens)."""
    g = torch.Generator().manual_seed(S + window)
    q = torch.randn((1, S, 25, 64), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((1, S, 5, 64), generator=g).to(dtype).to(gpu) for _ in range(2))
    before = kf.flash_attention.launches
    got = kf.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert kf.flash_attention.launches == before + 1
    atol, rtol = TOL[(dtype, dtype)]
    torch.testing.assert_close(got, kf.ref_flash_attention(q, k, v, window=window),
                               atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        want = kf.ref_flash_attention(q.float(), k.float(), v.float(), window=window)
        torch.testing.assert_close(got.float(), want, atol=BF16_OUT_TOL[0], rtol=BF16_OUT_TOL[1])


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

# f32 arithmetic on both sides (bf16 inputs are widened exactly); the
# kernel's exp2 of dt * A * log2(e) against exp(dt * A): a few ulps a step
SSM_TOL = (1e-4, 1e-4)


def _ssm_case(seed, B, S, Di, N, dtype, device, extreme=False):
    """dt = softplus(z) with z ~ N(-2, 1) (dt * A near -0.1 .. -2), or for
    ``extreme`` z ~ N(0, 2) (dt up to ~6, dt * A down to about -100)."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((B, S, Di), generator=g) * (2.0 if extreme else 1.0) - (0.0 if extreme else 2.0)
    dt = torch.nn.functional.softplus(z)
    x = torch.randn((B, S, Di), generator=g)
    bm, cm = (0.5 * torch.randn((B, S, N), generator=g) for _ in range(2))
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)).expand(Di, N).contiguous()
    h0 = 0.5 * torch.randn((B, Di, N), generator=g)
    to = lambda t, dt_=torch.float32: t.to(dt_).to(device)
    return to(dt, dtype), to(x, dtype), to(bm, dtype), to(cm, dtype), to(a_log), to(h0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,extreme", [
    (1, 1664, 1600, 16, False),   # hymba-1.5b prefill: 128 meta + 1536 text tokens
    (1, 37, 1600, 16, True),      # S not a multiple of the 64-step chunk; extreme dt
    (8, 1, 1600, 16, False),      # hymba-1.5b decode, max_batch 8
    (2, 100, 256, 8, False),      # the smoke variant's width and state
    (3, 70, 100, 16, True),       # Di not a multiple of the block's 8 channels
], ids=["prefill1664", "S37", "decode", "smoke", "Di100"])
def test_ssm_kernel_matches_plain_version(gpu, dtype, B, S, Di, N, extreme):
    dt, x, bm, cm, a_log, h0 = _ssm_case(S + B, B, S, Di, N, dtype, gpu, extreme)
    before = ks.ssm_scan.launches
    y, h = ks.ssm_scan(dt, x, bm, cm, a_log, h0)
    torch.cuda.synchronize()
    assert ks.ssm_scan.launches == before + 1
    y_ref, h_ref = ks.ref_ssm_scan(dt, x, bm, cm, a_log, h0)
    assert y.dtype == h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, y_ref, atol=SSM_TOL[0], rtol=SSM_TOL[1])
    torch.testing.assert_close(h, h_ref, atol=SSM_TOL[0], rtol=SSM_TOL[1])
    # zero h0, a bf16 a_log (the model's dtype), and h updated in place
    y0, h0_out = ks.ssm_scan(dt, x, bm, cm, a_log.bfloat16())
    y0_ref, h0_ref = ks.ref_ssm_scan(dt, x, bm, cm, a_log.bfloat16())
    torch.testing.assert_close(y0, y0_ref, atol=SSM_TOL[0], rtol=SSM_TOL[1])
    torch.testing.assert_close(h0_out, h0_ref, atol=SSM_TOL[0], rtol=SSM_TOL[1])
    inplace = h0.clone()
    y1, h1 = ks.ssm_scan(dt, x, bm, cm, a_log, inplace, h_out=inplace)
    torch.cuda.synchronize()
    assert h1 is inplace
    torch.testing.assert_close(y1, y, atol=0, rtol=0)
    torch.testing.assert_close(inplace, h, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,extreme", [
    (1, 1, 1600, 16, False),      # one step: the kernel without shared memory
    (1, 17, 1600, 16, False),     # one segment (segments are >= 32 steps)
    (1, 129, 1600, 16, False),    # 4 segments of 33 (at most 129 // 32), the last 30
    (1, 1647, 1600, 16, False),   # the longest hymba serve prefill
    (1, 1664, 1600, 16, True),    # extreme dt across every segment
    (2, 100, 256, 8, True),       # the smoke variant's state size, 3 segments
], ids=["S1", "S17", "S129", "S1647", "S1664-extreme", "N8-S100"])
def test_ssm_kernel_at_segment_edges(gpu, dtype, B, S, Di, N, extreme):
    """Lengths about the edges of ``ssm_segments``, h updated in place;
    the wrapper cuts S by the rule at this card's slots, whose segments
    cover the S steps, each segment holding at least one."""
    dt, x, bm, cm, a_log, h0 = _ssm_case(S + 5, B, S, Di, N, dtype, gpu, extreme)
    inplace = h0.clone()
    y, h = ks.ssm_scan(dt, x, bm, cm, a_log, inplace, h_out=inplace)
    torch.cuda.synchronize()
    assert h is inplace
    slots = ks.output_slots(dt.device.index, dtype, N)
    n_seg, seg_len = ks.ssm_segments(slots, B, Di, N, S)
    assert (n_seg - 1) * seg_len < S <= n_seg * seg_len
    y_ref, h_ref = ks.ref_ssm_scan(dt, x, bm, cm, a_log, h0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, y_ref, atol=SSM_TOL[0], rtol=SSM_TOL[1])
    torch.testing.assert_close(h, h_ref, atol=SSM_TOL[0], rtol=SSM_TOL[1])


def test_ssm_kernel_rejects_what_it_does_not_take(gpu):
    dt, x, bm, cm, a_log, h0 = _ssm_case(0, 1, 8, 64, 16, torch.float32, gpu)
    with pytest.raises(ValueError):      # a state size the kernel is not built for
        ks.ssm_scan(dt, x, bm[..., :12].contiguous(), cm[..., :12].contiguous(), a_log[:, :12])
    with pytest.raises(ValueError):      # inputs in different dtypes
        ks.ssm_scan(dt, x.bfloat16(), bm, cm, a_log)
    with pytest.raises(ValueError):      # a dtype the kernel is not built for
        ks.ssm_scan(*(t.half() for t in (dt, x, bm, cm)), a_log)
    with pytest.raises(ValueError):      # a non-contiguous input
        ks.ssm_scan(dt.transpose(1, 2).contiguous().transpose(1, 2), x, bm, cm, a_log)
    with pytest.raises(ValueError):      # an h0 of another shape
        ks.ssm_scan(dt, x, bm, cm, a_log, h0[:, :32].contiguous())
    with pytest.raises(ValueError):      # an h0 in bf16
        ks.ssm_scan(dt, x, bm, cm, a_log, h0.bfloat16())
    with pytest.raises(ValueError):      # mixed devices
        ks.ssm_scan(dt, x, bm.cpu(), cm, a_log)
    with pytest.raises(ValueError):      # no time steps
        ks.ssm_scan(*(t[:, :0].contiguous() for t in (dt, x, bm, cm)), a_log)


# ------------------------------------------- int8 pools and swap on the card
def _engine_run(device, seed, plans=None, **kw):
    """The invariant harness's long-decode workload (a 6-block pool: decodes
    run it dry and preempt) on the smollm-135m smoke model in float32, with
    the weights drawn on the CPU from one seed. ``plans`` (a list) collects
    the StepPlans of an interleaved engine."""
    import numpy as np

    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    cfg = smoke_variant(get_arch("smollm-135m"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    eng = GenerationEngine(cfg, params=params, device=device, max_batch=3,
                           max_seq=96, prefill_chunk_size=16, token_budget=20, **kw)
    if plans is not None and eng.interleave:
        eng.control.recorded = plans
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(4):
        for _ in range(int(rng.integers(1, 4))):
            prompt = rng.integers(0, 90, size=int(rng.integers(3, 13)))
            reqs.append(eng.submit(prompt, max_new=int(rng.integers(28, 39))))
        for _ in range(int(rng.integers(0, 4))):
            eng.step()
    eng.run_until_done(max_steps=2000)
    return eng, [r.out_tokens for r in reqs]


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(n_blocks=6, preempt="swap"),
                                dict(n_blocks=6, preempt="swap", kv_dtype="int8")],
                         ids=["int8", "swap", "swap-int8"])
def test_int8_and_swap_engines_on_the_card_match_the_cpu(gpu, kw):
    """The engine's int8 pools (both paged kernels on their int8 route) and
    a swap round trip through the host tier's pinned slabs give the CPU's
    greedy tokens and counters. The K/V the two devices quantize come from
    float32 stacks that sum in different orders, so int8 payloads agree
    within one code and scales (absmax / 127) at 1e-5 relative, the null
    block (only pads write it) aside; on identical inputs the quantized
    write is exact (``test_quantized_scatter_on_the_card_is_exact``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ka.reset_launch_counts()
    runs = {dev: _engine_run(dev, 5, **kw) for dev in ("cpu", "cuda")}
    (ceng, ctoks), (geng, gtoks) = runs["cpu"], runs["cuda"]
    assert gtoks == ctoks
    assert ka.paged_chunk_attention.launches > 0 and ka.paged_decode_attention.launches > 0
    for key in ("steps", "preemptions", "swap_outs", "swap_ins", "prefill_tokens"):
        assert geng.stats()[key] == ceng.stats()[key], key
    if "preempt" in kw:
        assert geng.swap_outs >= 1 and geng.swap_ins == geng.swap_outs
        assert geng.host_store.n_swapped == 0 and geng.host_store.k.is_pinned()
    if kw.get("kv_dtype") == "int8":
        for a, b in ((ceng.kv.k, geng.kv.k), (ceng.kv.v, geng.kv.v)):
            assert int((a[:, 1:].int() - b.cpu()[:, 1:].int()).abs().max()) <= 1
        for a, b in ((ceng.kv.k_scale, geng.kv.k_scale), (ceng.kv.v_scale, geng.kv.v_scale)):
            torch.testing.assert_close(b.cpu()[:, 1:], a[:, 1:], rtol=1e-5, atol=0)


@pytest.mark.parametrize("ties", [False, True])
def test_quantized_scatter_on_the_card_is_exact(gpu, ties):
    """The quantized scatter on the card and on the CPU, on identical
    inputs: int8 payloads and scales bit for bit. ``ties`` puts every entry
    exactly on a .5 code (scale 2**-7: one entry of +-127/128 a lane and
    head, the rest (n + 0.5)/128), which both round to the even code."""
    from repro_torch.serving.paged_cache import _quantized_scatter

    g = torch.Generator().manual_seed(3)
    G, nb, bs, kvh, hd = 2, 64, 16, 2, 128
    if ties:
        pool = torch.zeros((G, nb, bs, kvh, hd), dtype=torch.int8)
        sc = torch.zeros((G, nb, kvh))
        dest = torch.arange(1, nb) * bs + torch.randint(0, bs, (nb - 1,), generator=g)
        n = torch.randint(-127, 127, (G, nb - 1, kvh, hd), generator=g)
        vals = (n + 0.5) / 128.0
        vals[..., 0] = 127.0 / 128.0
    else:
        pool = torch.randint(-127, 128, (G, nb, bs, kvh, hd), generator=g, dtype=torch.int8)
        sc = torch.rand((G, nb, kvh), generator=g) * 0.02
        sc[:, :8] = 0.0
        dest = torch.randint(0, nb * bs, (300,), generator=g)
        vals = torch.randn((G, 300, kvh, hd), generator=g) * 3.0
    cpu = (pool.clone(), sc.clone())
    card = (pool.to(gpu), sc.to(gpu))
    _quantized_scatter(*cpu, dest, vals)
    _quantized_scatter(*card, dest.to(gpu), vals.to(gpu))
    torch.cuda.synchronize()
    assert torch.equal(card[1].cpu(), cpu[1])
    if ties:
        assert torch.equal(card[0].cpu(), cpu[0])
        assert bool((cpu[0].view(G, -1, kvh, hd)[:, dest, :, 1:] % 2 == 0).all())
    else:   # slots named twice take either write; compare the rest
        once = torch.bincount(dest, minlength=nb * bs) <= 1
        a, b = (t.view(G, nb * bs, kvh, hd)[:, once] for t in (cpu[0], card[0].cpu()))
        assert torch.equal(a, b)


# ----------------------------------- the oracle paths and kvsan on the card
ORACLES = {"padded": dict(ragged=False, kernel="reference"),
           "sequential": dict(interleave=False),
           "sequential-reference": dict(interleave=False, kernel="reference")}


@pytest.mark.parametrize("n_blocks", [None, 6], ids=["full-pool", "swap"])
@pytest.mark.parametrize("oracle", sorted(ORACLES))
def test_oracle_paths_on_the_card_match_the_kernel_path(gpu, oracle, n_blocks):
    """At smoke width in float32 on the card: the padded oracle (fused
    steps through the gathered views, decode through the gather oracle and
    the dense decode kernel) and the sequential path give the packed kernel
    path's greedy tokens and counters; the padded plans are the packed
    plans' rows, starts and n_valid step for step. Launches: the padded
    oracle runs no paged kernel and one dense decode per layer and decode
    plan; the sequential path one paged (or, with the reference selector,
    dense) decode per layer and step, and no chunk kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(n_blocks=n_blocks, preempt="swap") if n_blocks else {}
    kplans, oplans = [], []
    ka.reset_launch_counts()
    keng, ktoks = _engine_run("cuda", 5, plans=kplans, **kw)
    assert ka.paged_chunk_attention.launches > 0 and ka.decode_attention.launches == 0
    ka.reset_launch_counts()
    oeng, otoks = _engine_run("cuda", 5, plans=oplans, **kw, **ORACLES[oracle])
    assert otoks == ktoks
    for key in ("preemptions", "swap_outs", "swap_ins", "prefill_tokens", "tokens_out"):
        assert oeng.stats()[key] == keng.stats()[key], key
    L = oeng.cfg.num_layers
    assert ka.paged_chunk_attention.launches == 0
    if oracle == "padded":
        assert len(oplans) == len(kplans) == oeng.steps
        for kp, op in zip(kplans, oplans):
            diff = padded_plan_difference(kp, op)
            assert diff is None, diff
        n_decode = sum(p.kind == "decode" for p in oplans)
        assert ka.paged_decode_attention.launches == 0
        assert ka.decode_attention.launches == L * n_decode
    else:
        assert not oplans and not oeng.interleave
        dense = oracle == "sequential-reference"
        assert ka.paged_decode_attention.launches == (0 if dense else L * oeng.steps)
        assert ka.decode_attention.launches == (L * oeng.steps if dense else 0)
    pool = oeng.kv.pool
    assert pool.n_free == pool.n_blocks - 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_sanitized_swap_run_on_the_card(gpu, kv_dtype):
    """The long-decode workload under swap preemption with the KV sanitizer
    on: the pinned, non-blocking device->host copies drain through the copy
    engine with no lifecycle violation, and the shadow agrees with the pool
    and the host store at the drain; the tokens are the unsanitized run's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(n_blocks=6, preempt="swap", kv_dtype=kv_dtype)
    _, plain = _engine_run("cuda", 5, **kw)
    eng, toks = _engine_run("cuda", 5, sanitize=True, **kw)
    assert toks == plain
    san = eng.sanitizer
    assert san is not None and san.violations == 0
    for hook in ("device_alloc", "host_reserve", "host_restore", "copy_submit"):
        assert san.op_counts.get(hook, 0) > 0, hook
    shadow = san.stats()
    assert shadow["device_allocated"] == 1
    assert shadow["device_warm"] == len(eng.kv.pool.cached)
    assert shadow["copy_pending"] == 0
    san.audit_host(eng.host_store)
    assert eng.host_store.k.is_pinned() and eng.host_store.n_swapped == 0


# ------------------------------- sliding-window stacks and MoE on the card
@pytest.mark.parametrize("H,KVH", [(48, 8), (16, 2)], ids=["G6", "G8"])  # mixtral, qwen2.5-3b
@pytest.mark.parametrize("S", [4097, 6000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_flash_kernel_at_a_4096_window(gpu, dtype, S, H, KVH):
    """The prefill of qwen2.5-3b-swa and mixtral-8x22b: hd 128, window 4096,
    S past the window and no multiple of the kernel's tile, where the
    causal block skip and the window's lower edge meet."""
    g = torch.Generator().manual_seed(S + H)
    q = torch.randn((1, S, H, 128), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((1, S, KVH, 128), generator=g).to(dtype).to(gpu) for _ in range(2))
    before = kf.flash_attention.launches
    got = kf.flash_attention(q, k, v, window=4096)
    torch.cuda.synchronize()
    assert kf.flash_attention.launches == before + 1
    atol, rtol = TOL[(dtype, dtype)]
    want = kf.ref_flash_attention(q, k, v, window=4096)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        want = kf.ref_flash_attention(q.float(), k.float(), v.float(), window=4096)
        torch.testing.assert_close(got.float(), want, atol=BF16_OUT_TOL[0], rtol=BF16_OUT_TOL[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_on_a_wrapped_ring_at_mixtral_heads(gpu, dtype):
    """mixtral-8x22b's decode: H 48 over KVH 8 (G = 6 in the m16 tile), hd
    128, a 4096-slot ring whose lengths min(pos + 1, 4096) saturate at the
    ring once it has wrapped, beside rows that have not."""
    lengths = [4096, 4096, 1, 4096, 4095, 4096, 300, 4096]
    g = torch.Generator().manual_seed(48)
    B = len(lengths)
    q = torch.randn((B, 48, 128), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((B, 4096, 8, 128), generator=g).to(dtype).to(gpu) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=gpu)
    before = ka.decode_attention.launches
    got = ka.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ka.decode_attention.launches == before + 1
    _close(got, ka.ref_decode_attention(q, k, v, lens), slice(None), DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
        _close(got, want, slice(None), BF16_OUT_TOL)


@pytest.mark.parametrize("arch", ["qwen2.5-3b-swa", "mixtral-8x22b"])
def test_swa_and_moe_engines_on_the_card_match_the_cpu(gpu, arch):
    """The smoke variant (window 64; mixtral 4 experts, top-2) in float32 on
    the dense backend: prompts short of, at and past the window, and decodes
    that wrap the ring, give the CPU's greedy tokens; one windowed flash a
    layer and prefill, one dense decode a layer and step."""
    import numpy as np

    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_arch(arch))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 23, 60, 64, 70, 100, 200)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, max_batch=3, max_seq=256)
        kf.reset_launch_counts()
        ka.reset_launch_counts()
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        assert eng.backend == "dense" and all(len(r.out_tokens) == 12 for r in reqs)
        out[dev] = [r.out_tokens for r in reqs]
    L = cfg.num_layers
    assert kf.flash_attention.launches == L * len(prompts)
    assert ka.decode_attention.launches == L * eng.steps
    assert out["cuda"] == out["cpu"]


# ------------------------- chunked-local stacks (llama4) and MLA (minicpm3)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk,H,KVH,hd", [
    (1000, 200, 40, 8, 128),    # llama4's heads; query tiles straddle every boundary
    (200, 64, 8, 2, 64),        # the smoke variant's chunk: tile-aligned chunks
    (300, 33, 8, 2, 64),        # a chunk shorter than the 64-row tile
    (130, 100, 8, 2, 128),      # one boundary, inside the second tile
    (37, 8192, 8, 2, 128),      # S below the chunk: plain causal attention
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_flash_kernel_matches_plain_version(gpu, dtype, S, chunk, H, KVH, hd, causal):
    g = torch.Generator().manual_seed(S + chunk + causal)
    q = torch.randn((1, S, H, hd), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((1, S, KVH, hd), generator=g).to(dtype).to(gpu) for _ in range(2))
    before = kf.flash_attention.launches
    got = kf.flash_attention(q, k, v, causal=causal, chunk=chunk)
    torch.cuda.synchronize()
    assert kf.flash_attention.launches == before + 1
    _close(got, kf.ref_flash_attention(q, k, v, causal, chunk=chunk), slice(None),
           DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = kf.ref_flash_attention(q.float(), k.float(), v.float(), causal, chunk=chunk)
        _close(got, want, slice(None), BF16_OUT_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 37, 64, 65, 200, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_head_dim_flash_kernel_matches_plain_version(gpu, dtype, S, causal):
    """minicpm3's MLA prefill: 40 heads, query/key head dim 96 (nope 64 +
    rope 32), value head dim 64, scale 1/sqrt(96)."""
    g = torch.Generator().manual_seed(S + causal)
    q, k = (torch.randn((1, S, 40, 96), generator=g).to(dtype).to(gpu) for _ in range(2))
    v = torch.randn((1, S, 40, 64), generator=g).to(dtype).to(gpu)
    before = kf.flash_attention.launches
    got = kf.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kf.flash_attention.launches == before + 1 and tuple(got.shape) == (1, S, 40, 64)
    _close(got, kf.ref_flash_attention(q, k, v, causal), slice(None), DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = kf.ref_flash_attention(q.float(), k.float(), v.float(), causal)
        _close(got, want, slice(None), BF16_OUT_TOL)


def test_flash_kernel_refuses_what_the_new_masks_do_not_take(gpu):
    q = torch.randn((1, 16, 4, 48), device=gpu)
    v = torch.randn((1, 16, 4, 32), device=gpu)
    with pytest.raises(ValueError):      # MLA's smoke dims (48, 32): no instantiation
        kf.flash_attention(q, q, v)
    q = torch.randn((1, 16, 4, 64), device=gpu)
    with pytest.raises(ValueError):      # a window and a chunk together
        kf.flash_attention(q, q, q, window=4, chunk=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sc,lengths", [
    # an 8192-slot chunk ring: lengths pos % 8192 + 1 (a full chunk, a new
    # chunk's first slot, the 9000- and 12500-token prompts' 808 and 4308)
    (8192, [8192, 1, 808, 4308, 8192, 2, 100, 4097]),
    # a global layer's 16384-slot cache: lengths pos + 1
    (16384, [12532, 9031, 1, 16384, 5000, 129, 777, 2048]),
])
def test_dense_decode_kernel_on_llama4_caches(gpu, dtype, Sc, lengths):
    """llama4-scout's decode: H 40 over KVH 8 (G = 5 in the m16 tile), hd
    128, on a chunk ring and on a global cache."""
    g = torch.Generator().manual_seed(Sc)
    B = len(lengths)
    q = torch.randn((B, 40, 128), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((B, Sc, 8, 128), generator=g).to(dtype).to(gpu) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=gpu)
    before = ka.decode_attention.launches
    got = ka.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ka.decode_attention.launches == before + 1
    _close(got, ka.ref_decode_attention(q, k, v, lens), slice(None), DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
        _close(got, want, slice(None), BF16_OUT_TOL)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "minicpm3-4b"])
def test_chunked_and_mla_engines_on_the_card_match_the_cpu(gpu, arch):
    """The smoke variants in float32 on the dense backend (llama4: chunk 64,
    a chunked and a global layer, top-1 MoE with a shared expert): prompts
    short of, at and past the chunk give the CPU's greedy tokens; one flash
    a layer and prefill; llama4 one dense decode a layer and step, MLA's
    absorbed decode none."""
    import numpy as np

    from repro_torch.configs import card_smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = card_smoke_variant(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 64, 100, 128, 150, 200)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, max_batch=3, max_seq=256)
        kf.reset_launch_counts()
        ka.reset_launch_counts()
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        assert eng.backend == "dense" and all(len(r.out_tokens) == 12 for r in reqs)
        out[dev] = [r.out_tokens for r in reqs]
    L = cfg.num_layers
    assert kf.flash_attention.launches == L * len(prompts)
    mla = arch == "minicpm3-4b"
    assert ka.decode_attention.launches == (0 if mla else L * eng.steps)
    assert out["cuda"] == out["cpu"]


# ------------- whisper's cross attention, internvl2's heads, the int8 dense cache
@pytest.mark.parametrize("S", [1, 37, 448])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_flash_kernel_matches_plain_version(gpu, dtype, S):
    """whisper's cross attention: S decoder queries over the encoder's 1500
    keys (23.4 tiles of 64), non-causal, H 20 = KVH 20, hd 64, B 2."""
    g = torch.Generator().manual_seed(S)
    q = torch.randn((2, S, 20, 64), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((2, 1500, 20, 64), generator=g).to(dtype).to(gpu) for _ in range(2))
    before = kf.flash_attention.launches
    got = kf.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kf.flash_attention.launches == before + 1 and tuple(got.shape) == (2, S, 20, 64)
    _close(got, kf.ref_flash_attention(q, k, v, False), slice(None), DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = kf.ref_flash_attention(q.float(), k.float(), v.float(), False)
        _close(got, want, slice(None), BF16_OUT_TOL)


@pytest.mark.parametrize("S,S_kv", [(64, 65), (100, 37), (5, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_flash_kernel_at_tile_edges(gpu, dtype, S, S_kv):
    """Keys one past a tile, fewer keys than queries, one whole tile of
    keys; GQA (8 heads over 2)."""
    g = torch.Generator().manual_seed(S + S_kv)
    q = torch.randn((2, S, 8, 64), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((2, S_kv, 2, 64), generator=g).to(dtype).to(gpu) for _ in range(2))
    got = kf.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _close(got, kf.ref_flash_attention(q, k, v, False), slice(None), DENSE_TOL[dtype])


def test_flash_kernel_refuses_what_the_cross_form_does_not_take(gpu):
    q = torch.randn((1, 16, 4, 64), device=gpu)
    kv = torch.randn((1, 40, 4, 64), device=gpu)
    launches = kf.flash_attention.launches
    for kw in ({"causal": True}, {"causal": False, "window": 8}, {"causal": False, "chunk": 8}):
        with pytest.raises(ValueError):
            kf.flash_attention(q, kv, kv, **kw)
    q128, kv128 = torch.randn((1, 16, 4, 128), device=gpu), torch.randn((1, 40, 4, 128),
                                                                       device=gpu)
    with pytest.raises(ValueError):      # the cross form is instantiated at hd 64 only
        kf.flash_attention(q128, kv128, kv128, causal=False)
    assert kf.flash_attention.launches == launches


@pytest.mark.parametrize("H,KVH,Sc,lengths", [
    (20, 20, 1500, [1500] * 8),                              # whisper's cross cache: G 1
    (20, 20, 448, [448, 1, 37, 200, 447, 64, 65, 300]),      # whisper's self-attention: G 1
    (14, 2, 2048, [2048, 256, 257, 300, 1, 1100, 777, 290]), # internvl2: G 7
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_at_single_and_seven_head_groups(gpu, dtype, H, KVH, Sc, lengths):
    g = torch.Generator().manual_seed(Sc + H)
    B = len(lengths)
    q = torch.randn((B, H, 64), generator=g).to(dtype).to(gpu)
    k, v = (torch.randn((B, Sc, KVH, 64), generator=g).to(dtype).to(gpu) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=gpu)
    before = ka.decode_attention.launches
    got = ka.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ka.decode_attention.launches == before + 1
    _close(got, ka.ref_decode_attention(q, k, v, lens), slice(None), DENSE_TOL[dtype])
    if dtype == torch.bfloat16:
        want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
        _close(got, want, slice(None), BF16_OUT_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_quantize_kv_on_the_card_is_exact(gpu, dtype):
    """The int8 dense cache's quantizer on the card and on the CPU, on the
    same K/V: codes and scales bit for bit (zero slots, .5 ties and a
    spread of magnitudes among them)."""
    from repro_torch.models.transformer import dequantize_kv, quantize_kv

    g = torch.Generator().manual_seed(7)
    x = torch.randn((8, 300, 2, 64), generator=g) * torch.rand((8, 300, 2, 1), generator=g) * 20
    x[0, :5] = 0.0
    x[1, 0, 0] = torch.cat([torch.tensor([127.0]), torch.arange(63) - 31.5])
    x = x.to(dtype)
    qc, sc = quantize_kv(x)
    qg, sg = quantize_kv(x.to(gpu))
    torch.testing.assert_close(qg.cpu(), qc, rtol=0, atol=0)
    torch.testing.assert_close(sg.cpu(), sc, rtol=0, atol=0)
    torch.testing.assert_close(dequantize_kv(qg, sg, dtype).cpu(), dequantize_kv(qc, sc, dtype),
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch,quant", [("internvl2-1b", False), ("whisper-large-v3", False),
                                        ("smollm-135m", True)])
def test_new_model_paths_on_the_card_match_the_cpu(gpu, arch, quant):
    """The smoke variants in float32: internvl2 with patch embeddings and
    whisper with frames through ``prefill`` then eight ``decode_step``
    (teacher-forced, at absolute positions), and smollm on the int8 dense
    cache likewise: the CPU's logits within 1e-4 (1e-3 through int8 codes)
    and, for the kernels, one
    flash a layer (whisper: encoder layers too, and a second, cross, one a
    decoder layer) and one dense decode a layer and step (whisper: two)."""
    import numpy as np

    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_arch(arch)).replace(kv_cache_quant=quant)
    rng = np.random.default_rng(5)
    B, Lp, n_new = 3, 21, 8
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, Lp + n_new)).astype(np.int32))
    batch = {"tokens": tokens[:, :Lp]}
    P = cfg.num_patch_tokens
    if P:
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    logits = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        kf.reset_launch_counts()
        ka.reset_launch_counts()
        last, pc = prefill(cfg, params, {k: t.to(dev) for k, t in batch.items()})
        cache = init_cache(cfg, B, P + Lp + n_new, dev)
        for name, t in pc[0].items():
            cache[0][name][:, :, :t.shape[2]] = t
        out = [last]
        for i in range(n_new):
            pos = torch.full((B,), P + Lp + i, dtype=torch.int32, device=dev)
            step, _ = decode_step(cfg, params, cache, tokens[:, Lp + i:Lp + i + 1].to(dev), pos)
            out.append(step)
        logits[dev] = torch.stack(out).cpu()
    L, enc = cfg.num_layers, cfg.encoder_layers
    cross = 2 if cfg.is_encoder_decoder else 1
    assert kf.flash_attention.launches == cross * L + enc
    assert ka.decode_attention.launches == cross * L * n_new
    # the int8 cache's codes may land one apart (the float K/V differ by
    # summation order), which moves the smoke model's logits by ~4e-4
    tol = 1e-3 if quant else 1e-4
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=tol, atol=tol)


# ------------------------------- the step audit and DP replicas on the card
def _smoke_cfg(dtype):
    from repro_torch.configs import get_arch, smoke_variant

    return smoke_variant(get_arch("smollm-135m")).replace(dtype=dtype)


def _card_engine(cfg, params=None, **kw):
    from repro_torch.serving.engine import GenerationEngine

    return GenerationEngine(cfg, params=params, device="cuda", max_batch=2, max_seq=64,
                            prefill_chunk_size=16, token_budget=20, **kw)


@pytest.mark.parametrize("dtype,kv_dtype", [("bfloat16", None), ("bfloat16", "int8"),
                                            ("float32", None)])
def test_step_audit_is_clean_on_the_card(gpu, dtype, kv_dtype):
    """Every step program of the smoke engine, under
    ``set_sync_debug_mode("error")``: collective-free, no host sync, the
    int8 pools reaching both paged kernels un-upcast, only warmed packed
    lengths and no kernel library built during the audited steps (every
    library is built first, as ``chip_smoke.py`` builds them); the sync
    debug mode is restored."""
    from repro_torch.analysis.step_audit import audit_engine
    from repro_torch.kernels._build import build_all

    build_all()
    eng = _card_engine(_smoke_cfg(dtype), kv_dtype=kv_dtype)
    mode = torch.cuda.get_sync_debug_mode()
    ka.reset_launch_counts()
    report = audit_engine(eng)
    assert report.ok, report.render()
    assert torch.cuda.get_sync_debug_mode() == mode
    assert ka.paged_chunk_attention.launches > 0 and ka.paged_decode_attention.launches > 0
    flows = {f.program for f in report.findings if f.check == "int8-flow" and f.ok}
    assert flows == ({"fused_ragged", "decode"} if kv_dtype else set())
    sentinel = [f for f in report.findings if f.check == "cache-sentinel"][0]
    assert "0 kernel libraries built" in sentinel.detail


@pytest.mark.parametrize("mid,check", [("audit-collective", "collectives"),
                                       ("audit-host-sync", "host-sync"),
                                       ("audit-int8-upcast", "int8-flow"),
                                       ("audit-cache-buckets", "cache-sentinel")])
def test_audit_mutations_are_caught_on_the_card(gpu, mid, check, capsys):
    """The four seeded defects through the CLI on the card (exit 1, the
    expected check failing); the sync debug mode is restored."""
    from repro_torch.analysis.__main__ import main
    from repro_torch.kernels._build import build_all

    build_all()
    mode = torch.cuda.get_sync_debug_mode()
    assert main(["audit", "--mutate", mid]) == 1
    out = capsys.readouterr().out
    failed = [ln for ln in out.splitlines() if ln.startswith("[FAIL]")]
    assert failed and all(ln.split()[2] == check for ln in failed), out
    assert torch.cuda.get_sync_debug_mode() == mode


def _serve_waves(submit, run, waves, prompts):
    out = {}
    for wave in waves:
        reqs = {i: submit(i, prompts[i]) for i in wave}
        run()
        out.update({i: r for i, r in reqs.items() if r is not None})
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_dp_group_on_the_card_matches_lone_engines(gpu, kv_dtype):
    """Two replicas over one pool box on the card, float32 at smoke width:
    without a host tier each replica's greedy tokens equal, bit for bit, a
    lone engine's replaying its share of the prompts wave by wave; with a
    shared write-through host tier, replica 1 host-hits the document
    replica 0 prefilled. Ownership stays disjoint and both pools drain."""
    import numpy as np

    from repro_torch.models import init_params
    from repro_torch.serving.engine import DataParallelEngineGroup, GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _smoke_cfg("float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    doc = rng.integers(0, cfg.vocab_size, 48)
    prompts = [np.concatenate([doc, rng.integers(0, cfg.vocab_size, 5 + 3 * i)])
               for i in range(4)] + [rng.integers(0, cfg.vocab_size, 20 + 7 * i)
                                     for i in range(4)]
    waves = ((0, 4), (5, 1, 6, 2, 7, 3))
    kw = dict(max_batch=2, max_seq=128, prefill_chunk_size=16, token_budget=20,
              kv_dtype=kv_dtype)
    for host_blocks in (None, 32):
        grp = DataParallelEngineGroup(cfg, dp=2, params=params, device="cuda",
                                      host_blocks=host_blocks, **kw)
        owner = {}

        def submit(i, p):
            r = grp.submit(p, max_new=8)
            owner[i] = next(k for k, e in enumerate(grp.engines)
                            if any(x is r for x in e.waiting))
            return r

        reqs = _serve_waves(submit, grp.run_until_done, waves, prompts)
        e0, e1 = grp.engines
        assert e0.kv._arrays is e1.kv._arrays and e0.params is e1.params
        pools = [e.kv.pool for e in grp.engines]
        owned = [set(p.free_list) | set(p.refcounts) | set(p.cached) for p in pools]
        assert not owned[0] & owned[1]
        assert all(p.n_free == p.n_owned - 1 for p in pools)
        assert all(len(r.out_tokens) == 8 for r in reqs.values())
        if host_blocks is None:
            for rank in range(2):
                lone = GenerationEngine(cfg, params=params, device="cuda", **kw)
                got = _serve_waves(
                    lambda i, p: lone.submit(p, max_new=8) if owner[i] == rank else None,
                    lone.run_until_done, waves, prompts)
                for i, r in got.items():
                    assert r.out_tokens == reqs[i].out_tokens, (rank, i)
        else:
            st = grp.stats()
            assert st["cross_replica_host_hits"] > 0 and st["host_hit_tokens"] > 0
            assert grp.host_store.k.is_pinned()


# ---------------------------------------------------------------------------
# training: the flash backward kernel and the forward-only wrappers' guards
# ---------------------------------------------------------------------------

# (atol as a share of max(1, max |want|), rtol) of the backward kernel
# against ref_flash_attention_backward on the same inputs: float32, the
# summation order; bfloat16, one rounding of the f32 result to bf16 apart
# (at most 2**-7 of the value), both sides computing in f32
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2 ** -7)}


def _backward_inputs(B, S, H, KVH, hd, dtype, seed=0, S_kv=None, hd_v=None, **form):
    g = torch.Generator(device="cuda").manual_seed(seed)
    S_kv, hd_v = S_kv or S, hd_v or hd
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S_kv, KVH, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S_kv, KVH, hd_v), generator=g, device="cuda").to(dtype)
    out = kf.flash_attention(q, k, v, **form)
    dout = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    return q, k, v, out, dout


def _backward_excess(got, want, dtype):
    """The largest |got - want| over its bound (> 1: outside)."""
    share, rtol = BWD_TOL[dtype]
    got, want = got.float(), want.float()
    bound = share * max(1.0, float(want.abs().max())) + rtol * want.abs()
    return float(((got - want).abs() / bound).max())


@pytest.mark.parametrize("B,S", [(2, 1), (2, 37), (2, 1000), (1, 2048), (8, 256)])
@pytest.mark.parametrize("H,KVH,hd", [(16, 2, 128), (9, 3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain_version(gpu, dtype, H, KVH, hd, B, S):
    """qwen2.5-3b's heads (G 8, hd 128) and smollm-135m's (G 3, hd 64), at
    ragged S, the training microbatch (B 1, S 2048) and smollm's training
    batch (B 8, S 256); deterministic (no atomics: two calls equal)."""
    q, k, v, out, dout = _backward_inputs(B, S, H, KVH, hd, dtype)
    before = kf.flash_attention_backward.launches
    got = kf.flash_attention_backward(q, k, v, out, dout)
    again = kf.flash_attention_backward(q, k, v, out, dout)
    torch.cuda.synchronize()
    assert kf.flash_attention_backward.launches == before + 2
    want = kf.ref_flash_attention_backward(q, k, v, out, dout)
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.isfinite(a.float()).all(), name
        assert torch.equal(a, a2), name
        assert _backward_excess(a, w, dtype) <= 1.0, name


# (name, B, H, KVH, hd, hd_v, S_kv or None, form): hymba's heads at window
# 1024; qwen2.5-3b-swa's at window 4096; chunk 800 at H 40 / KVH 8 (tiles
# straddle chunk boundaries); whisper's cross attention over 1500 frames;
# minicpm3's (96, 64); and the non-causal self-attention forms
BACKWARD_FORMS = [
    ("window1024", 1, 25, 5, 64, 64, None, dict(window=1024)),
    ("window4096", 1, 16, 2, 128, 128, None, dict(window=4096)),
    ("chunk800", 1, 40, 8, 128, 128, None, dict(chunk=800)),
    ("cross1500", 8, 20, 20, 64, 64, 1500, dict(causal=False)),
    ("mla", 1, 40, 40, 96, 64, None, {}),
    ("mla_chunk200", 1, 40, 40, 96, 64, None, dict(chunk=200)),
    ("noncausal", 2, 9, 3, 64, 64, None, dict(causal=False)),
    ("noncausal_window100", 2, 9, 3, 64, 64, None, dict(causal=False, window=100)),
    ("noncausal_chunk50", 2, 16, 2, 128, 128, None, dict(causal=False, chunk=50)),
]
BACKWARD_FORM_S = {"window1024": 1664, "window4096": 6000, "chunk800": 2048, "cross1500": 448,
                   "mla": 2048, "mla_chunk200": 1000}


@pytest.mark.parametrize("S", ["main", 1, 37, 1000])
@pytest.mark.parametrize("case", BACKWARD_FORMS, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_forms_match_plain_version(gpu, dtype, case, S):
    """Every form of the forward kernel: the kernel against its plain
    version at the form's main shape and at ragged S, within ``BWD_TOL``;
    deterministic (two calls equal)."""
    name, B, H, KVH, hd, hd_v, S_kv, form = case
    S = BACKWARD_FORM_S.get(name, 300) if S == "main" else S
    if name == "window4096" and S != 6000:
        B = 2
    q, k, v, out, dout = _backward_inputs(B, S, H, KVH, hd, dtype, seed=S, S_kv=S_kv,
                                          hd_v=hd_v, **form)
    got = kf.flash_attention_backward(q, k, v, out, dout, **form)
    again = kf.flash_attention_backward(q, k, v, out, dout, **form)
    torch.cuda.synchronize()
    want = kf.ref_flash_attention_backward(q, k, v, out, dout, **form)
    for g_name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and a.shape == w.shape, g_name
        assert torch.isfinite(a.float()).all(), g_name
        assert torch.equal(a, a2), g_name
        assert _backward_excess(a, w, dtype) <= 1.0, g_name


@pytest.mark.parametrize("case", BACKWARD_FORMS, ids=lambda c: c[0])
def test_flash_backward_forms_catch_faulted_controls(gpu, case):
    """bf16 at each form: dv scaled by 1 + 2**-5 and the plain version with
    delta dropped land above the bound."""
    name, B, H, KVH, hd, hd_v, S_kv, form = case
    q, k, v, out, dout = _backward_inputs(B, 300, H, KVH, hd, torch.bfloat16, seed=3,
                                          S_kv=S_kv, hd_v=hd_v, **form)
    dq, dk, dv = kf.flash_attention_backward(q, k, v, out, dout, **form)
    want = kf.ref_flash_attention_backward(q, k, v, out, dout, **form)
    assert _backward_excess((dv.float() * (1 + 2 ** -5)).bfloat16(), want[2], torch.bfloat16) > 1
    faulted = kf.ref_flash_attention_backward(q, k, v, torch.zeros_like(out), dout, **form)
    assert _backward_excess(dq, faulted[0], torch.bfloat16) > 1.0
    assert _backward_excess(dk, faulted[1], torch.bfloat16) > 1.0


@pytest.mark.parametrize("form", [(2048, 2048, 1, 0, 0), (1664, 1664, 1, 1024, 0),
                                  (6000, 6000, 1, 4096, 0), (2048, 2048, 1, 0, 800),
                                  (1000, 1000, 0, 0, 50), (1000, 1000, 0, 100, 0),
                                  (448, 1500, 0, 0, 0), (37, 1500, 0, 0, 0), (1, 1, 1, 0, 0)])
def test_backward_tile_ranges_mirror_the_kernel(gpu, form):
    """``kv_tiles`` and ``q_tiles`` (the rule the CPU tests hold to the
    plain mask) are the kernels' own ranges (``fb_tile_ranges``)."""
    S, S_kv, causal, window, chunk = form
    kv, qs = kf.kernel_tile_ranges(S, S_kv, causal, window, chunk)
    assert kv == [kf.kv_tiles(t, *form) for t in range(len(kv))]
    assert qs == [kf.q_tiles(t, *form) for t in range(len(qs))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_bound_catches_faulted_controls(gpu, dtype):
    """The bound is tight enough to see dv scaled by 1 + 2**-7 (float32;
    bf16 rounds it to one or two ulps, so 1 + 2**-5 there) and the plain
    version with delta dropped (dq and dk)."""
    q, k, v, out, dout = _backward_inputs(2, 300, 16, 2, 128, dtype, seed=1)
    dq, dk, dv = kf.flash_attention_backward(q, k, v, out, dout)
    want = kf.ref_flash_attention_backward(q, k, v, out, dout)
    scale = 1 + (2 ** -7 if dtype == torch.float32 else 2 ** -5)
    assert _backward_excess((dv.float() * scale).to(dtype), want[2], dtype) > 1.0
    faulted = kf.ref_flash_attention_backward(q, k, v, torch.zeros_like(out), dout)
    assert _backward_excess(dq, faulted[0], dtype) > 1.0
    assert _backward_excess(dk, faulted[1], dtype) > 1.0


def test_trainable_flash_on_the_card_matches_autograd_of_the_plain_version(gpu):
    """float32: the Function's gradients (both kernels) against autograd
    through ``ref_flash_attention``."""
    q, k, v, _, dout = _backward_inputs(2, 200, 9, 3, 64, torch.float32, seed=2)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    out = kf.trainable_flash_attention(*a)
    assert out.grad_fn is not None
    out.backward(dout)
    kf.ref_flash_attention(*b).backward(dout)
    for x, y in zip(a, b):
        assert _backward_excess(x.grad, y.grad, torch.float32) <= 1.0


def _guarded_calls():
    """Each forward-only CUDA wrapper on small inputs, one of them requiring
    grad."""
    d = "cuda"
    f = lambda *s: torch.randn(*s, device=d)
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32, device=d)
    q3 = f(2, 4, 64).requires_grad_()
    pool = f(3, 16, 2, 64)
    return {
        "paged_decode_attention": lambda: ka.paged_decode_attention(
            q3, pool, pool, i32(2, 1), i32(2) + 1),
        "paged_chunk_attention": lambda: ka.paged_chunk_attention(
            q3, pool, pool, i32(2, 1), i32(2), i32(2), i32(2), i32(2)),
        "decode_attention": lambda: ka.decode_attention(q3, f(2, 16, 2, 64), f(2, 16, 2, 64),
                                                        i32(2) + 1),
        "flash_attention": lambda: kf.flash_attention(f(1, 8, 4, 64).requires_grad_(),
                                                      f(1, 8, 2, 64), f(1, 8, 2, 64)),
        "ssm_scan": lambda: ks.ssm_scan(f(1, 4, 64).requires_grad_(), f(1, 4, 64),
                                        f(1, 4, 16), f(1, 4, 16), f(64, 16)),
        "rwkv6_chunked": lambda: kw.rwkv6_chunked(f(1, 4, 2, 64).requires_grad_(),
                                                  f(1, 4, 2, 64), f(1, 4, 2, 64),
                                                  f(1, 4, 2, 64), f(2, 64)),
        "topk_retrieval": lambda: tk.topk_retrieval(f(2, 64).requires_grad_(), f(16, 64), 4),
    }


@pytest.mark.parametrize("name", sorted(["paged_decode_attention", "paged_chunk_attention",
                                         "decode_attention", "flash_attention", "ssm_scan",
                                         "rwkv6_chunked", "topk_retrieval"]))
def test_forward_only_wrappers_refuse_grad_on_the_card(gpu, name):
    """A forward-only kernel never returns a detached output under grad
    mode: a grad-requiring CUDA input raises, and under no_grad the same
    call runs."""
    call = _guarded_calls()[name]
    with pytest.raises(RuntimeError, match="forward-only"):
        call()
    with torch.no_grad():
        call()


@pytest.mark.parametrize("form", [dict(window=16, chunk=16), dict(hd=(32, 32)),
                                  dict(S_kv=20, causal=False, hd=(128, 128))])
def test_flash_forms_without_a_backward_raise_on_the_card(gpu, form):
    """Only the forms the forward kernel does not take either: a window
    with a chunk, head dims outside ``HEAD_DIMS``, cross attention at head
    dims other than ``CROSS_HEAD_DIMS``."""
    hd, hd_v = form.pop("hd", (64, 64))
    S_kv = form.pop("S_kv", 32)
    q = torch.randn(1, 32, 4, hd, device="cuda", requires_grad=True)
    k = torch.randn(1, S_kv, 2, hd, device="cuda")
    v = torch.randn(1, S_kv, 2, hd_v, device="cuda")
    with pytest.raises(NotImplementedError, match="backward on the card"):
        kf.trainable_flash_attention(q, k, v, **form)


@pytest.mark.parametrize("form", [dict(window=16), dict(chunk=16), dict(causal=False),
                                  dict(hd=(96, 64)), dict(S_kv=20, causal=False)])
def test_flash_forms_train_on_the_card(gpu, form):
    """float32: the Function's gradients at each form the forward kernel
    takes against autograd through ``ref_flash_attention``."""
    hd, hd_v = form.pop("hd", (64, 64))
    S_kv = form.pop("S_kv", 40)
    g = torch.Generator(device="cuda").manual_seed(4)
    ins = [torch.randn(s, generator=g, device="cuda")
           for s in ((1, 40, 4, hd), (1, S_kv, 2, hd), (1, S_kv, 2, hd_v))]
    dout = torch.randn((1, 40, 4, hd_v), generator=g, device="cuda")
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    kf.trainable_flash_attention(*a, **form).backward(dout)
    kf.ref_flash_attention(*b, **form).backward(dout)
    for x, y in zip(a, b):
        assert _backward_excess(x.grad, y.grad, torch.float32) <= 1.0


def test_smoke_train_steps_on_the_card_match_the_cpu(gpu):
    """smollm-135m's smoke variant in float32, two AdamW steps with two
    microbatches on the CPU (plain versions) and on the card (the flash
    kernel forward twice a layer and microbatch, remat included, and the
    backward kernel once): losses and grad norms within 1e-4."""
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import AdamW, cosine_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _smoke_cfg("float32")
    tokens = torch.randint(0, cfg.vocab_size, (2, 4, 64), generator=torch.Generator().manual_seed(3))
    results = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        opt = AdamW(lr=cosine_schedule(1e-3, warmup=1, total=2))
        state = opt.init(params)
        step = make_train_step(cfg, opt, microbatches=2)
        kf.reset_launch_counts()
        out = []
        for t in tokens:
            params, state, m = step(params, state, {"tokens": t.to(dev)})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        results[dev] = out
        if dev == "cuda":
            assert kf.flash_attention.launches == cfg.num_layers * 2 * 2 * 2
            assert kf.flash_attention_backward.launches == cfg.num_layers * 2 * 2
    for (l0, g0), (l1, g1) in zip(results["cpu"], results["cuda"]):
        assert l1 == pytest.approx(l0, rel=1e-4) and g1 == pytest.approx(g0, rel=1e-4)


# ---------------------------------------------------------------------------
# training: the backward kernels of the two scans
# ---------------------------------------------------------------------------

# the scans' backward kernels against their plain versions on the same
# inputs hold to BWD_TOL: float32 the summation order (the carries regroup
# the sums over the segments); bfloat16 one rounding of the f32 result to
# bf16 apart, both sides computing in f32
WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "dstate0")
SSM_GRADS = ("ddt", "dx", "dbm", "dcm", "da_log", "dh0")


def _wkv_backward_case(seed, B, S, H, hd, dtype, decay=None):
    r, k, v, w, u, state0 = _wkv_case(seed, B, S, H, hd, dtype, decay, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn((B, S, H, hd), generator=g, device="cuda")
    dstate = torch.randn((B, H, hd, hd), generator=g, device="cuda")
    return r, k, v, w, u, state0, dy, dstate


def _ssm_backward_case(seed, B, S, Di, N, dtype, extreme=False):
    dt, x, bm, cm, a_log, h0 = _ssm_case(seed, B, S, Di, N, dtype, "cuda", extreme)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn((B, S, Di), generator=g, device="cuda")
    dh = torch.randn((B, Di, N), generator=g, device="cuda")
    return dt, x, bm, cm, a_log, h0, dy, dh


def _check_backward(wrapper, ref, case, names, dtype):
    """The kernel against its plain version: one launch, every gradient
    finite, in its input's dtype and within BWD_TOL, equal bits on a second
    call. Returns the gradients."""
    before = wrapper.launches
    got = wrapper(*case)
    again = wrapper(*case)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    want = ref(*case)
    for name, a, a2, w in zip(names, got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.isfinite(a.float()).all(), name
        assert torch.equal(a, a2), f"{name} differs between two calls"
        tol_dtype = dtype if a.dtype == dtype else torch.float32
        assert _backward_excess(a, w, tol_dtype) <= 1.0, (name, _backward_excess(a, w, tol_dtype))
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,decay", [
    (1, 2048, 64, 64, None),    # rwkv6-7b's training microbatch
    (1, 1, 64, 64, None),
    (1, 37, 64, 64, None),      # S not a multiple of the 16-step chunk
    (1, 1000, 64, 64, None),
    (2, 100, 8, 32, None),      # the smoke variant's head_dim
    (2, 70, 4, 64, 1e-6),       # decays near 0
], ids=["train2048", "S1", "S37", "S1000", "hd32", "w1e-6"])
def test_wkv_backward_kernel_matches_plain_version(gpu, dtype, B, S, H, hd, decay):
    case = _wkv_backward_case(S + B, B, S, H, hd, dtype, decay)
    _check_backward(kw.rwkv6_chunked_backward, kw.ref_rwkv6_chunked_backward, case, WKV_GRADS,
                    dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,extreme", [
    (1, 2176, 1600, 16, False),   # hymba-1.5b's training microbatch: 128 meta + 2048 tokens
    (1, 1, 1600, 16, False),
    (1, 37, 1600, 16, True),      # S not a multiple of the 8-step chunk; extreme dt
    (1, 1000, 1600, 16, False),
    (2, 100, 256, 8, False),      # the smoke variant's width and state
    (3, 70, 100, 16, True),       # Di not a multiple of the block's 64 channels
], ids=["train2176", "S1", "S37", "S1000", "smoke", "Di100"])
def test_ssm_backward_kernel_matches_plain_version(gpu, dtype, B, S, Di, N, extreme):
    case = _ssm_backward_case(S + B, B, S, Di, N, dtype, extreme)
    _check_backward(ks.ssm_scan_backward, ks.ref_ssm_scan_backward, case, SSM_GRADS, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", ["S1", "chunk-1", "chunk", "chunk+1", "seg-1", "seg", "seg+1"])
def test_wkv_backward_kernel_at_segment_edges(gpu, dtype, edge):
    """Lengths about the edges of ``wkv_backward_segments`` at rwkv6-7b's
    heads (a chunk's 16 steps; the segment the rule gives at the training
    length 2048): every gradient within BWD_TOL."""
    B, H, hd = 1, 64, 64
    slots = kw.backward_slots(gpu.index or 0, dtype, hd)
    seg = kw.wkv_backward_segments(slots, B, H, 2048)[1]
    chunk = kw.BACKWARD_CHUNK
    S = {"S1": 1, "chunk-1": chunk - 1, "chunk": chunk, "chunk+1": chunk + 1,
         "seg-1": seg - 1, "seg": seg, "seg+1": seg + 1}[edge]
    case = _wkv_backward_case(S + 11, B, S, H, hd, dtype)
    _check_backward(kw.rwkv6_chunked_backward, kw.ref_rwkv6_chunked_backward, case, WKV_GRADS,
                    dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", ["S1", "chunk-1", "chunk", "chunk+1", "seg-1", "seg", "seg+1"])
def test_ssm_backward_kernel_at_segment_edges(gpu, dtype, edge):
    """Lengths about the edges of ``ssm_backward_segments`` at hymba-1.5b's
    scan (a chunk's 8 steps; the segment the rule gives at the training
    length 2176): every gradient within BWD_TOL."""
    B, Di, N = 1, 1600, 16
    slots = ks.backward_slots(gpu.index or 0, dtype, N)
    seg = ks.ssm_backward_segments(slots, B, Di, N, 2176)[1]
    chunk = ks.BACKWARD_CHUNK
    S = {"S1": 1, "chunk-1": chunk - 1, "chunk": chunk, "chunk+1": chunk + 1,
         "seg-1": seg - 1, "seg": seg, "seg+1": seg + 1}[edge]
    case = _ssm_backward_case(S + 13, B, S, Di, N, dtype)
    _check_backward(ks.ssm_scan_backward, ks.ref_ssm_scan_backward, case, SSM_GRADS, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_backward_kernels_at_small_widths_with_strong_decays(gpu, dtype):
    """B 2 with head_dim 32 (WKV) and N 8 (scan), several segments (S 600),
    w = 0 at every third step's even keys and dt = 80 at every fourth step:
    every gradient finite and within BWD_TOL."""
    case = list(_wkv_backward_case(21, 2, 600, 4, 32, dtype))
    case[3][:, ::3, :, ::2] = 0.0
    _check_backward(kw.rwkv6_chunked_backward, kw.ref_rwkv6_chunked_backward, case, WKV_GRADS,
                    dtype)
    case = list(_ssm_backward_case(22, 2, 600, 256, 8, dtype))
    case[0][:, ::4] = 80.0
    _check_backward(ks.ssm_scan_backward, ks.ref_ssm_scan_backward, case, SSM_GRADS, dtype)


def test_scan_backward_kernels_where_decays_underflow(gpu):
    """w = 0 and exp(dt A) = 0 exactly: every gradient finite and within the
    bound of the plain version's."""
    case = list(_wkv_backward_case(3, 1, 300, 4, 64, torch.float32))
    case[3][:, ::3, :, ::2] = 0.0
    _check_backward(kw.rwkv6_chunked_backward, kw.ref_rwkv6_chunked_backward, case, WKV_GRADS,
                    torch.float32)
    case = list(_ssm_backward_case(4, 1, 300, 256, 16, torch.float32))
    case[0][:, ::4] = 80.0
    case[4][:, :8] = 3.0          # A = -exp(3): dt A = -1607
    _check_backward(ks.ssm_scan_backward, ks.ref_ssm_scan_backward, case, SSM_GRADS,
                    torch.float32)


@pytest.mark.parametrize("which", ["wkv", "ssm"])
def test_scan_backward_bound_catches_faulted_controls(gpu, which):
    """Each gradient scaled by 1 + 2**-7 falls outside the float32 bound."""
    if which == "wkv":
        case = _wkv_backward_case(9, 1, 200, 8, 64, torch.float32)
        got, want = kw.rwkv6_chunked_backward(*case), kw.ref_rwkv6_chunked_backward(*case)
    else:
        case = _ssm_backward_case(9, 1, 200, 256, 16, torch.float32)
        got, want = ks.ssm_scan_backward(*case), ks.ref_ssm_scan_backward(*case)
    for a, w in zip(got, want):
        assert _backward_excess(a * (1 + 2 ** -7), w, torch.float32) > 1.0


def test_scan_backward_rejects_what_it_does_not_take(gpu):
    r, k, v, w, u, s0, dy, ds = _wkv_backward_case(0, 1, 8, 2, 64, torch.float32)
    with pytest.raises(ValueError):
        kw.rwkv6_chunked_backward(*(x[..., :48].contiguous() for x in (r, k, v, w)), u[:, :48],
                                  None, dy[..., :48].contiguous())
    with pytest.raises(ValueError):
        kw.rwkv6_chunked_backward(r.half(), k.half(), v.half(), w, u, s0, dy, ds)
    with pytest.raises(ValueError):
        kw.rwkv6_chunked_backward(r, k, v, w, u, s0, dy.bfloat16(), ds)
    with pytest.raises(ValueError):
        kw.rwkv6_chunked_backward(r, k, v, w, u.bfloat16(), s0, dy, ds)
    dt, x, bm, cm, a_log, h0, dy, dh = _ssm_backward_case(0, 1, 8, 64, 16, torch.float32)
    with pytest.raises(ValueError):
        ks.ssm_scan_backward(dt, x, bm[..., :12].contiguous(), cm[..., :12].contiguous(),
                             a_log[:, :12].contiguous(), None, dy)
    with pytest.raises(ValueError):
        ks.ssm_scan_backward(dt.half(), x.half(), bm.half(), cm.half(), a_log, h0, dy, dh)
    with pytest.raises(ValueError):
        ks.ssm_scan_backward(dt, x, bm, cm, a_log.bfloat16(), h0, dy, dh)
    with pytest.raises(ValueError):
        ks.ssm_scan_backward(dt, x, bm, cm, a_log, h0, dy.bfloat16(), dh)


def test_scan_functions_on_the_card_match_autograd_of_the_plain_version(gpu):
    """float32: ``trainable_rwkv6_chunked`` and ``trainable_ssm_scan`` (the
    forward kernels, then the backward kernels) against autograd through
    the plain versions, with and without an initial state."""
    for fn, ref, case in ((kw.trainable_rwkv6_chunked, kw.ref_rwkv6_chunked,
                           _wkv_backward_case(2, 2, 75, 4, 64, torch.float32)),
                          (ks.trainable_ssm_scan, ks.ref_ssm_scan,
                           _ssm_backward_case(2, 2, 75, 128, 16, torch.float32))):
        for with_state in (True, False):
            n = 6 if with_state else 5
            a = [t.clone().requires_grad_() for t in case[:n]]
            b = [t.clone().requires_grad_() for t in case[:n]]
            y, s = fn(*a)
            assert type(y.grad_fn).__name__ in ("WKV6Backward", "SelectiveScanBackward")
            ((y * case[6]).sum() + (s * case[7]).sum()).backward()
            y, s = ref(*b)
            ((y * case[6]).sum() + (s * case[7]).sum()).backward()
            for x1, x2 in zip(a, b):
                assert _backward_excess(x1.grad, x2.grad, torch.float32) <= 1.0


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_recurrent_smoke_stacks_train_on_the_card(gpu, arch):
    """The smoke variant (2 layers) in float32: every leaf's gradient of
    ``loss_fn`` on the card (the scan kernels forward twice a layer, remat
    included, and their backward once) within 1e-3 of the CPU's (relative
    to the leaf's norm, floored at 1e-3 of the global norm), then one AdamW
    step on both with losses and grad norms within 1e-4."""
    from repro_torch.configs import card_smoke_variant
    from repro_torch.models import init_params, loss_fn, make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.params import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = card_smoke_variant(arch).replace(dtype="float32")
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(5))
    grads, metrics = {}, {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        kw.reset_launch_counts()
        ks.reset_launch_counts()
        total, _ = loss_fn(cfg, params, {"tokens": tokens.to(dev)})
        grads[dev] = [g.cpu() for g in torch.autograd.grad(total, leaves)]
        if dev == "cuda":
            fwd, bwd = ((kw.rwkv6_chunked, kw.rwkv6_chunked_backward) if arch == "rwkv6-7b"
                        else (ks.ssm_scan, ks.ssm_scan_backward))
            assert (fwd.launches, bwd.launches) == (2 * cfg.num_layers, cfg.num_layers)
        for p in leaves:
            p.requires_grad_(False)
        opt = AdamW(lr=1e-3)
        _, _, m = make_train_step(cfg, opt)(params, opt.init(params), {"tokens": tokens.to(dev)})
        metrics[dev] = (float(m["loss"]), float(m["grad_norm"]))
    norm = float(torch.sqrt(sum(g.double().square().sum() for g in grads["cpu"])))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        err = float((a.double() - b.double()).norm()) / max(float(b.double().norm()), 1e-3 * norm)
        assert err <= 1e-3, err
    assert metrics["cuda"][0] == pytest.approx(metrics["cpu"][0], rel=1e-4)
    assert metrics["cuda"][1] == pytest.approx(metrics["cpu"][1], rel=1e-4)


# ---------------------------------------------------------------------------
# the meta rule: a shape-only call gives the card call's shapes and dtypes
# ---------------------------------------------------------------------------


def _meta_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


def _meta_matches_card(fn, args, kwargs=None, name=None):
    """``fn`` on meta copies of ``args`` returns the card call's shapes and
    dtypes, launches nothing and counts its contract work once."""
    from repro_torch.kernels import work

    kwargs = kwargs or {}
    card = fn(*args, **kwargs)
    torch.cuda.synchronize()
    launches = fn.launches
    work.reset_meta_work()
    meta = fn(*[_meta_like(a) for a in args], **{k: _meta_like(v) for k, v in kwargs.items()})
    assert fn.launches == launches
    assert all(t.is_meta for t in (meta if isinstance(meta, tuple) else (meta,)))
    assert _shapes(meta) == _shapes(card)
    counted = work.META_WORK[name or fn.__name__]
    assert counted.calls == 1 and counted.nbytes > 0 and counted.flops > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_branch_paged_wrappers(gpu, dtype):
    c = _on(_case(31, 128, dtype, dtype), gpu)
    _meta_matches_card(ka.paged_decode_attention,
                       (c["q_dec"], c["k"], c["v"], c["tables"], c["lengths"]))
    _meta_matches_card(ka.paged_chunk_attention,
                       (c["q_chunk"], c["k"], c["v"], c["tables"], c["row_of"],
                        c["slots"], c["p_end"], c["s_start"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_branch_dense_wrappers(gpu, dtype):
    g = torch.Generator(device=gpu).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device=gpu).to(dtype)
    q, k, v = rnd(2, 100, 8, 64), rnd(2, 100, 2, 64), rnd(2, 100, 2, 64)
    for form in ({"causal": True}, {"causal": True, "window": 32}, {"causal": True, "chunk": 48},
                 {"causal": False}):
        _meta_matches_card(kf.flash_attention, (q, k, v), form)
        out = kf.flash_attention(q, k, v, **form)
        _meta_matches_card(kf.flash_attention_backward, (q, k, v, out, torch.ones_like(out)),
                           form)
    lengths = torch.tensor([1, 100], dtype=torch.int32, device=gpu)
    _meta_matches_card(ka.decode_attention, (rnd(2, 8, 64), k, v, lengths))


def test_meta_branch_scans_and_topk(gpu):
    r, k, v, w, u, state0 = _wkv_case(7, 2, 40, 4, 64, torch.bfloat16, None, gpu)
    _meta_matches_card(kw.rwkv6_chunked, (r, k, v, w, u, state0))
    dy = torch.randn(r.shape, device=gpu)
    _meta_matches_card(kw.rwkv6_chunked_backward, (r, k, v, w, u.float(), state0, dy))
    dt, x, bm, cm, a_log, h0 = _ssm_case(7, 2, 40, 64, 16, torch.bfloat16, gpu)
    _meta_matches_card(ks.ssm_scan, (dt, x, bm, cm, a_log, h0))
    dy = torch.randn(dt.shape, device=gpu)
    _meta_matches_card(ks.ssm_scan_backward, (dt, x, bm, cm, a_log.float(), h0, dy))
    q, docs = torch.randn(4, 64, device=gpu), torch.randn(1000, 64, device=gpu)
    _meta_matches_card(tk.topk_retrieval, (q, docs), {"k": 10})
