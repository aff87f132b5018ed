"""The CUDA kernels (paged attention, top-k retrieval) against their plain
versions, on the card. Marked ``cuda``: each test skips (from inside a
fixture) where no GPU is visible, as in this repository's CPU runs. On a GPU
machine:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which a GPU machine
need not have.)
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as ka
from repro_torch.kernels import topk_retrieval as tk

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
