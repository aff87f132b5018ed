"""The port's retrieval against the JAX package on the CPU: the synthetic
corpus, k-means, the IVF and exact searches, recall, the Retriever
component, and the plain version of the top-k kernel against the Pallas
kernel (interpret mode) and its JAX oracle. Inputs are made with numpy from
a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.components import Retriever as JaxRetriever
from repro.data.workload import synthetic_corpus as jax_corpus
from repro.kernels import ops, ref
from repro.serving import retrieval as jr
from repro_torch.core.components import Retriever
from repro_torch.data.workload import CHUNK_ROWS, synthetic_corpus
from repro_torch.kernels import topk_retrieval as tk
from repro_torch.serving import retrieval as tr

# scores: the two packages' float32 products sum in another order (a few
# ulps of values below 1)
SCORE_ATOL = 1e-5


@pytest.mark.parametrize("n,dim", [
    (2 * CHUNK_ROWS + 1000, 8),   # two chunk boundaries, a ragged last chunk
    (777, 768),                   # one chunk, the retrieval phase's width
])
def test_synthetic_corpus_bit_identical(n, dim):
    want = jax_corpus(n, dim, seed=3)
    got = synthetic_corpus(n, dim, seed=3)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_lloyd_matches_jax_kmeans_from_the_same_draw(seed):
    data = jax_corpus(2048, 32, seed=1)
    n_clusters = 16
    key = jax.random.PRNGKey(seed)
    want_c, want_a = jr.kmeans(key, jnp.asarray(data), n_clusters)
    idx = np.asarray(jax.random.choice(key, data.shape[0], (n_clusters,), replace=False))
    got_c, got_a = tr.lloyd(torch.tensor(data), torch.tensor(data[idx]))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def indexes():
    emb = jax_corpus(2048, 32, seed=0)
    jidx = jr.VectorIndex.build(emb, n_clusters=16, seed=0)
    tidx = tr.VectorIndex.from_numpy(
        np.asarray(jidx.embeddings), np.asarray(jidx.centroids),
        np.asarray(jidx.cluster_of), np.asarray(jidx.cluster_members), device="cpu")
    return jidx, tidx, jax_corpus(8, 32, seed=7)


def _same_search(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("k,n_probe", [(10, 1), (10, 4), (100, 2), (200, 1)])
def test_ivf_search_matches_jax(indexes, k, n_probe):
    jidx, tidx, q = indexes
    got = tidx.search(q, k=k, n_probe=n_probe)
    _same_search(got, jidx.search(q, k=k, n_probe=n_probe))
    if k == 200:   # more than one probed cluster holds: -1 ids, -inf scores
        assert (got[1] == -1).any() and torch.isinf(got[0][got[1] == -1]).all()


@pytest.mark.parametrize("k", [1, 20])
def test_exact_search_and_recall_match_jax(indexes, k):
    jidx, tidx, q = indexes
    _same_search(tidx.search_exact(q, k=k), jidx.search_exact(q, k=k))
    for n_probe in (1, 4):
        assert tr.recall_at_k(tidx, q, k, n_probe) == jr.recall_at_k(jidx, q, k, n_probe)


def test_retriever_component_matches_jax(indexes):
    """Same index state, same query: the same documents and scores (the
    query embedding is seeded from ``hash(str(query))``, so both sides must
    run in one process)."""
    jidx, tidx, _ = indexes
    for query in ("who wrote the iliad", 12345):
        want = JaxRetriever(jidx, n_probe=4).retrieve(query, k=30)
        got = Retriever(tidx, n_probe=4).retrieve(query, k=30)
        assert list(got) == list(want)
        np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_ATOL, rtol=0)


def test_build_clusters_every_doc_once():
    emb = synthetic_corpus(1500, 16, seed=2)
    idx = tr.VectorIndex.build(emb, n_clusters=12, seed=5, device="cpu")
    members = idx.cluster_members
    ids = members[members >= 0]
    assert sorted(ids.tolist()) == list(range(1500))
    for c in range(12):      # ascending members, each assigned to its cluster
        row = members[c][members[c] >= 0]
        assert torch.equal(row, torch.sort(row).values)
        assert (idx.cluster_of[row] == c).all()
    assert idx.max_per == members.shape[1] == int(torch.bincount(idx.cluster_of).max())
    assert torch.allclose(idx.embeddings.norm(dim=1), torch.ones(1500), atol=1e-5)
    # probing every cluster is the exact search
    q = synthetic_corpus(6, 16, seed=9)
    assert tr.recall_at_k(idx, q, 10, n_probe=12) == 1.0
    assert idx.nbytes() == (1500 * 16 * 4 + 12 * 16 * 4 + 1500 * 8 + members.numel() * 8)


def _tie_case():
    """Integer-valued rows, many duplicated: the products are exact in any
    summation order, so equal scores are exactly equal everywhere."""
    rng = np.random.default_rng(11)
    base = rng.integers(-2, 3, (64, 32)).astype(np.float32)
    docs = base[rng.integers(0, 64, 768)]
    q = rng.integers(-2, 3, (3, 32)).astype(np.float32)
    return q, docs, 16, 128


@pytest.mark.parametrize("case", [
    (1, 1024, 32, 8, 256),
    (4, 4096, 64, 16, 512),
    (2, 768, 128, 4, 256),       # non-pow2 N
    "ties",
])
def test_plain_topk_matches_pallas_and_jax_oracle(case):
    if case == "ties":
        q, docs, k, block_n = _tie_case()
    else:
        B, N, d, k, block_n = case
        rng = np.random.default_rng(N + d)
        q = rng.standard_normal((B, d)).astype(np.float32)
        docs = rng.standard_normal((N, d)).astype(np.float32)
    got_s, got_i = tk.ref_topk_retrieval(torch.tensor(q), torch.tensor(docs), k)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    for want_s, want_i in (ops.topk_retrieval(jnp.asarray(q), jnp.asarray(docs), k=k,
                                              block_n=block_n),
                           ref.topk_retrieval_ref(jnp.asarray(q), jnp.asarray(docs), k=k)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4, rtol=1e-4)
    if case == "ties":
        assert len(set(got_s[0].tolist())) < k      # the case really ties


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, docs, k, _ = _tie_case()
    before = tk.topk_retrieval.launches
    got = tk.topk_retrieval(torch.tensor(q), torch.tensor(docs), k)
    want = tk.ref_topk_retrieval(torch.tensor(q), torch.tensor(docs), k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tk.topk_retrieval.launches == before
    with pytest.raises(ValueError):
        tk.topk_retrieval(torch.tensor(q), torch.tensor(docs), docs.shape[0] + 1)
    with pytest.raises(ValueError):
        tk.topk_retrieval(torch.tensor(q), torch.tensor(docs[:, :8]), k)


def test_scored_docs_and_doc_token_store_match_jax():
    for ids, scores in (([5, 3, 9], [0.5, 0.25, 0.125]), (np.arange(4), None)):
        a, b = tr.ScoredDocs(ids, scores), jr.ScoredDocs(ids, scores)
        assert list(a) == list(b) and a.scores == b.scores
        assert list(a.top(2)) == list(b.top(2)) and a.top(2).scores == b.top(2).scores
    for vocab, doc_len in ((512, 64), (151936, 256)):
        a, b = tr.DocTokenStore(vocab, doc_len), jr.DocTokenStore(vocab, doc_len)
        for x, y in zip(a.tokens_for([0, 7, 10_005, 2**20]), b.tokens_for([0, 7, 10_005, 2**20])):
            assert x.dtype == y.dtype and np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic, emulated in plain torch on the CPU
# ---------------------------------------------------------------------------

# the card's checks (tests/test_torch_cuda.py, chip_smoke.py TOPK_TOL):
# scores within TOPK_ATOL, and two ids may swap only where the plain
# version's scores of the two lie within TOPK_SWAP_TOL
TOPK_ATOL = 1e-4
TOPK_SWAP_TOL = 1e-5


def _tf32_trunc(x):
    """The top 19 bits of each f32 (sign, exponent, 10 mantissa bits): what
    the kernel keeps as hi (a logic op) and what the tensor core reads of
    a tf32 operand (so lo is truncated too)."""
    return (x.view(torch.int32) & -(1 << 13)).view(torch.float32)


def _split_tf32_scores(q, docs):
    """csrc/topk_retrieval.cu's scores. f32 docs: q and docs split as x = hi
    + lo (hi = trunc(x), lo = trunc(x - hi)), the rows [q_hi; q_lo] times
    d_hi and times d_lo, every product exact (tf32 x tf32 fits f32) and
    summed in f32. bf16 docs (exact in bf16): q = b0 + b1 + b2 in bf16, each
    the rounded rest of the one before, the rows [b0; b1] and [b2; 0]
    times the docs."""
    if docs.dtype == torch.bfloat16:
        d = docs.float()
        b0 = q.bfloat16().float()
        b1 = (q - b0).bfloat16().float()
        b2 = (q - b0 - b1).bfloat16().float()
        return (b0 @ d.T + b2 @ d.T) + b1 @ d.T
    qh = _tf32_trunc(q)
    ql = _tf32_trunc(q - qh)
    dh = _tf32_trunc(docs)
    dl = _tf32_trunc(docs - dh)
    return (qh @ dh.T + qh @ dl.T) + (ql @ dh.T + ql @ dl.T)


def _emulated_topk(q, docs, k):
    s = _split_tf32_scores(q, docs)
    vals, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


@pytest.mark.parametrize("docs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [10, 100, 128])
def test_split_tf32_topk_within_the_tolerances_at_d768(docs_dtype, k):
    """Unit rows at the retrieval phase's width: the split's top-k scores
    within TOPK_ATOL of ``ref_topk_retrieval`` and its ids within
    TOPK_SWAP_TOL; a single tf32 product is not (its scores are off by more
    than TOPK_SWAP_TOL, so near-equal docs could swap beyond it). The split
    holds b0 + b1 + b2 == q exactly."""
    rng = np.random.default_rng(19 + k)
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)
    q = torch.tensor(unit(rng.standard_normal((32, 768))).astype(np.float32))
    docs = torch.tensor(unit(rng.standard_normal((20000, 768))).astype(np.float32))
    docs = docs.to(docs_dtype)
    ws, wi = tk.ref_topk_retrieval(q, docs, k)
    gs, gi = _emulated_topk(q, docs, k)
    exact = q.double() @ docs.double().T
    err = float((_split_tf32_scores(q, docs).double() - exact).abs().max())
    assert err < 1e-6, err                                  # as close as f32 sums
    torch.testing.assert_close(gs, ws, atol=TOPK_ATOL, rtol=0)
    diff = gi != wi
    plain = q.float() @ docs.float().T
    gap = (plain.gather(1, gi.long()) - plain.gather(1, wi.long())).abs()
    assert bool((gap[diff] <= TOPK_SWAP_TOL).all()), gap[diff]
    b0 = q.bfloat16().float()
    b1 = (q - b0).bfloat16().float()
    assert torch.equal(b0 + b1 + (q - b0 - b1).bfloat16().float(), q)
    one = _tf32_trunc(q) @ _tf32_trunc(docs.float()).T       # one tf32 product
    assert float((one.double() - exact).abs().max()) > TOPK_SWAP_TOL


@pytest.mark.parametrize("docs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_split_tf32_topk_keeps_exact_ties(docs_dtype, k):
    """Integer-valued rows, many duplicated: the split is exact (lo = 0,
    b1 = b2 = 0), so the scores equal the plain version's and the ids match
    one for one, ties to the lower id."""
    rng = np.random.default_rng(23 + k)
    base = rng.integers(-2, 3, (64, 768)).astype(np.float32)
    docs = torch.tensor(base[rng.integers(0, 64, 5000)]).to(docs_dtype)
    q = torch.tensor(rng.integers(-2, 3, (7, 768)).astype(np.float32))
    ws, wi = tk.ref_topk_retrieval(q, docs, k)
    gs, gi = _emulated_topk(q, docs, k)
    assert torch.equal(gs, ws) and torch.equal(gi, wi)
    assert k == 1 or len(set(ws[0].tolist())) < k             # the case really ties
