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
