"""The corpus draw: exact search over the passages returns exactly the
documents a request drew, under both popularity laws."""
import numpy as np
import pytest
import torch

from ragbench import corpus
from ragbench.workload import Popularity, stream


@pytest.mark.parametrize("law,k", [("zipf", (4, 12)), ("uniform", (4, 14))])
def test_exact_search_returns_the_drawn_documents(law, k):
    n, d, seed = 1 << 16, 768, 2**31 + 3
    pop = Popularity({"passages": n, "popularity": law, "zipf_s": 1.1}, seed)
    rng = stream(seed, 1, 1)
    docs = [pop.draw(rng, int(rng.integers(k[0], k[1] + 1))) for _ in range(96)]
    assert all(len(set(x.tolist())) == len(x) for x in docs)
    emb = corpus.passage_embeddings(seed, n, d, "cpu")
    q = corpus.query_embeddings(emb, docs, seed, 0.01)
    scores = q @ emb.T
    for row, want in zip(scores, docs):
        top = torch.topk(row, len(want)).indices.numpy()
        assert set(top.tolist()) == set(want.tolist())
        # every drawn document sits well above the best of the rest
        rest = row.clone()
        rest[torch.as_tensor(want)] = -1
        assert float(row[torch.as_tensor(want)].min()) > float(rest.max()) + 0.05


def test_zipf_draws_favour_the_head():
    pop = Popularity({"passages": 1 << 20, "popularity": "zipf", "zipf_s": 1.1}, 7)
    rng = np.random.default_rng(0)
    ids = np.concatenate([pop.draw(rng, 8) for _ in range(2000)])
    head = set(pop.ids[:1000].tolist())
    share = np.mean([i in head for i in ids])
    assert 0.55 < share < 0.8
