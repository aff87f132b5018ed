"""Synthetic retrieval corpus, ported from ``repro.data.workload``.

Only ``synthetic_corpus`` is ported: the clustered document embeddings the
retrieval index is built over. It returns the same array, bit for bit, as
the reference for the same arguments.
"""
from __future__ import annotations

import numpy as np

# rows of noise drawn per chunk: bounds the float64 temporaries at
# CHUNK_ROWS * dim * 8 bytes (1.6 GB at dim 768) whatever n_docs is
CHUNK_ROWS = 1 << 18


def synthetic_corpus(n_docs: int, dim: int, seed: int = 0) -> np.ndarray:
    """Clustered document embeddings (so IVF probing is meaningful):
    ``(n_docs, dim)`` float32, rows L2-normalized.

    The reference draws all the noise in one ``standard_normal((n_docs,
    dim))`` call, a float64 array of 12.9 GB at 2M x 768. Here it is drawn
    in row chunks: a numpy ``Generator`` fills the same stream in the same
    order, so the values are identical. The topic and assignment draws come
    first, as in the reference."""
    rng = np.random.default_rng(seed)
    n_topics = max(8, n_docs // 64)
    topics = rng.standard_normal((n_topics, dim)).astype(np.float32)
    assign = rng.integers(0, n_topics, n_docs)
    out = np.empty((n_docs, dim), np.float32)
    for lo in range(0, n_docs, CHUNK_ROWS):
        hi = min(lo + CHUNK_ROWS, n_docs)
        emb = topics[assign[lo:hi]] + 0.3 * rng.standard_normal((hi - lo, dim)).astype(np.float32)
        out[lo:hi] = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-6)
    return out
