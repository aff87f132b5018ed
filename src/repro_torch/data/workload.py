"""Workload generation and the synthetic retrieval corpus, ported from
``repro.data.workload``.

Poisson arrivals with request feature draws that mirror the paper's setup:
LMSYS-Chat-1M-like prompt/response lengths, retrieval depth k ~ U(100, 300)
(per prior work), and a query-complexity mix driving Adaptive-RAG's three
paths. ``synthetic_corpus`` gives the clustered document embeddings the
retrieval index is built over. Each returns the same values, bit for bit,
as the reference for the same arguments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


def sample_request_features(rng: np.random.Generator) -> Dict[str, float]:
    return {
        "tokens_in": float(np.clip(rng.lognormal(4.5, 0.8), 8, 2048)),   # ~90 median
        "tokens_out": float(np.clip(rng.lognormal(4.8, 0.7), 8, 1024)),  # ~120 median
        "k_docs": float(rng.integers(100, 301)),
        "complexity": float(rng.random()),
        "iteration": 0.0,
    }


@dataclass
class ArrivalProcess:
    """Poisson arrival process over a virtual clock."""

    rate: float                      # requests / second
    duration_s: float
    seed: int = 0

    def arrivals(self) -> List[float]:
        rng = np.random.default_rng(self.seed)
        t, out = 0.0, []
        while True:
            t += rng.exponential(1.0 / self.rate)
            if t > self.duration_s:
                break
            out.append(t)
        return out


def make_workload(rate: float, duration_s: float,
                  seed: int = 0) -> List[Tuple[float, Dict[str, float]]]:
    """(arrival_time, features) tuples: arrivals from ``seed``, features
    from ``seed + 1``."""
    rng = np.random.default_rng(seed + 1)
    return [
        (t, sample_request_features(rng))
        for t in ArrivalProcess(rate, duration_s, seed).arrivals()
    ]


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
