"""Dense vector retrieval on the device (the Retriever component's engine),
ported from ``repro.serving.retrieval``.

IVF-style index: corpus embeddings are k-means clustered; a query scores the
``n_probe`` nearest clusters only. ``n_probe`` is the accuracy/latency knob
reproducing the paper's Figure 4 (ChromaDB ``search_ef``): small probes are
much faster at k<<N with lower recall.

The index (float32 embeddings, centroids, ``cluster_of`` and
``cluster_members``) lives on one device: ``cuda`` unless ``device="cpu"``
is given. The exact search is the scoring + top-k hot loop, so it runs
``kernels.topk_retrieval``: the CUDA kernel on the GPU, its plain version on
the CPU. The IVF search is plain tensor ops (gather, einsum, top-k), as the
reference runs XLA ops there. Every top-k keeps ``lax.top_k``'s order:
descending, equal values to the lower index.

Full-size temporaries (the k-means ``data @ centroids.T`` and the IVF
search's gathered candidates) are computed in row or query chunks of at
most ``CHUNK_BYTES``; the results do not depend on the chunking.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.topk_retrieval import topk_retrieval

CHUNK_BYTES = 1 << 30


class ScoredDocs(list):
    """Retrieval result: a list of doc ids (drop-in for the plain id lists
    components used to exchange) carrying parallel relevance ``scores``. The
    ids are the currency of retrieval-aware prefix caching — they key the
    Generator's per-document KV blocks (serving.segments)."""

    def __init__(self, ids, scores=None):
        super().__init__(int(i) for i in ids)
        self.scores = (
            [float(s) for s in scores] if scores is not None else [0.0] * len(self)
        )

    def top(self, n: int) -> "ScoredDocs":
        return ScoredDocs(list(self)[:n], self.scores[:n])


@dataclass
class DocTokenStore:
    """Deterministic doc_id -> token-array corpus (tokenizer-free substrate,
    matching ``_embed_query``): the prompt assembler resolves retrieval ids
    to document segments through this. ``doc_len`` a multiple of the paged
    cache's block size maximizes KV block reuse (partial tail blocks are
    never shared)."""

    vocab: int = 512
    doc_len: int = 64

    def tokens(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((int(doc_id) * 2654435761 + 97) % (2**31))
        return rng.integers(0, self.vocab, self.doc_len).astype(np.int32)

    def tokens_for(self, doc_ids) -> list:
        return [self.tokens(d) for d in doc_ids]


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-6)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _nearest(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmax(data @ centroids.T, axis=1), in row chunks."""
    n = data.shape[0]
    rows = max(1, CHUNK_BYTES // (4 * centroids.shape[0]))
    out = torch.empty(n, dtype=torch.long, device=data.device)
    for lo in range(0, n, rows):
        out[lo:lo + rows] = torch.argmax(data[lo:lo + rows] @ centroids.T, dim=1)
    return out


def lloyd(data: torch.Tensor, centroids: torch.Tensor, iters: int = 8):
    """The Lloyd iterations of ``kmeans`` from given initial centroids:
    returns (centroids (C, d), assignment (N,))."""
    n_clusters = centroids.shape[0]
    for _ in range(iters):
        assign = _nearest(data, centroids)
        sums = torch.zeros_like(centroids).index_add_(0, assign, data)
        counts = torch.bincount(assign, minlength=n_clusters).to(data.dtype)[:, None]
        centroids = torch.where(counts > 0, sums / counts.clamp(min=1.0), centroids)
        centroids = _normalize(centroids)
    return centroids, _nearest(data, centroids)


def kmeans(data: torch.Tensor, n_clusters: int, iters: int = 8,
           generator: Optional[torch.Generator] = None):
    """Lightweight k-means (enough to make probing meaningful): initial
    centroids are ``n_clusters`` distinct rows drawn with ``generator`` (a
    CPU ``torch.Generator``), then ``lloyd``."""
    idx = torch.randperm(data.shape[0], generator=generator)[:n_clusters]
    return lloyd(data, data[idx.to(data.device)], iters)


@dataclass
class VectorIndex:
    embeddings: torch.Tensor         # (N, d) float32, L2-normalized
    centroids: torch.Tensor          # (C, d)
    cluster_of: torch.Tensor         # (N,)
    cluster_members: torch.Tensor    # (C, max_per) padded with -1
    max_per: int

    @staticmethod
    def build(embeddings, n_clusters: int = 64, seed: int = 0,
              device=None) -> "VectorIndex":
        """Normalize ``embeddings`` (array or tensor) onto ``device`` and
        cluster them; the k-means draw uses a ``torch.Generator`` seeded
        with ``seed``."""
        dev = resolve_device(device)
        emb = _normalize(torch.as_tensor(embeddings, dtype=torch.float32).to(dev))
        gen = torch.Generator().manual_seed(seed)
        centroids, assign = kmeans(emb, n_clusters, generator=gen)
        return VectorIndex(emb, centroids, assign, *_members(assign, n_clusters))

    @staticmethod
    def from_numpy(embeddings, centroids, cluster_of, members,
                   device=None) -> "VectorIndex":
        """The port's index over another index's state (e.g. the JAX
        package's ``VectorIndex`` fields as numpy arrays), copied onto
        ``device`` as is."""
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        members = t(members, torch.long)
        return VectorIndex(t(embeddings, torch.float32), t(centroids, torch.float32),
                           t(cluster_of, torch.long), members, int(members.shape[1]))

    @property
    def size(self) -> int:
        return self.embeddings.shape[0]

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.embeddings, self.centroids, self.cluster_of, self.cluster_members))

    def _queries(self, query) -> torch.Tensor:
        q = torch.as_tensor(query, dtype=torch.float32).to(self.device)
        return _normalize(torch.atleast_2d(q))

    def search(self, query, k: int = 10, n_probe: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
        """query: (d,) or (B, d). Returns (scores, doc_ids) top-k per query;
        a slot past the probed clusters' members has score -inf and id -1."""
        return _ivf_search(self._queries(query), self.embeddings, self.centroids,
                           self.cluster_members, k, n_probe)

    def search_exact(self, query, k: int = 10):
        """Exact top-k over the whole corpus: (scores float32, ids int32)."""
        return topk_retrieval(self._queries(query), self.embeddings, k)


def _members(assign: torch.Tensor, n_clusters: int):
    """(C, max_per) member ids per cluster, ascending, padded with -1."""
    counts = torch.bincount(assign, minlength=n_clusters)
    max_per = max(int(counts.max()), 1)
    order = torch.argsort(assign, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    owner = assign[order]
    pos = torch.arange(assign.shape[0], device=assign.device) - starts[owner]
    members = torch.full((n_clusters, max_per), -1, dtype=torch.long, device=assign.device)
    members[owner, pos] = order
    return members, max_per


def _ivf_search(q, embeddings, centroids, members, k: int, n_probe: int):
    B, d = q.shape
    _, probe = _top_k(q @ centroids.T, n_probe)            # (B, n_probe)
    cand = members[probe].reshape(B, -1)                   # (B, n_probe * max_per)
    per = max(1, CHUNK_BYTES // (4 * d * cand.shape[1]))   # queries per chunk
    top_s, top_ids = [], []
    for lo in range(0, B, per):
        c = cand[lo:lo + per]
        scores = torch.einsum("bd,bmd->bm", q[lo:lo + per], embeddings[c.clamp(min=0)])
        scores = torch.where(c >= 0, scores, torch.full_like(scores, -torch.inf))
        s, i = _top_k(scores, k)
        top_s.append(s)
        top_ids.append(torch.gather(c, 1, i))
    return torch.cat(top_s), torch.cat(top_ids)


def recall_at_k(index: VectorIndex, queries, k: int, n_probe: int) -> float:
    _, approx = index.search(queries, k=k, n_probe=n_probe)
    _, exact = index.search_exact(queries, k=k)
    hits = 0
    for a, e in zip(approx.cpu().numpy(), exact.cpu().numpy()):
        hits += len(set(a.tolist()) & set(e.tolist()))
    return hits / (len(queries) * k)
