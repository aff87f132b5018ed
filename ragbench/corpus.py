"""The corpus's embeddings and the queries' embeddings, drawn on the device.

Passage embeddings are unit vectors of a standard normal draw, made from
the seed in one call. A request's query embedding is the least-norm vector
whose product with each of its k documents is the same (the normalised sum
of the documents corrected by the inverse of their Gram matrix), plus small
seeded noise, normalised. Its score against each of its documents is then
about 1/sqrt(k), and against any other passage a draw of about
N(0, 1/d): exact search returns exactly the drawn documents, where the
plain normalised sum would let one of 12 drawn documents slip below a
random passage in about 3 % of queries at d = 768 over 2^20 passages.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

import torch


def torch_seed(seed: int, purpose: str) -> int:
    """A 63-bit torch seed for one purpose of one run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(torch_seed(seed, purpose))


def passage_embeddings(seed: int, n: int, dim: int, device) -> torch.Tensor:
    """(n, dim) float32 unit rows, the same for the same seed and device."""
    e = torch.empty((n, dim), dtype=torch.float32, device=device)
    e.normal_(generator=generator(seed, "corpus", device))
    return e.div_(torch.linalg.vector_norm(e, dim=1, keepdim=True))


def query_embeddings(emb: torch.Tensor, docs: Sequence, seed: int, noise: float) -> torch.Tensor:
    """(len(docs), dim) float32 unit rows: for each list of document ids,
    the least-norm q with q . e_i equal for all its documents, plus
    ``noise`` times a seeded unit vector, normalised. Batched over the
    lists (padded with identity rows of the Gram matrix)."""
    n, kmax = len(docs), max(len(d) for d in docs)
    dev = emb.device
    ids = torch.zeros((n, kmax), dtype=torch.long)
    valid = torch.zeros((n, kmax), dtype=torch.bool)
    for i, d in enumerate(docs):
        ids[i, :len(d)] = torch.as_tensor(list(d), dtype=torch.long)
        valid[i, :len(d)] = True
    ids, valid = ids.to(dev), valid.to(dev)
    e = emb[ids] * valid[..., None]                            # (n, kmax, dim)
    gram = (e.double() @ e.double().transpose(1, 2))
    eye = torch.eye(kmax, dtype=torch.float64, device=dev)
    gram = gram + eye * (~valid)[:, None, :].double()
    coef = torch.linalg.solve(gram, valid.double()[..., None])[..., 0]  # (n, kmax)
    q = (coef[..., None] * e.double()).sum(1)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    z = torch.empty(q.shape, dtype=torch.float64, device=dev)
    z.normal_(generator=generator(seed, "query-noise", dev))
    q = q + noise * z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    return (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).float()
