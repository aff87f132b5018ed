"""The one traffic generator: a mix's parameter file and a seed in, the
requests of a run out.

A mix (``traffic/<name>.json``) fixes the loop (``open``: Poisson
arrivals at ``rate_rps``), the sizes (answer, query, prelude, documents a request and their length),
the corpus (passages, popularity law, embedding width), the SLO classes and
the TTFT limit. The sizes and the arrival trace come from the mix's
``pool_seed`` and are the same for every run; ``--seed`` orders the sizes
over the arrivals and draws each request's documents and every token, so
the same seed gives the same requests and every seed the same work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ragbench.traffic import arrivals

# independent streams of one run's seed
_DOCS, _QUERY, _PRELUDE, _ORDER, _DOC_TOKENS = 1, 2, 3, 4, 5


def stream(seed: int, purpose: int, *more: int) -> np.random.Generator:
    """A numpy generator for one purpose of one run's seed (any size)."""
    return np.random.default_rng([int(seed) % 2**63, purpose, *more])


@dataclass
class Plan:
    """One request as the client will send it."""
    index: int
    due: float               # seconds after the traffic starts
    cls: int                 # index into the mix's classes
    max_new: int             # answer tokens (greedy, no end token)
    query: np.ndarray        # query tokens
    docs: np.ndarray         # distinct document ids, in draw order


class Popularity:
    """Draws of distinct document ids under the mix's law: ``zipf`` (rank r
    with weight r^-s, ranks mapped to ids by a permutation of the seed) or
    ``uniform``."""

    def __init__(self, corpus: dict, seed: int):
        self.n = int(corpus["passages"])
        self.law = corpus["popularity"]
        rng = stream(seed, _DOCS, 0)
        if self.law == "zipf":
            w = np.arange(1, self.n + 1, dtype=np.float64) ** -float(corpus["zipf_s"])
            self.cdf = np.cumsum(w) / w.sum()
            self.ids = rng.permutation(self.n)
        elif self.law != "uniform":
            raise ValueError(f"unknown popularity law {self.law!r}")

    def draw(self, rng: np.random.Generator, k: int) -> np.ndarray:
        if self.law == "uniform":
            return rng.choice(self.n, k, replace=False)
        out: List[int] = []
        while len(out) < k:
            r = int(np.searchsorted(self.cdf, rng.random(), side="right"))
            d = int(self.ids[min(r, self.n - 1)])
            if d not in out:
                out.append(d)
        return np.asarray(out, np.int64)


def _range(spec, key) -> tuple:
    lo, hi = spec[key]
    return int(lo), int(hi)


def shapes(spec: dict, n: int):
    """The mix's ``n`` request sizes from its ``pool_seed``: (answer tokens,
    query tokens, documents, class), each an array of ``n``."""
    rng = np.random.default_rng(int(spec["pool_seed"]))
    ans = arrivals.log_uniform_ints(rng, *_range(spec, "answer_tokens"), n)
    qlo, qhi = _range(spec, "query_tokens")
    dlo, dhi = _range(spec, "docs_per_request")
    qlen = rng.integers(qlo, qhi + 1, n)
    ndocs = rng.integers(dlo, dhi + 1, n)
    cls = arrivals.choose_classes(rng, [c["weight"] for c in spec["classes"]], n)
    return ans, qlen, ndocs, cls


def due_times(spec: dict, n: int) -> np.ndarray:
    """The ``n`` due times, seconds after the traffic starts: the mix's own
    arrival trace, drawn from its ``pool_seed`` (Poisson gaps scaled to the
    exact mean rate), the same for every seed, as a recorded trace is
    replayed."""
    if spec["arrival"] != "poisson":
        raise ValueError(f"unknown arrival process {spec['arrival']!r}")
    rate = float(spec["rate_rps"])
    gaps = arrivals.poisson_gaps(np.random.default_rng(int(spec["pool_seed"]) + 1), rate, n)
    return np.cumsum(gaps * (n / rate) / gaps.sum())


class Traffic:
    """The requests of one run of a mix: ``plans`` in sending order, the
    shared ``prelude`` and each document's tokens (``doc_tokens``)."""

    def __init__(self, spec: dict, seed: int, seconds: float, vocab: int):
        self.spec = spec
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.loop = spec["loop"]
        self.classes = spec["classes"]
        self.doc_len = int(spec["doc_tokens"])
        self.ttft_limit_s = float(spec.get("ttft_limit_ms", math.inf)) / 1e3
        span = float(spec["warmup_s"]) + float(seconds) + float(spec.get("trace_s", 0.0))
        if self.loop != "open":
            raise ValueError(f"unknown loop {self.loop!r}")
        n = int(math.ceil(float(spec["rate_rps"]) * span)) + 1
        due = due_times(spec, n)
        ans, qlen, ndocs, cls = shapes(spec, n)
        perm = stream(seed, _ORDER, 1).permutation(n)
        ans, qlen, ndocs, cls = ans[perm], qlen[perm], ndocs[perm], cls[perm]
        pop = Popularity(spec["corpus"], seed)
        drng, qrng = stream(seed, _DOCS, 1), stream(seed, _QUERY)
        self.plans = [
            Plan(i, float(due[i]), int(cls[i]), int(ans[i]),
                 qrng.integers(0, self.vocab, int(qlen[i])).astype(np.int32),
                 pop.draw(drng, int(ndocs[i])))
            for i in range(n)
        ]
        self.prelude = stream(seed, _PRELUDE).integers(
            0, self.vocab, int(spec["prelude_tokens"])).astype(np.int32)
        self._docs: Dict[int, np.ndarray] = {}

    def doc_tokens(self, doc_id: int) -> np.ndarray:
        """The tokens of document ``doc_id`` (a function of the seed and the id)."""
        toks = self._docs.get(doc_id)
        if toks is None:
            toks = stream(self.seed, _DOC_TOKENS, int(doc_id)).integers(
                0, self.vocab, self.doc_len).astype(np.int32)
            self._docs[doc_id] = toks
        return toks

    def deadline_s(self, plan: Plan) -> float:
        return float(self.classes[plan.cls]["deadline_ms"]) / 1e3
