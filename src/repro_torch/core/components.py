"""Serving-ready base classes: Retriever, Generator, Augmenter, Grader, ...

These handle the systems-level book-keeping (request-ID tracking, state,
metadata propagation, capture hooks) so developers only implement the
inference function. Each component exposes:

  * real execution — the retrieval index and the generation engine of
    this package, on the CPU in tests and on the GPU at full width;
  * a calibrated cost model (`estimate_time`) — used by the discrete-event
    cluster simulation at cluster scale and by the slack model.

Default coefficients are calibrated so the four RAG apps reproduce the
paper's Fig. 3 component-time shares (retrieval 18–62% of end-to-end).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.graph import record_call
from repro_torch.core.spec import meta_of


@dataclass
class RequestCtx:
    """Metadata that travels with a request through the pipeline."""

    req_id: int
    features: Dict[str, float] = field(default_factory=dict)
    trace: List[str] = field(default_factory=list)
    state_instance: Dict[str, int] = field(default_factory=dict)  # component->instance
    deadline: Optional[float] = None
    priority: float = 0.0


class Component:
    """Base: request-ID tracking, state management, capture hook."""

    def __init__(self):
        self._state: Dict[int, Any] = {}
        self.calls = 0

    @property
    def meta(self):
        return meta_of(self)

    def _record(self):
        m = self.meta
        record_call(m.name if m else type(self).__name__)
        self.calls += 1

    # cost model: override coefficients per component
    base_time_s: float = 0.002
    per_unit_s: float = 0.0
    unit_feature: str = "k_docs"

    def estimate_time(self, features: Dict[str, float]) -> float:
        return self.base_time_s + self.per_unit_s * features.get(self.unit_feature, 0.0)

    def output_features(self, features: Dict[str, float]) -> Dict[str, float]:
        """How this stage transforms request features (for slack models)."""
        return features


class Retriever(Component):
    """CPU/memory-bound nearest-neighbor search over the document index."""

    base_time_s = 0.004
    per_unit_s = 0.00055   # per retrieved doc (k in 100..300 per the paper)
    unit_feature = "k_docs"

    def __init__(self, index=None, n_probe: int = 8):
        super().__init__()
        self.index = index
        self.n_probe = n_probe

    def retrieve(self, query, k: int = 100):
        """Returns a ``ScoredDocs``: doc ids (list-compatible, what callers
        always consumed) plus relevance scores — the ids flow through
        Reranker/Augmenter into the Generator's SegmentedPrompt so KV reuse
        can be keyed by document identity."""
        from repro_torch.serving.retrieval import ScoredDocs

        self._record()
        if self.index is not None:
            qv = torch.from_numpy(_embed_query(query, self.index.embeddings.shape[1]))
            scores, ids = self.index.search(qv.to(self.index.device),
                                            k=min(k, self.index.size), n_probe=self.n_probe)
            return ScoredDocs(ids[0].cpu().numpy(), scores[0].cpu().numpy())
        return ScoredDocs(range(k), [1.0 / (r + 1) for r in range(k)])

    def estimate_time(self, features):
        # probing fewer clusters is drastically faster at small k (Fig. 4)
        probe_scale = 0.25 + 0.75 * (self.n_probe / 32.0)
        return (self.base_time_s + self.per_unit_s * features.get("k_docs", 100)) * probe_scale

    def output_features(self, features):
        f = dict(features)
        f["docs_tokens"] = features.get("k_docs", 100) * 100  # ~100 words/passage
        return f


class Generator(Component):
    """GPU-resident LLM decode (the HBM-bandwidth-bound stage).

    The cost model mirrors the paged serving engine's roofline: prefill is
    linear in *computed* prompt tokens (prefix-shared cache blocks are free —
    ``prefix_hit_rate`` is the fraction of prompt tokens served from shared
    blocks), and each decode step pays a flat weights-read term plus a
    KV-cache-read term proportional to the current context length. The
    defaults are calibrated so the four RAG apps reproduce the paper's Fig. 3
    component-time shares; ``profiling.calibrate_generator_from_engine``
    refits them against a live engine."""

    base_time_s = 0.012
    prefill_per_token_s = 0.000011
    decode_per_token_s = 0.00045           # flat weights-read term / new token
    decode_cache_per_ctx_token_s = 2.25e-8  # KV-read term / context token / step
    prefix_hit_rate = 0.0                   # shared-prefix fraction of the prompt
    # host-tier second-chance hits: the fraction of prompt tokens promoted
    # from the host block store costs a host->device block copy instead of
    # prefill compute — much cheaper than recompute, not free like an HBM hit
    host_hit_rate = 0.0
    host_promote_per_token_s = 1.2e-6
    # multi-turn session-history hits (serving.session.Session): conversation
    # history promoted from the host tier between turns. Same physical cost as
    # a doc promotion (a host->device block copy), but a distinct class —
    # disjoint from host_hit_rate — because its magnitude tracks session mix /
    # turn depth rather than doc popularity, so the LP's provisioning feedback
    # must not conflate the two signals.
    session_hit_rate = 0.0
    # chunked-prefill TTFT term: with Sarathi-style interleaving the prompt
    # streams through budget-bounded chunks that share each step with decode,
    # so time-to-first-token has its own (steeper) per-token slope than the
    # saturated whole-prompt prefill throughput above
    ttft_per_prefill_token_s = 0.000013
    # tensor parallelism: one replica spans tp_degree chips (sharded paged
    # pools, serving.sharded_pool). Per-token compute and KV reads scale
    # ~1/tp, but each layer pays the Megatron all-reduce pair regardless of
    # tp, so the speedup saturates: s(t) = t / (1 + tp_comm_fraction*(t-1)).
    # tp_comm_fraction is the collective share of a t=1 step (calibratable).
    tp_degree = 1
    # collective share of a t=1 step. The 0.08 default is a documented prior;
    # ``profiling.calibrate_generator_from_engine(tp_engine=...)`` refits it
    # from an actual --tp 2 A/B wall-time ratio (fit_tp_comm_fraction).
    tp_comm_fraction = 0.08
    # KV storage footprint per context token (bytes across the layer stack,
    # K+V, including any scale-pool overhead). KV capacity is the binding
    # resource of a decode replica (pool exhaustion drives preemption), so
    # at a fixed HBM budget a replica's concurrent context — and with it the
    # request rate one chip sustains — scales with baseline/current bytes
    # per token: an int8 pool (``kv_dtype="int8"``) halves the bytes and
    # ~doubles capacity. ``baseline_kv_bytes_per_token`` records what the
    # fitted alpha assumed; both None disables the discount (scale 1.0).
    kv_bytes_per_token: Optional[float] = None
    baseline_kv_bytes_per_token: Optional[float] = None

    def __init__(self, engine=None, max_new: int = 64, tp_degree: int = 1):
        super().__init__()
        self.engine = engine
        self.max_new = max_new
        if tp_degree != 1:
            self.tp_degree = int(tp_degree)

    def tp_speedup(self, t: Optional[int] = None) -> float:
        """Per-replica latency speedup of tp-sharding the generation step:
        compute parallelizes over t chips while the per-layer all-reduce term
        does not, so s(t) = t / (1 + f*(t-1)) with f = tp_comm_fraction —
        s(1) = 1, and s(t) -> 1/f as t grows. The LP uses s(t)/t as the
        per-chip efficiency of a sharded replica (solve_allocation
        tp_degree=...)."""
        t = self.tp_degree if t is None else int(t)
        if t <= 1:
            return 1.0
        return t / (1.0 + self.tp_comm_fraction * (t - 1))

    def kv_capacity_scale(self) -> float:
        """Capacity multiplier the pool storage format buys a replica:
        ``baseline_kv_bytes_per_token / kv_bytes_per_token``. At equal HBM
        budget an int8 pool fits ~2x the context of the float pool the alpha
        was fitted against, so one resource unit sustains proportionally more
        concurrent requests. Fed to ``solve_allocation(kv_capacity_scale=
        ...)`` — a pure alpha multiplier, the LP stays linear. Returns 1.0
        when either byte count is unset (no measured pool format)."""
        if not self.kv_bytes_per_token or not self.baseline_kv_bytes_per_token:
            return 1.0
        return max(
            float(self.baseline_kv_bytes_per_token) / float(self.kv_bytes_per_token),
            1e-6,
        )

    def generate(self, prompt_tokens, max_new: Optional[int] = None):
        """``prompt_tokens``: flat tokens, or a ``SegmentedPrompt`` from the
        Augmenter — the segmented form is what lets the engine's paged cache
        reuse per-document KV blocks across requests."""
        from repro_torch.serving.segments import SegmentedPrompt

        self._record()
        if self.engine is not None:
            prompt = (
                prompt_tokens
                if isinstance(prompt_tokens, SegmentedPrompt)
                else np.asarray(prompt_tokens)
            )
            req = self.engine.submit(prompt, max_new or self.max_new)
            self.engine.run_until_done()
            return req.out_tokens
        return [0] * (max_new or self.max_new)

    def calibrate(self, coeffs: Dict[str, float]) -> None:
        """Overwrite cost-model coefficients with measured values."""
        for k, v in coeffs.items():
            if hasattr(self, k):
                setattr(self, k, float(v))

    def _profile_run(self, features):
        """Real-execution profiling hook: drive the live engine with a
        synthetic request shaped like ``features`` — the decode length must
        track tokens_out (capped to engine capacity) or the fitted alpha
        wildly overstates Generator throughput."""
        if self.engine is None:
            return
        n = max(int(min(features.get("tokens_in", 32), self.engine.max_seq // 2)), 4)
        budget = max(self.engine.max_seq - n - 1, 1)
        max_new = max(int(min(features.get("tokens_out", 16), budget, 64)), 1)
        req = self.engine.submit(np.arange(n) % 97, max_new=max_new)
        self.engine.run_until_done()
        return req.out_tokens

    def effective_hit_rate(self) -> float:
        """The prefix hit rate the cost model should bill: the *measured*
        rolling rate from a live engine's telemetry when one is attached and
        its window is warm, else the statically configured/calibrated
        ``prefix_hit_rate``. The engine's cold-start clamp makes the fallback
        explicit: below its minimum-token window, ``measured_hit_rate``
        returns the ``default`` we pass — the static rate — instead of a
        noisy first-request sample that would stampede the LP's
        alpha_scale."""
        eng = self.engine
        if eng is not None:
            measure = getattr(eng, "measured_hit_rate", None)
            if measure is not None:
                return float(measure(default=self.prefix_hit_rate))
        return self.prefix_hit_rate

    def effective_host_hit_rate(self) -> float:
        """Host-tier hit rate to bill (measured when warm, else the static
        ``host_hit_rate``) — same cold-start fallback as
        ``effective_hit_rate``."""
        eng = self.engine
        if eng is not None:
            measure = getattr(eng, "measured_host_hit_rate", None)
            if measure is not None:
                return float(measure(default=self.host_hit_rate))
        return self.host_hit_rate

    def effective_session_hit_rate(self) -> float:
        """Session-history hit rate to bill (measured when warm, else the
        static ``session_hit_rate``) — same cold-start fallback as
        ``effective_hit_rate``. Disjoint from the doc host class."""
        eng = self.engine
        if eng is not None:
            measure = getattr(eng, "measured_session_hit_rate", None)
            if measure is not None:
                return float(measure(default=self.session_hit_rate))
        return self.session_hit_rate

    def _tier_rates(self, hit_rate, host_hit_rate, session_hit_rate=None):
        """Resolve (HBM, host-doc, host-session) hit fractions; the classes
        partition the prompt, so each later class is clamped into the
        remainder of the earlier ones."""
        h = self.effective_hit_rate() if hit_rate is None else hit_rate
        hh = self.effective_host_hit_rate() if host_hit_rate is None else host_hit_rate
        sh = (self.effective_session_hit_rate()
              if session_hit_rate is None else session_hit_rate)
        hh = min(max(hh, 0.0), max(1.0 - h, 0.0))
        sh = min(max(sh, 0.0), max(1.0 - h - hh, 0.0))
        return h, hh, sh

    def estimate_time(self, features, hit_rate: Optional[float] = None,
                      host_hit_rate: Optional[float] = None,
                      session_hit_rate: Optional[float] = None):
        h, hh, sh = self._tier_rates(hit_rate, host_hit_rate, session_hit_rate)
        tin = features.get("tokens_in", 128) + features.get("docs_tokens", 0)
        tout = features.get("tokens_out", self.max_new)
        # tiered prompt: HBM-shared tokens are free, host-promoted tokens
        # (doc and session-history classes alike) cost the copy, the rest
        # pays full prefill compute
        prefill = tin * ((1.0 - h - hh - sh) * self.prefill_per_token_s
                         + (hh + sh) * self.host_promote_per_token_s)
        avg_ctx = tin + 0.5 * tout  # mean context length over the decode
        decode = tout * (
            self.decode_per_token_s + avg_ctx * self.decode_cache_per_ctx_token_s
        )
        # TP shards the token work across tp_degree chips (comm-discounted);
        # the flat engine overhead (scheduling, sampling, host sync) does not
        # shrink with the mesh
        return self.base_time_s + (prefill + decode) / self.tp_speedup()

    def estimate_ttft(self, features, hit_rate: Optional[float] = None,
                      host_hit_rate: Optional[float] = None,
                      session_hit_rate: Optional[float] = None):
        """Time-to-first-token under chunked interleaved prefill: the
        non-shared prompt tokens stream through token-budget chunks, so TTFT
        scales with computed prompt tokens at the interleaved (per-step) rate
        rather than the saturated prefill throughput; host-promoted tokens
        (either class) pay the copy rate instead. TP divides the per-chunk
        compute like every other token term."""
        h, hh, sh = self._tier_rates(hit_rate, host_hit_rate, session_hit_rate)
        tin = features.get("tokens_in", 128) + features.get("docs_tokens", 0)
        return self.base_time_s + tin * (
            (1.0 - h - hh - sh) * self.ttft_per_prefill_token_s
            + (hh + sh) * self.host_promote_per_token_s
        ) / self.tp_speedup()

    def output_features(self, features):
        f = dict(features)
        f["tokens_out"] = features.get("tokens_out", self.max_new)
        return f


class VLLM(Generator):
    """Alias matching the paper's example code (vLLM-style generator)."""


class Grader(Generator):
    """LLM judge emitting a single relevance token — prefill-dominated.

    The paper observes the C-RAG grader takes ~1.8x the generator runtime
    (it must read the full retrieved context)."""

    base_time_s = 0.010
    decode_per_token_s = 0.0009

    def grade(self, docs_tokens, threshold: float = 0.5) -> bool:
        self._record()
        rnd = random.random()
        return rnd < threshold

    def estimate_time(self, features, hit_rate: Optional[float] = None,
                      host_hit_rate: Optional[float] = None,
                      session_hit_rate: Optional[float] = None):
        # reads the full retrieved context; ~1.8x the generator's runtime in
        # C-RAG per the paper's Fig. 10 measurement. Shared document blocks
        # discount this prefill-dominated stage like any Generator (host-
        # promoted blocks, either class, at the copy rate).
        h, hh, sh = self._tier_rates(hit_rate, host_hit_rate, session_hit_rate)
        tin = features.get("docs_tokens", 10000) + features.get("tokens_in", 0)
        prefill = tin * ((1.0 - h - hh - sh) * self.prefill_per_token_s * 3
                         + (hh + sh) * self.host_promote_per_token_s)
        return self.base_time_s + prefill + self.decode_per_token_s


class Rewriter(Generator):
    """Query rewriting LLM — short input, short output."""

    def rewrite(self, query):
        self._record()
        return query

    def estimate_time(self, features, hit_rate: Optional[float] = None,
                      host_hit_rate: Optional[float] = None):
        return self.base_time_s + features.get("tokens_in", 64) * self.prefill_per_token_s + 24 * self.decode_per_token_s


class Critic(Generator):
    """Self-RAG critic scoring a generation (single token out)."""

    def score(self, generation) -> float:
        self._record()
        return random.random()

    def estimate_time(self, features, hit_rate: Optional[float] = None,
                      host_hit_rate: Optional[float] = None):
        tin = features.get("tokens_out", 64) + features.get("docs_tokens", 0) * 0.2
        return self.base_time_s + tin * self.prefill_per_token_s * 3 + self.decode_per_token_s


class Reranker(Component):
    """Cross-encoder reranking of retrieved passages (GPU, prefill-bound) —
    the 'learned ranking and filtering' stage the paper cites as replacing
    simple concatenation in modern pipelines."""

    base_time_s = 0.008
    per_pair_s = 0.00025

    def rerank(self, query, docs, top_n: int = 20):
        """Keeps doc identity: the reranked result carries ids + scores so
        downstream prompt assembly (and the paged cache's document-keyed
        blocks) survive the reordering this stage introduces."""
        from repro_torch.serving.retrieval import ScoredDocs

        self._record()
        ids = list(docs)[:top_n]
        scores = getattr(docs, "scores", None)
        return ScoredDocs(ids, scores[: len(ids)] if scores else None)

    def estimate_time(self, features):
        return self.base_time_s + features.get("k_docs", 100) * self.per_pair_s

    def output_features(self, features):
        f = dict(features)
        f["k_docs"] = min(features.get("k_docs", 100), 20)
        f["docs_tokens"] = f["k_docs"] * 100
        return f


class GraphExpander(Component):
    """Graph-RAG neighborhood expansion over the document graph (CPU/memory
    bound; amplifies the retrieved set before reranking)."""

    base_time_s = 0.030
    per_unit_s = 0.0008
    unit_feature = "k_docs"

    def expand(self, docs, hops: int = 1):
        self._record()
        return list(docs) + [d + 100000 for d in list(docs)[: len(docs) // 2]]

    def output_features(self, features):
        f = dict(features)
        f["k_docs"] = features.get("k_docs", 100) * 1.5
        f["docs_tokens"] = f["k_docs"] * 100
        return f


class QueryClassifier(Component):
    """Adaptive-RAG complexity classifier (small encoder, CPU or tiny GPU)."""

    base_time_s = 0.006
    per_unit_s = 0.00002
    unit_feature = "tokens_in"

    def classify(self, query) -> str:
        self._record()
        r = random.random()
        return "simple" if r < 0.3 else ("standard" if r < 0.8 else "complex")


class Augmenter(Component):
    """Prompt construction from retrieved passages (pure CPU)."""

    base_time_s = 0.001
    per_unit_s = 0.000004
    unit_feature = "docs_tokens"

    def augment(self, query, docs):
        self._record()
        return {"query": query, "docs": docs}

    def build_prompt(self, query_tokens, docs, store, system_tokens=None):
        """Assemble the Generator's ``SegmentedPrompt`` from retrieval output:
        ``docs`` is the (possibly reranked) id list, ``store`` resolves ids to
        token arrays. Each document rides in its own segment carrying its
        retrieval-assigned doc_id, so the paged cache can share its KV blocks
        across requests regardless of the order this request put it at."""
        from repro_torch.serving.segments import assemble_prompt

        self._record()
        ids = list(docs)
        return assemble_prompt(
            query_tokens, store.tokens_for(ids), doc_ids=ids,
            system_tokens=system_tokens,
        )


class WebSearch(Component):
    """External tool call (network-bound stub with realistic latency)."""

    base_time_s = 0.150

    def __init__(self, output_format=list, latency_s: float = 0.150, jitter: float = 0.3):
        super().__init__()
        self.output_format = output_format
        self.base_time_s = latency_s
        self.jitter = jitter

    def search(self, query):
        self._record()
        return self.output_format(range(10))

    def estimate_time(self, features):
        return self.base_time_s * (1.0 + self.jitter * random.random())


def _embed_query(query, dim: int):
    """Hash-based deterministic query embedding (tokenizer-free substrate)."""
    seed = abs(hash(str(query))) % (2**31)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(dim).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-6)
