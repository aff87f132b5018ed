"""The paper workflows (Table 1) written against the spec layer.

    Vanilla-RAG     retrieve -> generate                 (no cond, no rec)
    Corrective-RAG  retrieve -> grade -> [websearch ->] generate   (cond)
    Self-RAG        retrieve -> generate -> critic -> [rewrite -> loop]
    Adaptive-RAG    classify -> {llm | rag | multi-step rag loop}
    Plan-RAG        plan -> n x [retrieve -> generate] -> synthesize

Each app exposes:
  * a reference ``workflow()`` function in idiomatic Python (what a
    developer writes; used for AST graph capture),
  * ``sample_path(features, rng)`` — the stochastic per-request component
    sequence used by the discrete-event runtime (branch/recursion
    probabilities follow the published workflow semantics).

Beyond the simulated runtime, :class:`EnginePipeline` executes a sampled
path against the *real* paged ``GenerationEngine``: every ``Generator``-class
stage (generate / grade / critique / rewrite) becomes an engine request whose
priority is the request's predicted slack (``core.slack.SlackModel``) over
the remaining path, and every stage completion feeds the slack model's RLS
estimator. :class:`OpenLoopDriver` then replays a seeded
``core.workload`` trace open-loop — arrivals on the trace clock, multi-turn
sessions serialized per session — and reports per-SLO-class violation rates.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.components import (
    Augmenter,
    Critic,
    Generator,
    Grader,
    GraphExpander,
    QueryClassifier,
    Reranker,
    Retriever,
    Rewriter,
    WebSearch,
)
from repro_torch.core.graph import WorkflowGraph, capture_from_ast
from repro_torch.core.spec import make, meta_of


@dataclass
class RAGApp:
    name: str
    components: Dict[str, object]
    workflow_graph: WorkflowGraph
    sampler: Callable
    workflow_fn: Callable = None
    workflow_loc: int = 0           # lines of workflow-spec code (Table 2)

    def sample_path(self, features: Dict[str, float], rng) -> List[str]:
        return self.sampler(features, rng)


def _decorated(cls, **kw):
    return make(**kw)(cls)


# ---------------------------------------------------------------------------
# Vanilla RAG
# ---------------------------------------------------------------------------


def make_vanilla_rag(index=None, engine=None) -> RAGApp:
    R = _decorated(type("VRetriever", (Retriever,), {}),
                   base_instances=1, resources={"CPU": 8, "RAM": 112})
    G = _decorated(type("VGenerator", (Generator,), {}),
                   base_instances=1, resources={"GPU": 1, "CPU": 2}, streaming=True)
    retriever, generator = R(index), G(engine)
    comps = {"VRetriever": retriever, "VGenerator": generator}

    def workflow(query):
        docs = retriever.retrieve(query)
        return generator.generate(docs)

    graph = capture_from_ast(workflow, {"retriever": retriever, "generator": generator},
                             "vanilla-rag")

    def sampler(feats, rng) -> List[str]:
        return ["VRetriever", "VGenerator"]

    return RAGApp("vrag", comps, graph, sampler, workflow, workflow_loc=6)


# ---------------------------------------------------------------------------
# Corrective RAG (Yan et al. 2024) — conditional, no recursion
# ---------------------------------------------------------------------------


def make_corrective_rag(index=None, engine=None, p_relevant: float = 0.7) -> RAGApp:
    R = _decorated(type("CRetriever", (Retriever,), {}),
                   base_instances=1, resources={"CPU": 8, "RAM": 112})
    Gr = _decorated(type("CGrader", (Grader,), {}),
                    base_instances=2, stateful=True, resources={"GPU": 1})
    W = _decorated(type("CWebSearch", (WebSearch,), {}), base_instances=1,
                   resources={"CPU": 1})
    Rw = _decorated(type("CRewriter", (Rewriter,), {}), base_instances=1,
                    resources={"GPU": 1})
    G = _decorated(type("CGenerator", (Generator,), {}),
                   base_instances=1, resources={"GPU": 1, "CPU": 2}, streaming=True)
    retriever, grader, web, rewriter, generator = R(index), Gr(), W(), Rw(), G(engine)
    comps = {c.meta.name: c for c in (retriever, grader, web, rewriter, generator)}

    def workflow(query):
        docs = retriever.retrieve(query)
        ok = grader.grade(docs)
        if not ok:
            better = rewriter.rewrite(query)
            docs = web.search(better)
            return generator.generate(docs)
        return generator.generate(docs)

    graph = capture_from_ast(
        workflow,
        {"retriever": retriever, "grader": grader, "web": web,
         "rewriter": rewriter, "generator": generator},
        "corrective-rag",
    )

    def sampler(feats, rng) -> List[str]:
        path = ["CRetriever", "CGrader"]
        if rng.random() > p_relevant:
            path += ["CRewriter", "CWebSearch"]
        path.append("CGenerator")
        return path

    return RAGApp("crag", comps, graph, sampler, workflow, workflow_loc=12)


# ---------------------------------------------------------------------------
# Self-RAG (Asai et al. 2024) — conditional + recursive
# ---------------------------------------------------------------------------


def make_self_rag(index=None, engine=None, p_accept: float = 0.65,
                  max_iters: int = 3) -> RAGApp:
    R = _decorated(type("SRetriever", (Retriever,), {}),
                   base_instances=1, resources={"CPU": 8, "RAM": 112})
    G = _decorated(type("SGenerator", (Generator,), {}),
                   base_instances=2, stateful=True, resources={"GPU": 1}, streaming=True)
    C = _decorated(type("SCritic", (Critic,), {}), base_instances=1,
                   resources={"GPU": 1})
    Rw = _decorated(type("SRewriter", (Rewriter,), {}), base_instances=1,
                    resources={"GPU": 1})
    retriever, generator, critic, rewriter = R(index), G(engine), C(), Rw()
    comps = {c.meta.name: c for c in (retriever, generator, critic, rewriter)}

    def workflow(query):
        docs = retriever.retrieve(query)
        answer = generator.generate(docs)
        score = critic.score(answer)
        while score < 0.5:
            query = rewriter.rewrite(query)
            docs = retriever.retrieve(query)
            answer = generator.generate(docs)
            score = critic.score(answer)
        return answer

    graph = capture_from_ast(
        workflow,
        {"retriever": retriever, "generator": generator, "critic": critic,
         "rewriter": rewriter},
        "self-rag",
    )

    def sampler(feats, rng) -> List[str]:
        path = ["SRetriever", "SGenerator", "SCritic"]
        it = 0
        while rng.random() > p_accept and it < max_iters:
            path += ["SRewriter", "SRetriever", "SGenerator", "SCritic"]
            it += 1
        return path

    return RAGApp("srag", comps, graph, sampler, workflow, workflow_loc=14)


# ---------------------------------------------------------------------------
# Adaptive RAG (Jeong et al. 2024) — path-dependent, recursive subgraph
# ---------------------------------------------------------------------------


def make_adaptive_rag(index=None, engine=None,
                      mix=(0.3, 0.5, 0.2), max_steps: int = 3) -> RAGApp:
    Q = _decorated(type("AClassifier", (QueryClassifier,), {}), base_instances=1,
                   resources={"CPU": 4})
    R = _decorated(type("ARetriever", (Retriever,), {}),
                   base_instances=1, resources={"CPU": 8, "RAM": 112})
    G = _decorated(type("AGenerator", (Generator,), {}),
                   base_instances=2, stateful=True, resources={"GPU": 1}, streaming=True)
    Rw = _decorated(type("ARewriter", (Rewriter,), {}), base_instances=1,
                    resources={"GPU": 1})
    classifier, retriever, generator, rewriter = Q(), R(index), G(engine), Rw()
    comps = {c.meta.name: c for c in (classifier, retriever, generator, rewriter)}

    def workflow(query):
        kind = classifier.classify(query)
        if kind == "simple":
            return generator.generate(query)
        if kind == "standard":
            docs = retriever.retrieve(query)
            return generator.generate(docs)
        docs = retriever.retrieve(query)
        for _ in range(3):
            query = rewriter.rewrite(query)
            docs = retriever.retrieve(query)
        return generator.generate(docs)

    graph = capture_from_ast(
        workflow,
        {"classifier": classifier, "retriever": retriever,
         "generator": generator, "rewriter": rewriter},
        "adaptive-rag",
    )

    def sampler(feats, rng) -> List[str]:
        c = feats.get("complexity", rng.random())
        if c < mix[0]:
            return ["AClassifier", "AGenerator"]
        if c < mix[0] + mix[1]:
            return ["AClassifier", "ARetriever", "AGenerator"]
        path = ["AClassifier", "ARetriever"]
        steps = 1 + int(rng.integers(1, max_steps + 1))
        for _ in range(steps):
            path += ["ARewriter", "ARetriever"]
        path.append("AGenerator")
        return path

    return RAGApp("arag", comps, graph, sampler, workflow, workflow_loc=20)


# ---------------------------------------------------------------------------
# Graph RAG (Edge et al. 2024-style) — retrieval amplification + reranking
# ---------------------------------------------------------------------------


def make_graph_rag(index=None, engine=None) -> RAGApp:
    """retrieve -> graph-expand (gamma > 1) -> rerank -> generate. The paper's
    Fig. 3 'Graph RAG' workflow where retrieval+expansion dominate (62% of
    runtime) and the LP provisions retrievers 3:1 over generators."""
    R = _decorated(type("GRetriever", (Retriever,), {}),
                   base_instances=1, resources={"CPU": 8, "RAM": 112})
    X = _decorated(type("GExpander", (GraphExpander,), {}),
                   base_instances=1, resources={"CPU": 4, "RAM": 32})
    Rk = _decorated(type("GReranker", (Reranker,), {}), base_instances=1,
                    resources={"GPU": 1})
    G = _decorated(type("GGenerator", (Generator,), {}),
                   base_instances=1, resources={"GPU": 1, "CPU": 2}, streaming=True)
    retriever, expander, reranker, generator = R(index), X(), Rk(), G(engine)
    comps = {c.meta.name: c for c in (retriever, expander, reranker, generator)}

    def workflow(query):
        docs = retriever.retrieve(query)
        expanded = expander.expand(docs)
        top = reranker.rerank(query, expanded)
        return generator.generate(top)

    graph = capture_from_ast(
        workflow,
        {"retriever": retriever, "expander": expander,
         "reranker": reranker, "generator": generator},
        "graph-rag",
    )
    # expansion amplifies downstream work
    graph.nodes["GExpander"].gamma = 1.5

    def sampler(feats, rng) -> List[str]:
        return ["GRetriever", "GExpander", "GReranker", "GGenerator"]

    return RAGApp("graphrag", comps, graph, sampler, workflow, workflow_loc=8)


# ---------------------------------------------------------------------------
# Plan-then-RAG — data-dependent stage count (the planner's decomposition
# width is only known at runtime, the paper's hardest case for slack
# prediction: the EDF priority must be re-estimated as sub-queries resolve)
# ---------------------------------------------------------------------------


def make_plan_rag(index=None, engine=None, max_subqs: int = 3) -> RAGApp:
    P = _decorated(type("PPlanner", (Rewriter,), {}), base_instances=1,
                   resources={"GPU": 1})
    R = _decorated(type("PRetriever", (Retriever,), {}),
                   base_instances=1, resources={"CPU": 8, "RAM": 112})
    G = _decorated(type("PGenerator", (Generator,), {}),
                   base_instances=2, stateful=True, resources={"GPU": 1})
    S = _decorated(type("PSynthesizer", (Generator,), {}),
                   base_instances=1, resources={"GPU": 1, "CPU": 2}, streaming=True)
    planner, retriever, generator, synth = P(), R(index), G(engine), S(engine)
    comps = {c.meta.name: c for c in (planner, retriever, generator, synth)}

    def workflow(query):
        plan = planner.rewrite(query)
        notes = query
        for sub in plan:
            docs = retriever.retrieve(sub)
            notes = generator.generate(docs)
        return synth.generate(notes)

    graph = capture_from_ast(
        workflow,
        {"planner": planner, "retriever": retriever,
         "generator": generator, "synth": synth},
        "plan-rag",
    )

    def sampler(feats, rng) -> List[str]:
        # decomposition width grows with query complexity, plus planner noise
        c = feats.get("complexity", rng.random())
        n = 1 + int(c * max_subqs)
        if rng.random() < 0.25:
            n = min(n + 1, max_subqs + 1)
        path = ["PPlanner"]
        for _ in range(n):
            path += ["PRetriever", "PGenerator"]
        path.append("PSynthesizer")
        return path

    return RAGApp("planrag", comps, graph, sampler, workflow, workflow_loc=10)


def make_app(name: str, index=None, engine=None) -> RAGApp:
    from repro_torch.apps import APPS

    return APPS[name](index, engine)


# ---------------------------------------------------------------------------
# Real-engine execution: sampled paths as resumable engine-request pipelines
# ---------------------------------------------------------------------------

# per-stage decode budgets: control stages emit verdict-sized outputs, the
# answer stage carries the request's own budget
_STAGE_MAX_NEW = {Grader: 2, Critic: 2, Rewriter: 6}


def _stage_max_new(comp, default: int) -> int:
    for cls, n in _STAGE_MAX_NEW.items():
        if isinstance(comp, cls):
            return n
    return default


class EnginePipeline:
    """One request's sampled path, executed stage-by-stage on the real engine.

    The pipeline is a resumable state machine: ``poll(now)`` advances through
    CPU stages synchronously (retrieval draws doc ids from a small shared
    universe so document KV blocks actually collide across requests) and
    returns control while an engine-backed stage — any ``Generator``
    subclass: generate, grade, critique, rewrite — is in flight. Each engine
    submit carries ``priority = SlackModel.slack(now, deadline, remaining
    path, stage features)``, so EDF-slack admission orders work by predicted
    deadline slack; each stage completion is observed back into the model
    (data-dependent paths re-estimate as they unfold). A ``Session`` threads
    multi-turn history into the answer stage's prompt and is committed with
    the decoded answer when the path drains.
    """

    #: shared retrieval universe (small so cross-request doc reuse is real)
    n_docs = 32
    #: web-search results live in a disjoint id range
    web_offset = 10_000

    def __init__(self, app: RAGApp, engine, *, query_tokens, rng,
                 complexity: float = 0.5, k_docs: int = 2, max_new: int = 8,
                 deadline: float = float("inf"), slack=None, doc_store=None,
                 session=None, event=None):
        from repro_torch.serving.retrieval import DocTokenStore

        self.app = app
        self.engine = engine
        self.rng = rng
        self.slack = slack
        self.session = session
        self.event = event
        self.deadline = float(deadline)
        self.k_docs = int(k_docs)
        self.max_new = int(max_new)
        self.doc_store = doc_store or DocTokenStore()
        self.query = np.atleast_1d(np.asarray(query_tokens, np.int32))
        self._query0 = self.query
        self.features = {"tokens_in": float(self.query.size),
                         "tokens_out": float(max_new),
                         "k_docs": float(k_docs),
                         "docs_tokens": 0.0,
                         "complexity": float(complexity)}
        self.path = app.sample_path(dict(self.features), rng)
        self.stage = 0
        self.doc_ids: List[int] = []
        self.answer = np.zeros(0, np.int32)
        self.requests: List[object] = []
        self._inflight = None      # (request, name, t_submit, features)
        self._seen: Dict[str, int] = {}
        self.done = False
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None

    # ------------------------------------------------------------- stages
    def _engine_path_remaining(self) -> List[str]:
        return self.path[self.stage:]

    def _stage_features(self, name: str) -> Dict[str, float]:
        docs_tokens = len(self.doc_ids) * self.doc_store.doc_len
        return {"tokens_in": float(self.query.size),
                "tokens_out": float(_stage_max_new(
                    self.app.components[name], self.max_new)),
                "k_docs": float(len(self.doc_ids)),
                "docs_tokens": float(docs_tokens),
                "iteration": float(self._seen.get(name, 0))}

    def _build_prompt(self, comp, is_answer_stage: bool):
        from repro_torch.serving.segments import (KIND_DOC, KIND_TAIL, Segment,
                                            SegmentedPrompt)

        doc_toks = self.doc_store.tokens_for(self.doc_ids)
        if isinstance(comp, Rewriter):
            segs, docs, ids = [], [], None          # rewriting reads the query
        elif isinstance(comp, Critic):
            segs, docs, ids = [], [], None          # critiques the last answer
        else:
            docs, ids = doc_toks, list(self.doc_ids)
            segs = [Segment(t, KIND_DOC, doc_id=d) for t, d in zip(docs, ids)]
        if is_answer_stage and self.session is not None:
            return self.session.prompt(self.query, docs, ids)
        tail = self.answer if isinstance(comp, Critic) and self.answer.size \
            else self.query
        segs = list(segs)
        segs.append(Segment(np.atleast_1d(tail), KIND_TAIL))
        return SegmentedPrompt(segs)

    def poll(self, now: float) -> bool:
        """Advance as far as possible; True once the whole path drained."""
        if self.started_at is None:
            self.started_at = now
        while not self.done:
            if self._inflight is not None:
                req, name, t0, feats = self._inflight
                if not req.done:
                    return False
                if self.slack is not None:
                    self.slack.observe(name, feats, max(now - t0, 0.0))
                comp = self.app.components[name]
                out = np.asarray(req.out_tokens, np.int32)
                if isinstance(comp, Rewriter) and out.size:
                    self.query = out                 # rewritten query flows on
                elif not isinstance(comp, (Grader, Critic)):
                    self.answer = out                # candidate answer so far
                self.requests.append(req)
                self._inflight = None
                self.stage += 1
                continue
            if self.stage >= len(self.path):
                if self.session is not None:
                    self.session.commit(self._query0, self.answer)
                self.done = True
                self.finished_at = now
                return True
            name = self.path[self.stage]
            comp = self.app.components[name]
            self._seen[name] = self._seen.get(name, 0) + 1
            if isinstance(comp, Generator):          # covers Grader/Critic/Rewriter
                feats = self._stage_features(name)
                prio = 0.0
                if self.slack is not None:
                    prio = self.slack.slack(now, self.deadline,
                                            self._engine_path_remaining(), feats)
                is_answer = self.stage == len(self.path) - 1
                req = self.engine.submit(
                    self._build_prompt(comp, is_answer),
                    max_new=_stage_max_new(comp, self.max_new),
                    temperature=0.0, priority=prio)
                self._inflight = (req, name, now, feats)
                return False
            # CPU stages resolve synchronously on the driver thread
            if isinstance(comp, Retriever):
                k = min(self.k_docs, self.n_docs)
                self.doc_ids = sorted(
                    int(d) for d in self.rng.choice(self.n_docs, size=k,
                                                    replace=False))
            elif isinstance(comp, WebSearch):
                self.doc_ids = [self.web_offset + int(d) for d in
                                self.rng.integers(0, self.n_docs,
                                                  size=max(self.k_docs, 1))]
            elif isinstance(comp, GraphExpander):
                extra = [int(d) for d in self.rng.choice(self.n_docs,
                                                         size=1)]
                self.doc_ids = sorted(set(self.doc_ids) | set(extra))
            elif isinstance(comp, Reranker):
                self.doc_ids = self.doc_ids[: max(self.k_docs, 1)]
            # QueryClassifier / Augmenter: pure routing, nothing to resolve
            self.stage += 1
        return True


# ---------------------------------------------------------------------------
# Open-loop trace replay
# ---------------------------------------------------------------------------


class VirtualClock:
    """Deterministic trace clock: advances ``dt`` per engine step. Tests use
    this so the same seed yields the same arrival interleaving regardless of
    host speed."""

    def __init__(self, dt: float = 0.002):
        self.dt = dt
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def advance(self) -> None:
        self.t += self.dt

    def idle(self, until: float) -> None:
        self.t = max(self.t, until)


class WallClock:
    """Real-time trace clock for benchmarking the actual engine: trace time
    is wall time since ``start()`` (so measured latencies are genuine)."""

    def __init__(self):
        self._t0 = None

    def now(self) -> float:
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0

    def advance(self) -> None:
        pass

    def idle(self, until: float) -> None:
        d = until - self.now()
        if d > 0:
            time.sleep(min(d, 0.05))


class OpenLoopDriver:
    """Replay a ``core.workload`` trace against the real engine, open-loop.

    Arrivals are released on the trace clock whether or not the engine has
    capacity — queueing under overload therefore surfaces as deadline misses,
    which is the point of the SLO experiment. Session turns additionally
    serialize: turn ``k`` is held until turn ``k-1``'s pipeline drains (a
    user cannot send the next message before seeing the previous answer),
    and its deadline is measured from that release. Each released event
    becomes an :class:`EnginePipeline` for its SLO class's app; one shared
    :class:`~repro_torch.core.slack.SlackModel` learns stage latencies across the
    whole run and prices every engine submit's EDF priority.
    """

    def __init__(self, engine, apps: Dict[str, RAGApp], events, *,
                 slack=None, doc_store=None, clock=None, seed: int = 0,
                 session_system_tokens: int = 16, max_steps: int = 2_000_000):
        from repro_torch.core.slack import SlackModel
        from repro_torch.serving.retrieval import DocTokenStore
        from repro_torch.serving.session import Session

        self.engine = engine
        self.apps = apps
        self.events = sorted(events, key=lambda e: (e.t, e.request_id))
        self.slack = slack if slack is not None else SlackModel()
        self.doc_store = doc_store or DocTokenStore()
        self.clock = clock or VirtualClock()
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._session_cls = Session
        self._session_system = self._rng.integers(
            0, 90, size=session_system_tokens).astype(np.int32)
        self.sessions: Dict[int, object] = {}
        self.records: List[Dict[str, float]] = []

    def _start(self, e, now: float) -> "EnginePipeline":
        rng = np.random.default_rng(e.seed)
        sess = None
        if e.session_id >= 0:
            sess = self.sessions.get(e.session_id)
            if sess is None:
                sess = self._session_cls(
                    session_id=e.session_id,
                    system_tokens=self._session_system)
                self.sessions[e.session_id] = sess
        q = rng.integers(0, 90, size=max(e.query_len, 1)).astype(np.int32)
        return EnginePipeline(
            self.apps[e.slo_class], self.engine, query_tokens=q, rng=rng,
            complexity=e.complexity, k_docs=e.k_docs, max_new=e.max_new,
            deadline=now + e.deadline_s, slack=self.slack,
            doc_store=self.doc_store, session=sess, event=e)

    def run(self) -> List[Dict[str, float]]:
        pending = list(self.events)         # sorted; pop from the front
        held: Dict[int, List] = {}          # session_id -> queued turn events
        busy: Dict[int, bool] = {}          # session_id -> turn in flight
        active: List[EnginePipeline] = []
        steps = 0
        while (pending or active or any(held.values())) \
                and steps < self.max_steps:
            now = self.clock.now()
            while pending and pending[0].t <= now:
                e = pending.pop(0)
                if e.session_id >= 0 and (busy.get(e.session_id)
                                          or held.get(e.session_id)):
                    held.setdefault(e.session_id, []).append(e)
                    continue
                if e.session_id >= 0:
                    busy[e.session_id] = True
                active.append(self._start(e, now))
            still = []
            for p in active:
                if p.poll(now):
                    self._finish(p, now)
                    e = p.event
                    if e is not None and e.session_id >= 0:
                        busy[e.session_id] = False
                        q = held.get(e.session_id)
                        if q:   # release the next turn the moment we drain
                            nxt = q.pop(0)
                            busy[e.session_id] = True
                            still.append(self._start(nxt, now))
                else:
                    still.append(p)
            active = still
            if active or self.engine.waiting or any(self.engine.slots) \
                    or self.engine.pending:
                self.engine.step()
                self.clock.advance()
            elif pending:
                self.clock.idle(pending[0].t)
            steps += 1
        self.engine.run_until_done()
        now = self.clock.now()
        for p in active:    # anything still in flight at step exhaustion
            if p.poll(now):
                self._finish(p, now)
        return self.records

    def _finish(self, p: EnginePipeline, now: float) -> None:
        e = p.event
        self.records.append({
            "slo_class": e.slo_class if e is not None else p.app.name,
            "session_id": getattr(e, "session_id", -1),
            "arrival": p.started_at,
            "finish": p.finished_at if p.finished_at is not None else now,
            "deadline": p.deadline,
            "latency": (p.finished_at if p.finished_at is not None else now)
                       - p.started_at,
            "violated": float((p.finished_at
                               if p.finished_at is not None else now)
                              > p.deadline),
            "stages": len(p.path),
        })

    def violation_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-SLO-class completion counts, violation rate and mean latency
        — the paper's headline table."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            c = out.setdefault(r["slo_class"],
                               {"completed": 0.0, "violations": 0.0,
                                "latency_sum": 0.0})
            c["completed"] += 1
            c["violations"] += r["violated"]
            c["latency_sum"] += r["latency"]
        for c in out.values():
            c["violation_rate"] = c["violations"] / c["completed"]
            c["mean_latency_s"] = c["latency_sum"] / c["completed"]
            del c["latency_sum"]
        return out
