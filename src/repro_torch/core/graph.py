"""Workflow graph IR + capture (AST scan and runtime trace).

The core insight reproduced here: although the programming model is
imperative, the RAG backbone is a DAG with profile-driven conditional edges.
We extract just the component-level call graph — not a full-program
compilation — by (a) statically scanning the workflow function's AST for
call sites of decorated components, and (b) refining edge probabilities and
amplification factors from runtime traces.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.spec import ComponentMeta, meta_of

SOURCE = "__source__"
SINK = "__sink__"


@dataclass
class Edge:
    src: str
    dst: str
    prob: float = 1.0
    recursive: bool = False
    count: int = 0  # runtime trace counter


@dataclass
class WorkflowGraph:
    name: str
    nodes: Dict[str, ComponentMeta] = field(default_factory=dict)
    edges: List[Edge] = field(default_factory=list)

    # ------------------------------------------------------------ structure
    def add_node(self, meta: ComponentMeta):
        self.nodes.setdefault(meta.name, meta)

    def add_edge(self, src: str, dst: str, prob: float = 1.0, recursive: bool = False):
        for e in self.edges:
            if e.src == src and e.dst == dst:
                e.prob = max(e.prob, prob)
                e.recursive = e.recursive or recursive
                return e
        e = Edge(src, dst, prob, recursive)
        self.edges.append(e)
        return e

    def successors(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.src == name]

    def predecessors(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.dst == name]

    def component_names(self) -> List[str]:
        return [n for n in self.nodes if n not in (SOURCE, SINK)]

    def normalize_probs(self):
        """Make outgoing probabilities sum to 1 per node (paper constraint)."""
        for name in list(self.nodes) + [SOURCE]:
            out = self.successors(name)
            total = sum(e.prob for e in out)
            if total > 0:
                for e in out:
                    e.prob /= total

    # ------------------------------------------------------------ telemetry
    def update_from_traces(self, traces: List[List[str]]):
        """Re-estimate p_ij (and implicitly recursion rates) from observed
        per-request component sequences — the runtime layer's closed loop."""
        counts: Dict[Tuple[str, str], int] = {}
        for tr in traces:
            path = [SOURCE] + tr + [SINK]
            for a, b in zip(path[:-1], path[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + 1
        out_totals: Dict[str, int] = {}
        for (a, _), c in counts.items():
            out_totals[a] = out_totals.get(a, 0) + c
        for (a, b), c in counts.items():
            e = self.add_edge(a, b)
            e.count = c
            e.prob = c / out_totals[a]
            if self._is_back_edge(a, b):
                e.recursive = True

    def _is_back_edge(self, a: str, b: str) -> bool:
        """Heuristic: an edge to a node that (transitively) reaches `a`."""
        seen: Set[str] = set()
        stack = [b]
        while stack:
            n = stack.pop()
            if n == a:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(e.dst for e in self.successors(n) if not e.recursive)
        return False

    def effective_gamma(self, name: str) -> float:
        """Amplification including expected recursive re-entries."""
        meta = self.nodes.get(name)
        base = meta.gamma if meta else 1.0
        rec = sum(e.prob for e in self.successors(name) if e.recursive)
        rec = min(rec, 0.95)
        return base / (1.0 - rec)  # geometric series of re-entries


# ---------------------------------------------------------------------------
# runtime capture
# ---------------------------------------------------------------------------

_capture_ctx = threading.local()


class capture:
    """Context manager: component calls inside record the execution trace.

    with capture() as trace:
        retrieved = retriever.retrieve(q)
        ...
    """

    def __init__(self):
        self.trace: List[str] = []

    def __enter__(self):
        _capture_ctx.active = self
        return self

    def __exit__(self, *exc):
        _capture_ctx.active = None
        return False


def record_call(component_name: str):
    ctx = getattr(_capture_ctx, "active", None)
    if ctx is not None:
        ctx.trace.append(component_name)


# ---------------------------------------------------------------------------
# AST capture
# ---------------------------------------------------------------------------


def capture_from_ast(workflow_fn, env: Dict[str, Any], name: str = "workflow") -> WorkflowGraph:
    """Static scan of a workflow function: derive the component DAG.

    ``env`` maps variable names to component instances (as in the paper's
    Figure 7, where `retriever`, `grader`, ... are module-level instances).
    Conditionals produce branch edges (default p=0.5 until profiled); loops
    and calls inside While/For are marked recursive.
    """
    src = textwrap.dedent(inspect.getsource(workflow_fn))
    tree = ast.parse(src)
    g = WorkflowGraph(name)
    comp_of_var = {k: meta_of(v) for k, v in env.items() if meta_of(v) is not None}
    for m in comp_of_var.values():
        g.add_node(m)

    def walk(stmts, frontier: Set[str], in_loop: bool) -> Set[str]:
        for stmt in stmts:
            if isinstance(stmt, (ast.If,)):
                # frontier forks: each branch starts from the same frontier
                f_body = walk(stmt.body, set(frontier), in_loop)
                f_else = walk(stmt.orelse, set(frontier), in_loop) if stmt.orelse else set(frontier)
                frontier = f_body | f_else
                continue
            if isinstance(stmt, (ast.While, ast.For)):
                f_loop = walk(stmt.body, set(frontier), True)
                # back edge: loop body may feed itself
                for a in f_loop:
                    for b in _first_components(stmt.body, comp_of_var):
                        g.add_edge(a, b, prob=0.3, recursive=True)
                frontier = frontier | f_loop
                continue
            if isinstance(stmt, ast.Return):
                for call_name in _component_calls(stmt, comp_of_var):
                    for f in frontier:
                        g.add_edge(f, call_name)
                    if not frontier:
                        g.add_edge(SOURCE, call_name)
                    frontier = {call_name}
                for f in frontier:
                    g.add_edge(f, SINK)
                frontier = set()  # nothing flows past a return
                continue
            calls = _component_calls(stmt, comp_of_var)
            for call_name in calls:
                if not frontier:
                    g.add_edge(SOURCE, call_name)
                for f in frontier:
                    # NOTE: sequential edges inside a loop body are normal
                    # forward edges; only the explicit tail->head back edge
                    # is recursive (it gets folded into gamma, not flow)
                    g.add_edge(f, call_name)
                frontier = {call_name}
        return frontier

    fn_def = tree.body[0]
    assert isinstance(fn_def, (ast.FunctionDef, ast.AsyncFunctionDef))
    final = walk(fn_def.body, set(), False)
    for f in final:
        g.add_edge(f, SINK)
    if not g.predecessors(SINK):
        for n in g.component_names():
            if not g.successors(n):
                g.add_edge(n, SINK)
    g.normalize_probs()
    return g


def _component_calls(node, comp_of_var) -> List[str]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            base = sub.func.value
            if isinstance(base, ast.Name) and base.id in comp_of_var:
                out.append(comp_of_var[base.id].name)
    return out


def _first_components(stmts, comp_of_var) -> List[str]:
    for stmt in stmts:
        calls = _component_calls(stmt, comp_of_var)
        if calls:
            return calls[:1]
    return []
