"""Deployment-layer resource allocation: the paper's Fig. 8 generalized
network-flow LP.

    max  sum_{(u,t) in E} f_ut                          (throughput at sink)
    s.t. sum_i r_{i,k} <= C_k                 forall k   (resource budgets)
         sum_u f_ui <= sum_k alpha_{i,k} r_{i,k}  forall i (node capacity)
         f_ij = p_ij * gamma_i * sum_u f_ui   forall (i,j) (branch routing)
         f, r >= 0

Node capacities are *endogenous decision variables* (resources r_{i,k}),
which is what distinguishes this from a classical max-flow. Solved with
scipy's HiGHS (the paper uses Gurobi); the formulation is linear, so solve
time stays in the milliseconds even at 1024 nodes (paper Fig. 12, reproduced
in benchmarks/lp_scalability.py). scipy is imported inside
``solve_allocation``, so importing this module (and the controller) needs
no scipy.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.graph import SINK, SOURCE, WorkflowGraph


@dataclass
class AllocationPlan:
    throughput: float                       # requests/s at the sink
    resources: Dict[str, Dict[str, float]]  # node -> {resource: units}
    instances: Dict[str, int]               # node -> integer instance count
    flows: Dict[Tuple[str, str], float]
    solve_time_s: float
    status: str


def _default_tp_efficiency(t: int, comm_fraction: float = 0.08) -> float:
    """Per-chip efficiency s(t)/t of a tp-sharded Generator replica under the
    saturating speedup s(t) = t / (1 + f*(t-1)) (components.Generator
    .tp_speedup): compute splits t ways, the per-layer all-reduce pair does
    not. Equals 1 at t=1 and decays toward f as t grows."""
    if t <= 1:
        return 1.0
    return 1.0 / (1.0 + comm_fraction * (t - 1))


def solve_allocation(
    graph: WorkflowGraph,
    budgets: Dict[str, float],
    min_instances: Optional[Dict[str, int]] = None,
    source_rate: Optional[float] = None,
    alpha_scale: Optional[Dict[str, float]] = None,
    resource_penalty: float = 0.0,
    tp_degree: Optional[Dict[str, int]] = None,
    tp_efficiency=None,
    kv_capacity_scale: Optional[Dict[str, float]] = None,
) -> AllocationPlan:
    """Solve the Fig. 8 LP for the captured workflow graph.

    ``budgets``: total units per resource type (e.g. {"GPU": 32, "CPU": 256}).
    ``source_rate``: if given, cap offered load (useful for what-if queries);
    otherwise maximize achievable throughput.
    ``alpha_scale``: per-component capacity multipliers applied to the fitted
    alpha — the retrieval-aware cache feedback path: a Generator whose
    measured prefix hit rate makes requests cheaper gets alpha scaled up
    (``profiling.generator_alpha_scale``), so the LP provisions fewer
    replicas for the same load as cache effectiveness shifts. The scale folds
    BOTH cache tiers: HBM-shared prompt tokens are free, host-tier
    (``HostBlockStore``) promotions cost only the block-copy rate — the
    controller passes measured ``prefix_hit_rate`` and ``host_hit_rate``
    against the rates baked into the fitted alpha, keeping the discount
    linear in r (a pure alpha multiplier, never a new constraint).
    ``resource_penalty``: tiny per-resource-unit objective cost; with a
    ``source_rate`` cap the throughput optimum is degenerate in resources, so
    a nonzero penalty makes the solver return the *cheapest* optimal plan
    (visible replica savings) instead of an arbitrary vertex.
    ``tp_degree``: component -> tensor-parallel degree of each replica (the
    sharded-pool engine spans ``t`` chips per replica). The LP stays linear:
    the fitted per-chip alpha is multiplied by the per-chip efficiency
    ``tp_efficiency`` — either a ``{component: efficiency}`` dict (the
    controller passes each Generator's calibrated ``tp_speedup(t) / t``) or a
    callable ``t -> efficiency`` (default: the saturating Megatron-collective
    model ``1 / (1 + 0.08*(t-1))``, matching ``Generator.tp_speedup`` at its
    default ``tp_comm_fraction``) — and instance counting treats ``t``
    dominant-resource bundles as ONE replica, so the plan reports sharded
    replica counts and tp degrees that buy latency at sub-linear throughput
    cost show up as extra provisioned chips.
    ``kv_capacity_scale``: per-component KV-capacity multipliers
    (``components.Generator.kv_capacity_scale`` — the ratio of the fitted
    alpha's baseline KV bytes/token to the deployed pool's). An int8 paged
    pool (``kv_dtype="int8"``) holds ~2x the concurrent context per HBM
    byte, so at a KV-capacity-bound operating point each resource unit
    sustains proportionally more load; folded into the alpha exactly like
    ``alpha_scale``, so the LP provisions fewer Generator replicas at equal
    offered load while staying linear.
    """
    from scipy.optimize import linprog

    t0 = time.perf_counter()
    tp_degree = tp_degree or {}
    if isinstance(tp_efficiency, dict):
        eff_map = tp_efficiency

        def tp_eff(comp, t):
            return eff_map.get(comp, _default_tp_efficiency(t))
    else:
        eff_fn = tp_efficiency or _default_tp_efficiency

        def tp_eff(comp, t):
            return eff_fn(t)
    comps = graph.component_names()
    res_types = sorted(budgets)
    n, k = len(comps), len(res_types)
    comp_idx = {c: i for i, c in enumerate(comps)}

    # Recursion is folded into gamma_i (expected re-entries amplify a node's
    # work); back edges are excluded from the flow DAG and the remaining
    # outgoing probabilities renormalized — this is how the paper keeps the
    # formulation linear and acyclic.
    fwd = [e for e in graph.edges if not e.recursive and e.src != e.dst]
    out_tot: Dict[str, float] = {}
    for e in fwd:
        out_tot[e.src] = out_tot.get(e.src, 0.0) + e.prob
    edges = [(e.src, e.dst, e.prob / max(out_tot.get(e.src, 1.0), 1e-9)) for e in fwd]
    edge_idx = {(s, d): i for i, (s, d, _) in enumerate(edges)}
    m = len(edges)

    # variables: [f_0..f_{m-1}, r_{0,0}..r_{n-1,k-1}]
    nvar = m + n * k

    def rvar(i, j):
        return m + i * k + j

    # objective: maximize flow into SINK (minus an optional tiny resource cost)
    c = np.zeros(nvar)
    for (s, d), ei in edge_idx.items():
        if d == SINK:
            c[ei] = -1.0
    if resource_penalty:
        c[m:] += resource_penalty

    A_ub, b_ub, A_eq, b_eq = [], [], [], []

    # resource budgets: sum_i r_{i,k} <= C_k
    for j, rt in enumerate(res_types):
        row = np.zeros(nvar)
        for i in range(n):
            row[rvar(i, j)] = 1.0
        A_ub.append(row)
        b_ub.append(budgets[rt])

    # node capacity: gamma-amplified inflow_i - sum_k alpha_{i,k} r_{i,k} <= 0
    # (a node visited ~1/(1-rec) times per request must provision for it)
    for ci, comp in enumerate(comps):
        row = np.zeros(nvar)
        amp = graph.effective_gamma(comp) / max(graph.nodes[comp].gamma, 1e-9)
        for (s, d), ei in edge_idx.items():
            if d == comp:
                row[ei] = amp
        meta = graph.nodes[comp]
        scale = (alpha_scale or {}).get(comp, 1.0)
        # tp-sharded replicas: per-chip capacity discounted by the collective
        # overhead of spanning t chips (keeps the constraint linear in r)
        scale *= tp_eff(comp, tp_degree.get(comp, 1))
        # KV-capacity-bound components: a quantized pool holds more context
        # per HBM byte, so each replica sustains proportionally more load
        scale *= (kv_capacity_scale or {}).get(comp, 1.0)
        for j, rt in enumerate(res_types):
            alpha = meta.alpha.get(rt, 0.0) * scale
            row[rvar(ci, j)] = -alpha
        A_ub.append(row)
        b_ub.append(0.0)

    # branching: f_ij - p_ij * gamma_i * inflow_i = 0   (i != SOURCE)
    for (s, d), ei in edge_idx.items():
        if s == SOURCE:
            continue
        row = np.zeros(nvar)
        row[ei] = 1.0
        gamma = graph.effective_gamma(s)
        p = next(pp for (ss, dd, pp) in edges if ss == s and dd == d)
        for (s2, d2), ei2 in edge_idx.items():
            if d2 == s:
                row[ei2] -= p * gamma
        A_eq.append(row)
        b_eq.append(0.0)

    # resource bundles: an instance needs its resources in fixed proportion
    # (8 CPU + 112 RAM per retriever), so r_{i,k} = (need_k/need_dom) r_{i,dom}
    for ci, comp in enumerate(comps):
        meta = graph.nodes[comp]
        dom = meta.dominant_resource()
        if dom not in res_types:
            continue
        jd = res_types.index(dom)
        for j, rt in enumerate(res_types):
            if rt == dom:
                continue
            need = meta.resources.get(rt, 0.0)
            row = np.zeros(nvar)
            row[rvar(ci, j)] = 1.0
            row[rvar(ci, jd)] = -need / max(meta.resources.get(dom, 1.0), 1e-9)
            A_eq.append(row)
            b_eq.append(0.0)

    # source conservation: outgoing source flows in fixed proportions
    src_edges = [ei for (s, d), ei in edge_idx.items() if s == SOURCE]
    if source_rate is not None:
        row = np.zeros(nvar)
        for ei in src_edges:
            row[ei] = 1.0
        A_ub.append(row)
        b_ub.append(source_rate)

    # minimum base instances: r_{i, dominant} >= base * need
    bounds = [(0, None)] * nvar
    min_instances = min_instances or {}
    for comp, base in min_instances.items():
        if comp not in comp_idx:
            continue
        meta = graph.nodes[comp]
        dom = meta.dominant_resource()
        if dom in res_types:
            j = res_types.index(dom)
            # a minimum of `base` replicas reserves base*t bundles when sharded
            need = meta.resources.get(dom, 1.0) * base * max(tp_degree.get(comp, 1), 1)
            bounds[rvar(comp_idx[comp], j)] = (need, None)

    result = linprog(
        c,
        A_ub=np.array(A_ub) if A_ub else None,
        b_ub=np.array(b_ub) if b_ub else None,
        A_eq=np.array(A_eq) if A_eq else None,
        b_eq=np.array(b_eq) if b_eq else None,
        bounds=bounds,
        method="highs",
    )
    dt = time.perf_counter() - t0

    if not result.success:
        return AllocationPlan(0.0, {}, {}, {}, dt, f"infeasible: {result.message}")

    x = result.x
    resources: Dict[str, Dict[str, float]] = {}
    instances: Dict[str, int] = {}
    for ci, comp in enumerate(comps):
        meta = graph.nodes[comp]
        alloc = {rt: float(x[rvar(ci, j)]) for j, rt in enumerate(res_types)}
        resources[comp] = alloc
        dom = meta.dominant_resource()
        # one tp-sharded replica spans t dominant-resource bundles
        per_inst = meta.resources.get(dom, 1.0) * max(tp_degree.get(comp, 1), 1)
        raw = alloc.get(dom, 0.0) / max(per_inst, 1e-9)
        instances[comp] = max(int(math.floor(raw + 1e-6)), min_instances.get(comp, 0), 1)
    flows = {(s, d): float(x[ei]) for (s, d), ei in edge_idx.items()}
    # report user-facing throughput: flow leaving the SOURCE (requests/s).
    # The objective maximizes sink flow (paper Fig. 8); with amplification
    # gamma the two differ by the path's amplification product.
    src_flow = sum(f for (a, _), f in flows.items() if a == SOURCE)
    return AllocationPlan(src_flow, resources, instances, flows, dt, "optimal")


def random_graph(n_nodes: int, seed: int = 0) -> WorkflowGraph:
    """Synthetic layered workflow graphs for the Fig. 12 scalability study."""
    from repro_torch.core.spec import ComponentMeta

    rng = np.random.default_rng(seed)
    g = WorkflowGraph(f"synthetic-{n_nodes}")
    names = [f"c{i}" for i in range(n_nodes)]
    for nm in names:
        meta = ComponentMeta(name=nm, resources={"CPU": 1})
        meta.alpha = {"CPU": float(rng.uniform(5, 50)), "GPU": float(rng.uniform(0, 20))}
        meta.gamma = float(rng.uniform(0.8, 1.2))
        g.add_node(meta)
    g.add_edge(SOURCE, names[0])
    for i, nm in enumerate(names[:-1]):
        fanout = min(1 + int(rng.integers(0, 2)), n_nodes - i - 1)
        for f in range(fanout):
            g.add_edge(nm, names[i + 1 + f], prob=1.0 / fanout)
    g.add_edge(names[-1], SINK)
    for nm in names:
        if not g.successors(nm):
            g.add_edge(nm, SINK)
    g.normalize_probs()
    return g
