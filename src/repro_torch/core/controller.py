"""Patchwork runtime: centralized control plane + closed-loop orchestration.

SDN-style separation: the controller makes scheduling decisions (routing,
priorities, scaling, chunk sizes) while intermediate data flows directly
between producer and consumer instances; results come back through the
controller only when the program's control flow requires it. Controller
decision latency is REAL measured wall time of this code path (paper
Fig. 13: ~2ms, stable with load).

Mechanisms (each independently ablatable for Fig. 14):
  * resource reallocation — periodic LP re-solve with online-re-estimated
    alpha/gamma/p, applied under two-consecutive-agreement hysteresis;
  * load & state aware routing — predicted work incl. stateful re-entries;
  * EDF-with-slack scheduling — online-regression slack models;
  * communication granularity management — load-dependent streaming chunks.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.allocation import solve_allocation
from repro_torch.core.graph import WorkflowGraph
from repro_torch.core.profiling import profile_components
from repro_torch.core.router import Router
from repro_torch.core.scheduler import make_policy
from repro_torch.core.simcluster import Instance, Node, SimClock, Task, transfer_time
from repro_torch.core.slack import SlackModel
from repro_torch.core.spec import meta_of
from repro_torch.core.streaming import streaming_chunk_policy
from repro_torch.core.telemetry import Span, Telemetry

# ---------------------------------------------------------------------------
# engine configuration (ablation switches + baseline presets)
# ---------------------------------------------------------------------------


@dataclass
class EngineConfig:
    name: str = "patchwork"
    scheduler: str = "edf_slack"          # or "fifo"
    router_policy: str = "load_state"     # or "idle_first" / "random"
    autoscale: bool = True
    streaming: bool = True
    streaming_mgmt: bool = True           # adaptive chunk size (vs fixed fine)
    fixed_chunk: int = 4
    monolithic: bool = False              # LangChain-like single process
    reallocate_period_s: float = 10.0
    slo_multiplier: float = 2.0           # SLO = mult x low-load mean latency
    per_chunk_overhead_s: float = 0.0006
    streaming_contention: float = 2.5     # producer penalty factor at load 1.0


PATCHWORK = EngineConfig()
MONOLITHIC = EngineConfig(
    name="monolithic", scheduler="fifo", router_policy="random", autoscale=False,
    streaming=False, streaming_mgmt=False, monolithic=True,
)
RAY_LIKE = EngineConfig(
    name="ray_like", scheduler="fifo", router_policy="idle_first", autoscale=False,
    streaming=True, streaming_mgmt=False,
)


@dataclass
class RuntimeRequest:
    req_id: int
    arrival: float
    features: Dict[str, float]
    path: List[str]
    stage_idx: int = 0
    deadline: Optional[float] = None
    started: Optional[float] = None
    finished: Optional[float] = None
    trace: List[str] = field(default_factory=list)
    stage_times: Dict[str, float] = field(default_factory=dict)
    sticky: Dict[str, int] = field(default_factory=dict)  # stateful comp -> instance

    def remaining_path(self) -> List[str]:
        return self.path[self.stage_idx:]


@dataclass
class Metrics:
    engine: str = ""
    duration_s: float = 0.0
    completed: int = 0
    offered: int = 0
    finish_times: List[float] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)
    slo_violations: int = 0
    slo_s: float = 0.0
    comp_busy: Dict[str, float] = field(default_factory=dict)
    controller_overhead_s: List[float] = field(default_factory=list)
    realloc_events: int = 0
    chunk_history: List[Tuple[float, int]] = field(default_factory=list)
    instance_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def throughput(self) -> float:
        return self.completed / self.duration_s if self.duration_s else 0.0

    @property
    def goodput(self) -> float:
        """Completions that finished within the arrival window — the paper's
        Fig. 9 y-axis (sustained rate; queue growth shows up as the gap)."""
        if not self.duration_s:
            return 0.0
        return sum(1 for t in self.finish_times if t <= self.duration_s) / self.duration_s

    @property
    def slo_violation_rate(self) -> float:
        return self.slo_violations / max(self.completed, 1)

    def latency_pct(self, q: float) -> float:
        return float(np.percentile(self.latencies, q)) if self.latencies else 0.0


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


class PatchworkRuntime:
    def __init__(
        self,
        app,
        budgets: Dict[str, float],
        engine: EngineConfig = PATCHWORK,
        n_nodes: int = 4,
        node_spec: Dict[str, float] = None,
        seed: int = 0,
        slo_s: Optional[float] = None,
    ):
        self.app = app
        self.engine = engine
        self.budgets = dict(budgets)
        self.rng = np.random.default_rng(seed)
        self.clock = SimClock()
        spec = node_spec or {"cpu": 32.0, "gpu": 8.0, "ram": 256.0}
        self.nodes = [Node(i, **spec) for i in range(n_nodes)]
        self.router = Router(engine.router_policy, seed=seed)
        self.policy = make_policy(engine.scheduler)
        self.slack = SlackModel()
        self.telemetry = Telemetry()
        self.instances: Dict[str, List[Instance]] = {}
        self.metrics = Metrics(engine=engine.name)
        self.slo_s = slo_s
        self._traces: List[List[str]] = []
        self._service_obs: Dict[str, List[float]] = {}
        self._last_plan: Optional[Dict[str, int]] = None
        self._pending_plan: Optional[Dict[str, int]] = None
        self._in_flight = 0
        self._chunk_size = engine.fixed_chunk
        self._offered = 0

        profile_components(self.app.components, seed=seed)
        if engine.monolithic:
            self._deploy_monolithic()
        else:
            self._deploy_lp()

    # ------------------------------------------------------------ deployment
    def _graph(self) -> WorkflowGraph:
        return self.app.workflow_graph

    def _generator_tp_terms(self):
        """(tp_degree, tp_efficiency) dicts for the sharded Generators: the
        LP must see the degree AND each component's calibrated per-chip
        efficiency (tp_speedup(t)/t — tracks a fitted tp_comm_fraction, not
        the library default) from the very first solve, or the initial plan
        provisions t-chip replicas as 1-chip bundles."""
        from repro_torch.core.components import Generator

        tp_degree: Dict[str, int] = {}
        tp_eff: Dict[str, float] = {}
        for comp, obj in self.app.components.items():
            if isinstance(obj, Generator) and obj.tp_degree > 1:
                tp_degree[comp] = obj.tp_degree
                tp_eff[comp] = obj.tp_speedup() / obj.tp_degree
        return tp_degree, tp_eff

    def _deploy_lp(self):
        g = self._graph()
        min_inst = {c: meta_of(comp).base_instances for c, comp in self.app.components.items()}
        tp_degree, tp_eff = self._generator_tp_terms()
        plan = solve_allocation(g, self.budgets, min_instances=min_inst,
                                tp_degree=tp_degree or None,
                                tp_efficiency=tp_eff or None)
        self.plan = plan
        counts = plan.instances if plan.status == "optimal" else {
            c: max(meta_of(comp).base_instances, 1)
            for c, comp in self.app.components.items()
        }
        for comp in self.app.components:
            count = counts.get(comp, 1)
            meta = meta_of(self.app.components[comp])
            self.instances[comp] = []
            for _ in range(max(count, 1)):
                self._add_instance(comp, meta.resources, cold=False)
        self._last_plan = dict(counts)
        self.metrics.instance_counts = dict(counts)

    def _deploy_monolithic(self):
        """LangChain-like: whole workflow as one replicated process. Each
        replica reserves the union of stage resources; replicate until the
        budget is exhausted (coarse-grained scaling, the only knob)."""
        union: Dict[str, float] = {}
        for comp in self.app.components.values():
            for k, v in meta_of(comp).resources.items():
                union[k] = max(union.get(k, 0), v)
        union["GPU"] = max(union.get("GPU", 0), 1)
        n_replicas = int(
            min(
                self.budgets.get(k, float("inf")) // max(v, 1e-9)
                for k, v in union.items()
            )
        )
        self.instances["__pipeline__"] = []
        for _ in range(max(n_replicas, 1)):
            self._add_instance("__pipeline__", union, cold=False)
        self.metrics.instance_counts = {"__pipeline__": max(n_replicas, 1)}

    def _add_instance(self, comp: str, resources: Dict[str, float], cold: bool = True):
        node = next((n for n in self.nodes if n.fits(resources)), None)
        if node is None:
            node = min(self.nodes, key=lambda n: n.gpu_used + n.cpu_used / 64.0)
        node.take(resources)
        inst = Instance(comp, node, dict(resources))
        if cold:
            meta = meta_of(self.app.components.get(comp)) if comp in self.app.components else None
            inst.ready_at = self.clock.now + (meta.startup_cost_s if meta else 2.0)
        self.instances.setdefault(comp, []).append(inst)
        return inst

    # ------------------------------------------------------------ main loop
    def run(self, workload: List[Tuple[float, Dict[str, float]]],
            duration_s: Optional[float] = None) -> Metrics:
        for i, (t, feats) in enumerate(workload):
            self.clock.schedule(t, self._make_arrival(i, t, feats))
        if self.engine.autoscale:
            self.clock.schedule(self.engine.reallocate_period_s, self._reallocate)
        horizon = duration_s or (workload[-1][0] + 120.0 if workload else 0.0)
        self.clock.run(until=horizon)
        self.metrics.duration_s = max(
            (workload[-1][0] if workload else 0.0), 1e-9
        )
        self.metrics.offered = self._offered
        self.metrics.instance_counts = {c: len(v) for c, v in self.instances.items()}
        return self.metrics

    def _make_arrival(self, i, t, feats):
        def arrive():
            self._offered += 1
            path = (
                ["__pipeline__"]
                if self.engine.monolithic
                else self.app.sample_path(feats, self.rng)
            )
            req = RuntimeRequest(i, self.clock.now, dict(feats), path)
            if self.slo_s is not None:
                req.deadline = req.arrival + self.slo_s
            self._in_flight += 1
            self._dispatch(req)

        return arrive

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, req: RuntimeRequest, not_before: float = 0.0):
        t0 = time.perf_counter()
        comp = req.path[req.stage_idx]
        feats = req.features
        service = self._service_time(comp, feats)
        task = Task(req, comp, dict(feats), self.clock.now, service_s=service)
        if self.engine.scheduler == "edf_slack" and req.deadline is not None:
            task.priority = self.slack.slack(
                self.clock.now, req.deadline, req.remaining_path(), feats
            )
        meta = meta_of(self.app.components.get(comp)) if comp in self.app.components else None
        sticky = req.sticky.get(comp) if (meta and meta.stateful) else None
        inst = self.router.pick(
            self.instances[comp], task, self.clock.now,
            mean_service=self._mean_service(comp), sticky=sticky,
        )
        if meta and meta.stateful:
            req.sticky[comp] = inst.instance_id
            inst.outstanding_stateful += self._expected_reentries(comp)
        inst.queue.append(task)
        self.telemetry.gauge(f"queue_depth/{comp}", self.clock.now,
                             len(inst.queue) + inst.in_flight)
        self.metrics.controller_overhead_s.append(time.perf_counter() - t0)
        self._kick(inst)

    def _expected_reentries(self, comp: str) -> float:
        g = self._graph()
        rec = sum(e.prob for e in g.successors(comp) if e.recursive) if comp in g.nodes else 0.0
        return min(rec / max(1 - rec, 0.05), 3.0)

    def _service_time(self, comp: str, feats: Dict[str, float]) -> float:
        if comp == "__pipeline__":
            total = 0.0
            for c in self.app.sample_path(feats, self.rng):
                total += self.app.components[c].estimate_time(feats)
                feats = self.app.components[c].output_features(feats)
            return total
        return self.app.components[comp].estimate_time(feats)

    def _mean_service(self, comp: str) -> float:
        obs = self._service_obs.get(comp)
        if obs:
            return float(np.mean(obs[-256:]))
        return 0.02

    # ------------------------------------------------------------ execution
    def _kick(self, inst: Instance):
        if inst.in_flight >= inst.concurrency or not inst.queue:
            return
        if self.clock.now < inst.ready_at:
            self.clock.schedule(inst.ready_at - self.clock.now, lambda: self._kick(inst))
            return
        task = self.policy.pop(inst.queue, self.clock.now)
        if task is None:
            return
        inst.in_flight += 1
        service = task.service_s
        # streaming producer overhead: chunked emission contends with decode
        comp_obj = self.app.components.get(task.comp_name)
        streams = self.engine.streaming and _is_streaming_stage(comp_obj)
        if streams:
            tokens = task.features.get("tokens_out", 64.0)
            chunk = self._current_chunk_size(inst)
            n_chunks = max(tokens / max(chunk, 1), 1.0)
            load = min((len(inst.queue) + inst.in_flight) / 4.0, 1.0)
            service = service + n_chunks * self.engine.per_chunk_overhead_s * (
                1.0 + self.engine.streaming_contention * load
            )
            self.metrics.chunk_history.append((self.clock.now, chunk))
            self.telemetry.gauge(f"stream_chunk_size/{task.comp_name}",
                                 self.clock.now, float(chunk))
        inst.busy_time += service
        self.clock.schedule(service, lambda: self._complete(inst, task, streams))

    def _current_chunk_size(self, inst: Instance) -> int:
        if not self.engine.streaming_mgmt:
            return self.engine.fixed_chunk
        load = min((len(inst.queue) + inst.in_flight) / 4.0, 1.0)
        return streaming_chunk_policy(load)

    def _complete(self, inst: Instance, task: Task, streamed: bool):
        inst.in_flight -= 1
        inst.completed += 1
        req: RuntimeRequest = task.req
        comp = task.comp_name
        self.telemetry.record_span(Span(
            req.req_id, comp, inst.instance_id, task.enqueued_at,
            self.clock.now - task.service_s, self.clock.now,
        ))
        self.metrics.comp_busy[comp] = self.metrics.comp_busy.get(comp, 0.0) + task.service_s
        self._service_obs.setdefault(comp, []).append(task.service_s)
        self.slack.observe(comp, task.features, self.clock.now - task.enqueued_at)
        req.trace.append(comp)
        req.stage_times[comp] = req.stage_times.get(comp, 0.0) + task.service_s
        meta = meta_of(self.app.components.get(comp)) if comp in self.app.components else None
        if meta and meta.stateful and inst.outstanding_stateful > 0:
            inst.outstanding_stateful = max(inst.outstanding_stateful - 1.0, 0.0)

        if comp in self.app.components:
            req.features = self.app.components[comp].output_features(req.features)
        req.stage_idx += 1
        if req.stage_idx >= len(req.path):
            self._finish(req)
        else:
            # direct producer->consumer transfer; controller sees metadata only
            size_mb = req.features.get("docs_tokens", 0.0) * 4e-6 + 0.01
            nxt = req.path[req.stage_idx]
            same_node = bool(self.instances.get(nxt)) and any(
                i.node.node_id == inst.node.node_id for i in self.instances[nxt]
            )
            delay = transfer_time(size_mb, same_node)
            if streamed:
                # first chunks already arrived downstream: overlap most of the
                # transfer+queue latency (managed streaming's benefit)
                delay *= 0.25
            self.clock.schedule(delay, lambda: self._dispatch(req))
        self._kick(inst)

    def _finish(self, req: RuntimeRequest):
        req.finished = self.clock.now
        self._in_flight -= 1
        lat = req.finished - req.arrival
        self.metrics.completed += 1
        self.metrics.finish_times.append(req.finished)
        self.metrics.latencies.append(lat)
        self._traces.append(req.trace)
        if req.deadline is not None and req.finished > req.deadline:
            self.metrics.slo_violations += 1

    # ------------------------------------------------------------ failures
    def fail_instance(self, comp: str, instance_id: int):
        """Kill an instance: queued + in-flight tasks are re-dispatched, the
        replacement (if the plan still wants it) comes up with cold-start
        latency. Stateful requests pinned to the dead instance lose their
        affinity and re-pin on the next dispatch."""
        insts = self.instances.get(comp, [])
        dead = next((i for i in insts if i.instance_id == instance_id), None)
        if dead is None:
            return 0
        insts.remove(dead)
        dead.node.release(dead.resources)
        rescued = list(dead.queue)
        dead.queue.clear()
        for task in rescued:
            req = task.req
            req.sticky.pop(comp, None)
            req.stage_idx = max(req.stage_idx, 0)
            self._dispatch(req)
        meta = meta_of(self.app.components.get(comp))
        if meta and len(insts) < meta.base_instances:
            self._add_instance(comp, meta.resources, cold=True)
        self.metrics.failovers = getattr(self.metrics, "failovers", 0) + 1
        return len(rescued)

    # ------------------------------------------------------------ autoscaler
    def _reallocate(self):
        from repro_torch.core.components import Generator
        from repro_torch.core.profiling import generator_alpha_scale

        g = self._graph()
        # closed loop: re-estimate alpha from observed service, p from traces
        for comp, obs in self._service_obs.items():
            if comp in g.nodes and obs:
                meta = g.nodes[comp]
                dom = meta.dominant_resource()
                per_inst = meta.resources.get(dom, 1.0)
                meta.alpha = {dom: (1.0 / float(np.mean(obs[-512:]))) / per_inst}
                comp_obj = self.app.components.get(comp)
                if isinstance(comp_obj, Generator):
                    # the observed service times embed whatever hit rates the
                    # cache tiers were delivering while they were recorded
                    meta.alpha_hit_rate = comp_obj.effective_hit_rate()
                    meta.alpha_host_hit_rate = comp_obj.effective_host_hit_rate()
        if self._traces:
            g.update_from_traces(self._traces[-512:])
        # retrieval-aware cache feedback: a Generator whose measured prefix
        # or host-tier hit rate moved since its alpha was fitted gets the
        # capacity delta applied at solve time (export both rates online as
        # controller gauges for observability)
        alpha_scale: Dict[str, float] = {}
        for comp, comp_obj in self.app.components.items():
            if not isinstance(comp_obj, Generator) or comp not in g.nodes:
                continue
            h = comp_obj.effective_hit_rate()
            hh = comp_obj.effective_host_hit_rate()
            self.telemetry.gauge(f"prefix_hit_rate/{comp}", self.clock.now, h)
            self.telemetry.gauge(f"host_hit_rate/{comp}", self.clock.now, hh)
            baked = g.nodes[comp].alpha_hit_rate
            baked_host = g.nodes[comp].alpha_host_hit_rate
            scale = generator_alpha_scale(
                comp_obj, hit_rate=h, baseline_hit_rate=baked or 0.0,
                host_hit_rate=hh, baseline_host_hit_rate=baked_host or 0.0,
            )
            if abs(scale - 1.0) > 1e-3:
                alpha_scale[comp] = scale
        # sharded Generators: the LP provisions t chips per replica at each
        # component's calibrated per-chip efficiency (export for observability)
        tp_degree, tp_eff = self._generator_tp_terms()
        for comp, t in tp_degree.items():
            self.telemetry.gauge(f"tp_degree/{comp}", self.clock.now, float(t))
        min_inst = {c: meta_of(comp).base_instances for c, comp in self.app.components.items()}
        plan = solve_allocation(
            g, self.budgets, min_instances=min_inst,
            alpha_scale=alpha_scale or None,
            tp_degree=tp_degree or None,
            tp_efficiency=tp_eff or None,
        )
        if plan.status == "optimal":
            tgt = plan.instances
            # hysteresis: apply only if two consecutive solutions agree
            if self._pending_plan is not None and self._pending_plan == tgt and tgt != self._last_plan:
                self._apply_plan(tgt)
                self._last_plan = dict(tgt)
                self.metrics.realloc_events += 1
            self._pending_plan = dict(tgt)
        self.clock.schedule(self.engine.reallocate_period_s, self._reallocate)

    def _apply_plan(self, target: Dict[str, int]):
        for comp, want in target.items():
            cur = self.instances.get(comp, [])
            have = len([i for i in cur if not i.draining])
            meta = meta_of(self.app.components[comp])
            while have < want:
                self._add_instance(comp, meta.resources, cold=True)
                have += 1
            extra = have - want
            for inst in sorted(cur, key=lambda i: len(i.queue)):
                if extra <= 0:
                    break
                if not inst.draining and inst.outstanding_stateful == 0:
                    inst.draining = True
                    inst.node.release(inst.resources)
                    extra -= 1


def _is_streaming_stage(comp_obj) -> bool:
    from repro_torch.core.components import Generator

    return isinstance(comp_obj, Generator)
