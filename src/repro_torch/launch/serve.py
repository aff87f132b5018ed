"""Serving launcher of the port: serve a model with batched requests on one
device through the paged generation engine, replay an open-loop trace of
mixed RAG pipelines on it, or run a RAG application under the Patchwork
runtime on a simulated cluster (the control plane is real, compute
occupancy comes from the components' cost models).

    PYTHONPATH=src python -m repro_torch.launch.serve --app crag --rate 24 --duration 10
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --kv-dtype int8 --preempt swap --host-blocks 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --kernel reference --no-interleave --sanitize
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --dp 2 --host-blocks 64 --audit
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu \
        --tp 2 --dp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --pipelines --arch smollm-135m --smoke --device cpu

Giving ``--app NAME`` selects the simulated mode (``serve_sim``, with
``--engine``, ``--slo``, ``--rate``, ``--duration`` and ``--seed``): it does
host work only and takes no device. Without ``--app`` the launcher serves
the model as before (``--pipelines`` for the open-loop trace); the
reference launcher instead runs ``serve_sim`` whenever neither ``--real``
nor ``--pipelines`` is given.

Weights are random, drawn by ``init_params`` from ``--seed``. Runs on
``cuda`` unless ``--device cpu`` is given (and raises without a GPU). An
arch outside the paged contract (rwkv6-7b, hymba-1.5b, mixtral-8x22b,
qwen2.5-3b-swa, llama4-scout-17b-a16e, minicpm3-4b, internvl2-1b, text
only) is served on the dense backend. whisper-large-v3 is not served: the
engine takes no encoder frames (nor does the JAX engine).

``--tp N`` serves on a tensor-parallel group of N spawned ranks over gloo
(``serve_tp``): each rank holds its shard of the weights and ``KVH / N``
heads of every pool block, the layers all-reduce after the attention
output and MLP down projections, and the summary prints the fused step's
collective census; on ``cuda`` rank r takes ``cuda:r`` (N GPUs visible).
As the JAX launcher, it refuses ``--kernel pallas`` and ``--kv-dtype
int8`` with ``--tp``. ``--tp T --dp N`` (``serve_tp_dp``) spawns T x N
ranks on a (N, T) ("data", "model") mesh and serves through a
``DataParallelEngineGroup`` whose replicas are the mesh's rows, each rank
holding only its replica's block range of its heads (``dp_blocks``), with
a host tier of ``--host-blocks`` a rank that the rows exchange what they
write through; the summary prints the fused step's census by group.

``--dp N`` alone serves through a ``DataParallelEngineGroup``: N replicas
over block ranges of one shared pool on the one device, with one host tier
(``--host-blocks``) they write through to. The JAX launcher refuses its
Pallas kernels and int8 pools with ``--dp``, because its ``--dp`` builds a
data-axis mesh; the port's replicas share one device and no mesh, so they
take either kernel and either pool dtype. ``--audit`` runs the step-program
contract audit (``analysis.step_audit``) on the engine, replica 0 under
``--dp``, before any traffic, and exits on a violation.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.apps import APPS, make_app
from repro_torch.core.controller import MONOLITHIC, PATCHWORK, RAY_LIKE, PatchworkRuntime

ENGINES = {"patchwork": PATCHWORK, "monolithic": MONOLITHIC, "ray_like": RAY_LIKE}
DEFAULT_BUDGETS = {"GPU": 32, "CPU": 256, "RAM": 1024}


def serve_sim(app_name: str, rate: float, duration: float, engine: str = "patchwork",
              slo_s: float = 2.0, seed: int = 0, budgets=None):
    """Run ``app_name`` under the Patchwork runtime on the simulated cluster
    (``PatchworkRuntime`` with the ``engine`` preset) for a Poisson workload
    of ``rate`` requests/s over ``duration`` trace-seconds; print the
    reference launcher's summary line and return the ``Metrics``."""
    from repro_torch.data.workload import make_workload

    app = make_app(app_name)
    rt = PatchworkRuntime(app, budgets or DEFAULT_BUDGETS, engine=ENGINES[engine],
                          slo_s=slo_s, seed=seed)
    wl = make_workload(rate, duration, seed=seed)
    m = rt.run(wl)
    print(f"[serve:{engine}] app={app_name} rate={rate}/s: "
          f"thr={m.throughput:.1f}/s p50={m.latency_pct(50)*1e3:.0f}ms "
          f"p99={m.latency_pct(99)*1e3:.0f}ms slo_viol={m.slo_violation_rate*100:.1f}% "
          f"ctrl={np.mean(m.controller_overhead_s)*1e3:.3f}ms")
    return m


def serve_real(arch: str, n_requests: int = 8, max_new: int = 12,
               pipeline: bool = True, smoke: bool = False, device=None,
               seed: int = 0, preempt: str = "recompute", host_blocks: int = 0,
               kv_dtype: Optional[str] = None, kernel: str = "pallas",
               interleave: bool = True, sanitize: bool = False, dp: int = 1,
               audit: bool = False):
    """Serve ``n_requests`` random prompts (4-31 tokens) on ``arch`` (its
    smoke variant with ``smoke``) and print the per-request and summary
    lines of the JAX launcher. ``kv_dtype="int8"`` stores the paged pools
    quantized; ``host_blocks > 0`` attaches a host tier of that many
    blocks; ``preempt`` is ``"recompute"``, ``"swap"`` or ``"cost"`` (the
    last two provision a pool-sized host tier when ``host_blocks`` is 0).
    ``kernel="reference"`` reads attention through the gather oracles
    instead of the paged kernels; ``interleave=False`` runs the sequential
    oracle loop; ``sanitize`` shadows the KV block lifecycle (the summary
    prints its operation counts). ``dp > 1`` serves through a
    ``DataParallelEngineGroup`` of ``dp`` replicas over one pool (the host
    tier shared); ``audit`` runs the step audit first (replica 0 under
    ``dp``) and raises ``SystemExit`` on a violation. Returns the engine, or
    the group."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.serving.engine import DataParallelEngineGroup, GenerationEngine

    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    kw = dict(max_batch=4, max_seq=256, pipeline=pipeline, seed=seed, device=device,
              preempt=preempt, host_blocks=host_blocks or None, kv_dtype=kv_dtype,
              kernel=kernel, interleave=interleave, sanitize=sanitize)
    eng = DataParallelEngineGroup(cfg, dp=dp, **kw) if dp > 1 else GenerationEngine(cfg, **kw)
    if audit:
        # contract audit before any traffic: collective census, host-sync
        # scan, int8 flow, cache sentinel (analysis.step_audit)
        from repro_torch.analysis.step_audit import audit_engine

        report = audit_engine(eng.engines[0] if dp > 1 else eng)
        for line in report.render().splitlines():
            print(f"[serve:audit] {line}")
        if not report.ok:
            raise SystemExit("[serve:audit] step-program contract violated")
    rng = np.random.default_rng(seed)
    reqs = [
        eng.submit(rng.integers(0, cfg.vocab_size, rng.integers(4, 32)), max_new)
        for _ in range(n_requests)
    ]
    eng.run_until_done()
    for r in reqs:
        ss = r.stream.stats if r.stream is not None else None
        chunks = f" chunks={ss.chunks_flushed}" if ss else ""
        print(f"  req {r.req_id}: {len(r.out_tokens)} tokens "
              f"ttft={1e3*(r.first_token_at - r.submitted_at):.0f}ms{chunks}")
    if dp > 1:
        st = eng.stats()
        for i, rs in enumerate(st["replicas"]):
            print(f"[serve:real] replica {i}: {rs['tokens_out']} tokens out, "
                  f"{rs['steps']} steps, host-hit tokens {rs['host_hit_tokens']}")
        print(f"[serve:real] {cfg.name}: dp={dp} device={st['replicas'][0]['device']} "
              f"kernel={st['replicas'][0]['kernel']} kv={st['replicas'][0]['kv_dtype']} "
              f"{st['tokens_out']} tokens out; cross-replica host hits "
              f"{st.get('cross_replica_host_hits', 0)}")
        if "host_store" in st:
            print(f"[serve:real] host tier: {st['host_store']}")
        return eng
    stats = eng.stats()
    mode = "pipelined" if stats["pipeline"] else "sync"
    print(f"[serve:real] {cfg.name}: device={stats['device']} backend={stats['backend']} "
          f"mode={mode} kernel={stats['kernel']} kv={stats.get('kv_dtype', cfg.dtype)} "
          f"{stats['tokens_out']} tokens out")
    if "kernel_impl" in stats:
        print(f"[serve:real] paged paths: interleave={stats['interleave']} "
              f"ragged={stats['ragged']} kernel_impl={stats['kernel_impl']}")
    if "preempt" in stats:
        print(f"[serve:real] preempt={stats['preempt']}: {stats['preemptions']} preemptions, "
              f"{stats['swap_outs']} swap outs, {stats['swap_ins']} swap ins")
    if "padded_token_fraction" in stats:
        print(f"[serve:real] fused-step padding: "
              f"{100 * stats['padded_token_fraction']:.1f}% of slot tokens")
    if "host_gap_s" in stats:
        print(f"[serve:real] host gap: {1e3 * stats['host_gap_s']:.1f}ms total "
              f"over {stats['dispatches']} dispatches "
              f"(copy ops drained: {stats['copy_ops_drained']})")
        totals, steps = stats["telemetry"]["totals"], max(stats["steps"], 1)
        spans = " ".join(f"{name} {1e3 * totals.get(name, (0.0, 0))[0] / steps:.2f}"
                         for name in ("plan", "plan.admit", "launch", "wait", "emit"))
        deferred = stats["telemetry"]["counters"].get("admit.deferred_prefix", 0)
        print(f"[serve:real] step spans, ms a step: {spans}; "
              f"admit.deferred_prefix {deferred} of {stats['steps']} steps")
    if "host_store" in stats:
        print(f"[serve:real] host tier: {stats['host_store']}")
    if eng.sanitizer is not None:
        print(f"[serve:real] kvsan: {eng.sanitizer.stats()}; ops by hook "
              f"{dict(sorted(eng.sanitizer.op_counts.items()))}")
    return eng


def _serve_rank(rank, mesh, device, kw):
    """One rank of ``serve_tp``: the engine on this rank's shard, the same
    seeded prompts as every rank; rank 0 prints. Returns (tokens of each
    request, the fused step's census, stats)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.sharded_pool import ShardedPoolLayout

    cfg = get_arch(kw["arch"])
    if kw["smoke"]:
        cfg = smoke_variant(cfg)
    eng = GenerationEngine(cfg, max_batch=4, max_seq=256, pipeline=kw["pipeline"],
                           seed=kw["seed"], device=device, kernel="reference",
                           pool_layout=ShardedPoolLayout(mesh))
    census = eng.audit_collectives("fused")
    rng = np.random.default_rng(kw["seed"])
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, rng.integers(4, 32)), kw["max_new"])
            for _ in range(kw["n_requests"])]
    eng.run_until_done()
    stats = eng.stats()
    if rank == 0:
        for r in reqs:
            print(f"  req {r.req_id}: {len(r.out_tokens)} tokens "
                  f"ttft={1e3*(r.first_token_at - r.submitted_at):.0f}ms")
        print(f"[serve:real] {cfg.name}: tp={stats['tp_degree']} device={stats['device']} "
              f"kernel={stats['kernel']} {stats['tokens_out']} tokens out on each rank")
        print(f"[serve:real] fused-step collectives: "
              f"{ {k: v for k, v in census.items() if v} }")
    return [r.out_tokens for r in reqs], census, stats


def serve_tp(arch: str, tp: int, n_requests: int = 8, max_new: int = 12,
             pipeline: bool = True, smoke: bool = False, device=None, seed: int = 0):
    """Serve ``n_requests`` random prompts on a tensor-parallel group of
    ``tp`` ranks (``launch.mesh.run_on_ranks``: spawned processes over gloo,
    a ``FileStore`` rendezvous): each rank holds its shard of the weights
    and ``KVH / tp`` heads of every pool block, and the gather oracles read
    attention (``kernel="reference"``, as the JAX engine requires on a
    mesh). On ``cuda`` rank r takes ``cuda:r``. Prints the requests, the
    summary and the fused step's collective census; raises unless every
    rank gave the same tokens. Returns each rank's (tokens, census,
    stats)."""
    from repro_torch.launch.mesh import run_on_ranks

    kw = dict(arch=arch, n_requests=n_requests, max_new=max_new, pipeline=pipeline,
              smoke=smoke, seed=seed)
    results = run_on_ranks(_serve_rank, tp, "cuda" if device is None else device, kw)
    if any(res[0] != results[0][0] for res in results):
        raise AssertionError("tensor-parallel ranks gave different tokens")
    return results


def _serve_group_rank(rank, mesh, device, kw):
    """One rank of ``serve_tp_dp``: its row's replica of the group, the
    same seeded prompts submitted on every rank; rank 0 prints. Returns
    (tokens of each request, the fused step's census by group, stats)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.serving.engine import DataParallelEngineGroup
    from repro_torch.serving.sharded_pool import ShardedPoolLayout

    cfg = get_arch(kw["arch"])
    if kw["smoke"]:
        cfg = smoke_variant(cfg)
    layout = ShardedPoolLayout(mesh, dp_blocks=True)
    grp = DataParallelEngineGroup(cfg, dp=layout.dp_degree, max_batch=4, max_seq=256,
                                  pipeline=kw["pipeline"], seed=kw["seed"], device=device,
                                  kernel="reference", pool_layout=layout,
                                  host_blocks=kw["host_blocks"] or None)
    census = grp.engine.audit_collectives("fused", by_group=True)
    rng = np.random.default_rng(kw["seed"])
    reqs = [grp.submit(rng.integers(0, cfg.vocab_size, rng.integers(4, 32)), kw["max_new"])
            for _ in range(kw["n_requests"])]
    grp.run_until_done()
    st = grp.stats()
    if rank == 0:
        for r in reqs:
            print(f"  req {r.req_id} on replica {grp.replica_of(r)}: {len(r.out_tokens)} "
                  f"tokens ttft={1e3*(r.first_token_at - r.submitted_at):.0f}ms")
        for i, rs in enumerate(st["replicas"]):
            print(f"[serve:real] replica {i}: {rs['tokens_out']} tokens out, "
                  f"{rs['steps']} steps, pool shard {rs['tp_degree']}-way by head, "
                  f"host-hit tokens {rs['host_hit_tokens']}")
        print(f"[serve:real] {cfg.name}: dp={layout.dp_degree} tp={layout.tp_degree} "
              f"device={st['replicas'][0]['device']} {st['tokens_out']} tokens out; this "
              f"rank's pool {tuple(grp.engine.kv.k.shape)}; cross-replica host hits "
              f"{st.get('cross_replica_host_hits', 0)}")
        print(f"[serve:real] fused-step collectives by group: "
              f"{ {a: {k: v for k, v in c.items() if v} for a, c in census.items()} }")
    return [r.out_tokens for r in reqs], census, st


def serve_tp_dp(arch: str, tp: int, dp: int, n_requests: int = 8, max_new: int = 12,
                pipeline: bool = True, smoke: bool = False, device=None, seed: int = 0,
                host_blocks: int = 0):
    """Serve ``n_requests`` random prompts on a ("data", "model") mesh of
    ``dp`` rows of ``tp`` ranks (``launch.mesh.run_on_ranks``): each row is
    one replica of a ``DataParallelEngineGroup``, each rank holds its
    replica's block range of its ``KVH / tp`` heads (``dp_blocks``) and the
    gather oracles read attention. On ``cuda`` rank r takes ``cuda:r``.
    Prints the requests, the replicas and the fused step's census by group;
    raises unless every rank returned the same tokens. Returns each rank's
    (tokens, census, stats)."""
    from repro_torch.launch.mesh import run_on_ranks

    kw = dict(arch=arch, n_requests=n_requests, max_new=max_new, pipeline=pipeline,
              smoke=smoke, seed=seed, host_blocks=host_blocks)
    results = run_on_ranks(_serve_group_rank, tp, "cuda" if device is None else device, kw,
                           dp=dp)
    if any(res[0] != results[0][0] for res in results):
        raise AssertionError("the mesh's ranks gave different tokens")
    return results


def serve_pipelines(arch: str = "smollm-135m", rate: float = 10.0,
                    duration: float = 2.0, *, arrival: str = "poisson",
                    session_fraction: float = 0.3, host_blocks: int = 128,
                    seed: int = 0, wall_clock: bool = False, smoke: bool = False,
                    device=None, params=None, dtype: Optional[str] = None,
                    apps: Optional[Sequence[str]] = None, max_batch: int = 4,
                    max_seq: int = 256, prefill_chunk_size: int = 32,
                    token_budget: Optional[int] = 64, doc_len: Optional[int] = None):
    """Adaptive RAG pipelines open-loop on the engine: a seeded
    ``core.workload`` trace of mixed SLO classes (multi-turn sessions
    included) replays through ``apps.OpenLoopDriver`` with EDF-slack
    priorities; prints the per-class violation rates and the session-KV
    reuse, and returns the driver.

    ``apps`` restricts the SLO classes (default: all of ``DEFAULT_CLASSES``);
    ``doc_len`` sizes the documents (``DocTokenStore(vocab=cfg.vocab_size,
    doc_len=doc_len)``; default: the reference's ``DocTokenStore()``); the
    trace runs on a ``VirtualClock(dt=0.02)``, or a ``WallClock`` with
    ``wall_clock``. The engine arguments default to the reference
    launcher's, a host block tier of 128 blocks included (``host_blocks=0``:
    none)."""
    from repro_torch.apps import OpenLoopDriver, VirtualClock, WallClock, make_app
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.core.workload import DEFAULT_CLASSES, WorkloadSpec, generate
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.retrieval import DocTokenStore

    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    eng = GenerationEngine(cfg, params=params, max_batch=max_batch, max_seq=max_seq,
                           prefill_chunk_size=prefill_chunk_size, token_budget=token_budget,
                           scheduler="edf_slack", host_blocks=host_blocks or None,
                           seed=seed, device=device)
    classes = [c for c in DEFAULT_CLASSES if apps is None or c.name in apps]
    drv_apps = {c.name: make_app(c.name, engine=eng) for c in classes}
    spec = WorkloadSpec(rate_rps=rate, duration_s=duration, arrival=arrival,
                        classes=tuple(classes), session_fraction=session_fraction,
                        think_time_s=0.3)
    clock = WallClock() if wall_clock else VirtualClock(dt=0.02)
    store = DocTokenStore(vocab=cfg.vocab_size, doc_len=doc_len) if doc_len else None
    drv = OpenLoopDriver(eng, drv_apps, generate(spec, seed=seed), clock=clock,
                         seed=seed, doc_store=store)
    t0 = time.perf_counter()
    drv.run()
    wall = time.perf_counter() - t0
    for name, s in sorted(drv.violation_summary().items()):
        print(f"[serve:pipelines] {name}: {int(s['completed'])} done "
              f"viol={100 * s['violation_rate']:.1f}% "
              f"mean_e2e={s['mean_latency_s']:.3f}s")
    st = eng.stats()
    ls = eng.latency_summary()
    print(f"[serve:pipelines] session KV: {st['session_shared_tokens']} device-shared "
          f"tokens, {st['session_hit_tokens']} host-promoted tokens "
          f"(session_hit_rate={ls.get('session_hit_rate', 0.0):.3f}); prefix-hit tokens "
          f"{st['prefix_hit_tokens']}; {st['steps']} steps, "
          f"{st['tokens_out']} tokens out in {wall:.2f}s wall "
          f"(device={st['device']}, kernel={st['kernel']})")
    if "host_store" in st:
        print(f"[serve:pipelines] host tier: {st['host_store']}")
    return drv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default=None, choices=list(APPS),
                    help="run this RAG application on the simulated cluster "
                         "(serve_sim) instead of serving the model")
    ap.add_argument("--engine", default="patchwork", choices=list(ENGINES),
                    help="--app runtime preset")
    ap.add_argument("--slo", type=float, default=2.0,
                    help="--app end-to-end SLO (seconds)")
    ap.add_argument("--arch", default="qwen2.5-3b",
                    choices=["smollm-135m", "qwen2.5-3b", "phi3-medium-14b", "rwkv6-7b",
                             "hymba-1.5b", "mixtral-8x22b", "qwen2.5-3b-swa",
                             "llama4-scout-17b-a16e", "minicpm3-4b", "internvl2-1b"])
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's 2-layer smoke variant")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default cuda; cpu runs the plain attention versions")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="materialize each step before building the next "
                         "(the sync oracle)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipelines", action="store_true",
                    help="replay a seeded open-loop trace of mixed RAG "
                         "pipelines (sessions included) on the engine and "
                         "report per-SLO-class violation rates")
    ap.add_argument("--rate", type=float, default=10.0,
                    help="--app / --pipelines arrival rate (requests/s)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="--app / --pipelines trace length (trace seconds)")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "diurnal", "bursty"],
                    help="arrival process for --pipelines traces")
    ap.add_argument("--sessions", type=float, default=0.3,
                    help="fraction of --pipelines arrivals opening "
                         "multi-turn sessions")
    ap.add_argument("--wall-clock", action="store_true",
                    help="pace --pipelines arrivals in real time instead of "
                         "the deterministic virtual clock")
    ap.add_argument("--host-blocks", type=int, default=0,
                    help="host-memory block tier capacity (0: none, unless "
                         "--preempt swap/cost provisions a pool-sized one; "
                         "--pipelines then takes the reference's 128)")
    ap.add_argument("--preempt", default="recompute",
                    choices=["recompute", "swap", "cost"],
                    help="pool-exhaustion strategy: re-queue and re-prefill, "
                         "swap the victim's KV to the host tier, or pick per "
                         "victim from a swap-versus-recompute cost model")
    ap.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="paged KV pool storage: int8 blocks with per-block "
                         "absmax scales (the kernels dequantize as they read); "
                         "default the model dtype")
    ap.add_argument("--kernel", default=None, choices=["pallas", "reference"],
                    help="paged attention: the hand-written kernels (pallas, the "
                         "default), or the gather oracles (reference, the default "
                         "and the only choice with --tp)")
    ap.add_argument("--no-interleave", action="store_true",
                    help="the sequential oracle loop: blocking chunked prefill at "
                         "admission, then batched decode")
    ap.add_argument("--sanitize", action="store_true",
                    help="shadow every KV block lifecycle transition (kvsan); "
                         "a violation raises")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replica engines with independent "
                         "admission over block ranges of one shared pool, on "
                         "the one device (the host tier is shared); with --tp, "
                         "the rows of a (dp, tp) mesh of spawned ranks")
    ap.add_argument("--audit", action="store_true",
                    help="run the step-program contract audit (collectives, "
                         "host syncs, int8 flow, cache sentinel) at startup, "
                         "replica 0 under --dp, and exit on any violation")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: N spawned ranks over gloo, each "
                         "holding its shard of the weights and of every pool "
                         "block's KV heads (cuda: rank r on cuda:r)")
    args = ap.parse_args(argv)
    if args.tp > 1:
        if args.kernel == "pallas":
            raise SystemExit("--kernel pallas is single-device: drop --tp/--dp")
        if args.kv_dtype:
            raise SystemExit("--kv-dtype int8 is single-device: drop --tp/--dp")
        if args.dp > 1:
            serve_tp_dp(args.arch, args.tp, args.dp, n_requests=args.n_requests,
                        max_new=args.max_new, pipeline=not args.no_pipeline, smoke=args.smoke,
                        device=args.device, seed=args.seed, host_blocks=args.host_blocks)
            return
        serve_tp(args.arch, args.tp, n_requests=args.n_requests, max_new=args.max_new,
                 pipeline=not args.no_pipeline, smoke=args.smoke, device=args.device,
                 seed=args.seed)
        return
    if args.app is not None:
        serve_sim(args.app, args.rate, args.duration, args.engine, args.slo, seed=args.seed)
        return
    if args.pipelines:
        serve_pipelines(args.arch, args.rate, args.duration, arrival=args.arrival,
                        session_fraction=args.sessions,
                        host_blocks=args.host_blocks or 128,
                        seed=args.seed, wall_clock=args.wall_clock, smoke=args.smoke,
                        device=args.device)
        return
    serve_real(args.arch, n_requests=args.n_requests, max_new=args.max_new,
               pipeline=not args.no_pipeline, smoke=args.smoke,
               device=args.device, seed=args.seed, preempt=args.preempt,
               host_blocks=args.host_blocks, kv_dtype=args.kv_dtype,
               kernel=args.kernel or "pallas", interleave=not args.no_interleave,
               sanitize=args.sanitize, dp=args.dp, audit=args.audit)


if __name__ == "__main__":
    main()
