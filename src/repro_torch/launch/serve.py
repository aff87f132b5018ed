"""Serving launcher of the port: serve a model with batched requests on one
device through the paged generation engine, or replay an open-loop trace of
mixed RAG pipelines on it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --pipelines --arch smollm-135m --smoke --device cpu

Weights are random, drawn by ``init_params`` from ``--seed``. Runs on
``cuda`` unless ``--device cpu`` is given (and raises without a GPU). The
reference's simulated-cluster mode (``serve_sim``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np


def serve_real(arch: str, n_requests: int = 8, max_new: int = 12,
               pipeline: bool = True, smoke: bool = False, device=None,
               seed: int = 0):
    """Serve ``n_requests`` random prompts (4-31 tokens) on ``arch`` (its
    smoke variant with ``smoke``) and print the per-request and summary
    lines of the JAX launcher. Returns the engine."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.serving.engine import GenerationEngine

    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    eng = GenerationEngine(cfg, max_batch=4, max_seq=256, pipeline=pipeline,
                           seed=seed, device=device)
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
    stats = eng.stats()
    mode = "pipelined" if pipeline else "sync"
    print(f"[serve:real] {cfg.name}: device={stats['device']} mode={mode} "
          f"kernel={stats['kernel']} kv={stats['kv_dtype']} "
          f"{stats['tokens_out']} tokens out")
    print(f"[serve:real] fused-step padding: "
          f"{100 * stats['padded_token_fraction']:.1f}% of slot tokens")
    print(f"[serve:real] host gap: {1e3 * stats['host_gap_s']:.1f}ms total "
          f"over {stats['dispatches']} dispatches "
          f"(copy ops drained: {stats['copy_ops_drained']})")
    return eng


def serve_pipelines(arch: str = "smollm-135m", rate: float = 10.0,
                    duration: float = 2.0, *, arrival: str = "poisson",
                    session_fraction: float = 0.3, host_blocks: int = 0,
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
    launcher's. The reference provisions a host block tier of 128 blocks;
    the port has none yet, so ``host_blocks`` defaults to 0 and a nonzero
    value raises ``NotImplementedError`` in the engine."""
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
    print(f"[serve:pipelines] session KV: {st['session_shared_tokens']} HBM-shared "
          f"tokens; prefix-hit tokens {st['prefix_hit_tokens']}; {st['steps']} steps, "
          f"{st['tokens_out']} tokens out in {wall:.2f}s wall "
          f"(device={st['device']}, kernel={st['kernel']})")
    return drv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b",
                    choices=["smollm-135m", "qwen2.5-3b", "phi3-medium-14b"])
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
                    help="--pipelines arrival rate (requests/s)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="--pipelines trace length (trace seconds)")
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
                    help="host block tier capacity; the tier is not ported "
                         "yet, so a nonzero value raises NotImplementedError")
    args = ap.parse_args(argv)
    if args.pipelines:
        serve_pipelines(args.arch, args.rate, args.duration, arrival=args.arrival,
                        session_fraction=args.sessions, host_blocks=args.host_blocks,
                        seed=args.seed, wall_clock=args.wall_clock, smoke=args.smoke,
                        device=args.device)
        return
    serve_real(args.arch, n_requests=args.n_requests, max_new=args.max_new,
               pipeline=not args.no_pipeline, smoke=args.smoke,
               device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
