"""Serving launcher of the port: serve a model with batched requests on one
device through the paged generation engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --smoke --device cpu

Weights are random, drawn by ``init_params`` from ``--seed``. Runs on
``cuda`` unless ``--device cpu`` is given (and raises without a GPU).
"""
from __future__ import annotations

import argparse

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
    args = ap.parse_args(argv)
    serve_real(args.arch, n_requests=args.n_requests, max_new=args.max_new,
               pipeline=not args.no_pipeline, smoke=args.smoke,
               device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
