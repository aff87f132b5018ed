"""Find an open-loop cell's limits and knee on the card.

    python3 ragbench/sweep.py --workload <open cell> --seed <n> [--unloaded-clients 2
        --unloaded-seconds 40] [--rates 2.5,3,3.5,4,4.5,5 --seconds 30 --seeds 1,2]

1. Sets the cell up once (as ``run.py`` does) and serves the mix nearly
   unloaded (``--unloaded-clients`` closed-loop clients); prints the
   medians of time to first token and of the gap between tokens, from which
   the mix's limits are derived: TTFT limit = ``--ttft-mult`` x the median
   TTFT; the interactive class's deadline = ``--deadline-mult`` x the
   unloaded time of the longest answer (median TTFT + the mix's most answer
   tokens x the median gap), the relaxed class's three times that.
   ``--unloaded-seconds 0`` skips this phase.
2. For each of ``--rates`` and each of ``--seeds`` (default: ``--seed``),
   one whole run of the cell as ``run.py`` makes it (weights, index and
   engine anew, the mix's warm-up from an empty cache, then ``--seconds``
   of window) with the mix's own limits: prints the
   run's metrics, its goodput over the offered rate (the share of requests
   that met both limits) and the waiting queue at the window's start and
   end. The knee is the highest rate at which at least 90 % met both and
   the queue did not grow.

One JSON line per phase goes to standard output.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the package by its name, not this folder's modules as top-level ones
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "ragbench"]


def emit(cell: str, rec: dict) -> None:
    print(json.dumps(dict(rec, cell=cell)), flush=True)


def unloaded(args, cell) -> None:
    import numpy as np
    import torch

    from ragbench import bench, corpus, stats, weights
    from ragbench.workload import Traffic
    from repro_torch.serving.engine import GenerationEngine

    m, tspec = cell.model, cell.traffic
    traffic = Traffic(dict(tspec, warmup_s=0.0, trace_s=0.0), args.seed,
                      args.unloaded_seconds + 60, m["vocab_size"])
    params = weights.draw(m, args.seed, "cuda")
    corp = tspec["corpus"]
    emb = corpus.passage_embeddings(args.seed, int(corp["passages"]),
                                    int(corp["embedding_dim"]), "cuda")
    queries = corpus.query_embeddings(emb, [p.docs for p in traffic.plans], args.seed,
                                      float(corp["query_noise"]))
    index = bench.make_index(emb)
    del emb
    torch.cuda.empty_cache()
    cfg = bench.port_config(m)
    eng_kw = {k: m["engine"][k] for k in ("max_batch", "max_seq", "block_size",
                                          "prefill_chunk_size", "token_budget")}
    n_blocks = bench.pool_blocks(eng_kw, cfg, params, "cuda", float(m["engine"]["reserve_gib"]))
    eng = GenerationEngine(cfg, params=params, device="cuda", n_blocks=n_blocks,
                           scheduler="edf_slack", prefix_sharing=True, kernel="pallas",
                           ragged=True, **eng_kw)
    emit(cell.name, {"phase": "setup", "seconds": time.perf_counter() - START,
                     "n_blocks": n_blocks, "card": bench.card()})

    # a few closed-loop clients keep the engine nearly unloaded
    t = copy.copy(traffic)
    t.spec = dict(tspec, loop="closed", clients=args.unloaded_clients)
    t.loop = "closed"
    c = bench.Client(eng, index, queries, t, "cuda", time_retrieval=False)
    c.t0 = time.perf_counter()
    a = c.t0 + 5.0
    c.run(a + args.unloaded_seconds)
    c.free_clients = -10**9  # no more sends: serve what is left
    while c._busy():
        c.run(time.perf_counter() + 0.5)
    done = [s for s in c.sent if s.finished_at is not None and s.due >= a]
    ttft = float(np.median([s.first - s.due for s in done]))
    tpot = float(np.median(stats.tpot_samples(done, 0, float("inf"))))
    deadline_ms = args.deadline_mult * (ttft + int(tspec["answer_tokens"][1]) * tpot) * 1e3
    emit(cell.name, {
        "phase": "unloaded", "requests": len(done), "ttft_median_ms": 1e3 * ttft,
        "tpot_median_ms": 1e3 * tpot, "ttft_ms": [1e3 * (s.first - s.due) for s in done],
        "ttft_limit_ms": args.ttft_mult * ttft * 1e3, "interactive_deadline_ms": deadline_ms,
        "relaxed_deadline_ms": 3 * deadline_ms})
    for s in c.sent:
        s.req = None
    del c, eng, index
    gc.collect()
    torch.cuda.empty_cache()


def rates(args, cell) -> None:
    from ragbench.bench import run_cell

    base = dict(cell.traffic)
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [args.seed]
    for rate, seed in ((float(r), s) for r in args.rates.split(",") for s in seeds):
        cell.traffic = dict(base, rate_rps=rate)
        keep = {}
        res = run_cell(cell, seed, args.seconds, False, device="cuda", keep=keep)
        m = {k: v["value"] for k, v in res["metrics"].items()}
        emit(cell.name, {"phase": "rate", "rate_rps": rate, "seed": seed,
                         "attempted": res["attempted"],
                         "metrics": m, "met_share": m["goodput_rps"] / rate,
                         "waiting": keep["waiting"], "correct": res["correct"],
                         "check": res["check"]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--unloaded-clients", type=int, default=2)
    ap.add_argument("--unloaded-seconds", type=float, default=40.0)
    ap.add_argument("--ttft-mult", type=float, default=5.0)
    ap.add_argument("--deadline-mult", type=float, default=2.0)
    args = ap.parse_args()

    from ragbench import spec

    cell = spec.cell(args.workload)
    if args.unloaded_seconds > 0:
        unloaded(args, cell)
    if args.rates:
        rates(args, cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
