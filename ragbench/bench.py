"""One run of one cell: set-up, the client loop over warm-up and the
measured window (and, with ``trace``, a profiled slice after it), then the
comparison with the plain reference that decides ``correct``.

Set-up draws the weights and the corpus on the device from the seed, builds
the port's ``VectorIndex``, sizes the paged pool to the memory left after
the weights, the index and one full step's activation peak, and serves the
mix's warm-up traffic, which brings the prefix cache and the queue to their
steady state. ``setup_s`` runs from process start to the window's start.
"""
from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ragbench import corpus, spec, stats, trace, weights
from ragbench.reference import decoder
from ragbench.workload import Traffic, stream

GIB = 2**30
SLOW_S = 0.25   # a loop iteration longer than this is logged
_CHECK = 9   # stream of the check's sample
GAP_Q = (50, 80, 85, 90, 93, 95, 97, 99)   # token-gap percentiles in the log


def log(*parts) -> None:
    print("[ragbench]", *parts, file=sys.stderr, flush=True)


def port_config(m: dict):
    """The port's ``ModelConfig`` for the configuration file ``m``."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=m["name"], family="dense", num_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        num_heads=m["num_attention_heads"], num_kv_heads=m["num_key_value_heads"],
        head_dim=m["head_dim"], qkv_bias=bool(m.get("qkv_bias", False)),
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m["tie_word_embeddings"]), dtype=m["torch_dtype"],
        source=m["source"])


def card() -> Dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()[0]
        name, limit = [x.strip() for x in out.split(",")[:2]]
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": torch.cuda.get_device_name(0), "power_limit": "unknown"}


def pool_blocks(eng_kw: dict, cfg, params, device, reserve_gib: float) -> int:
    """Blocks of the pool: the device memory left after the weights and the
    index, less one full step's activation peak (measured on a small probe
    engine that packs the whole token budget) times 1.25 and
    ``reserve_gib``, over a block's K and V bytes."""
    from repro_torch.serving.engine import GenerationEngine

    bs, chunk = eng_kw["block_size"], eng_kw["prefill_chunk_size"]
    budget = eng_kw["token_budget"]
    n_probe = -(-budget // chunk)
    probe = GenerationEngine(cfg, params=params, device=device, scheduler="fifo",
                             n_blocks=n_probe * (chunk // bs + 4) + 8, **eng_kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    for _ in range(n_probe):
        probe.submit(rng.integers(0, cfg.vocab_size, chunk + 8).astype(np.int32), max_new=2)
    probe.run_until_done()
    torch.cuda.synchronize()
    act = torch.cuda.max_memory_allocated() - base
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    block = 2 * cfg.num_layers * bs * cfg.num_kv_heads * cfg.head_dim * 2
    n = int((free - 1.25 * act - reserve_gib * GIB) // block)
    log(f"pool: activation peak {act / GIB:.2f} GiB, free {free / GIB:.2f} GiB, "
        f"block {block} B -> n_blocks {n}")
    return n


@dataclass
class Run:
    """What the metric readers read: the cell, the window's edges and
    counters, every request as the client saw it, the trace."""
    cell: spec.Cell
    model: dict
    traffic: Traffic
    sent: List[stats.Sent]
    a: stats.Window
    b: stats.Window
    setup_s: float
    retrieval_ms: List[float] = field(default_factory=list)
    trace: Optional[Dict] = None

    @property
    def loop(self) -> str:
        return self.traffic.loop

    @property
    def w0(self) -> float:
        return self.a.t

    @property
    def w1(self) -> float:
        return self.b.t


class Client:
    """The client loop: releases requests (on schedule, or, in the sweep's
    unloaded phase, as one of a few clients' last answer ends), retrieves
    their documents on the card, submits the segmented prompts, steps the
    engine and stamps every token it returns. The engine admits by
    EDF-slack; a request's priority is the ``SlackModel``'s slack, which
    the loop feeds each request's observed latency."""

    def __init__(self, eng, index, queries, traffic: Traffic, device, time_retrieval: bool):
        from repro_torch.core.slack import SlackModel

        self.eng, self.index, self.queries, self.traffic = eng, index, queries, traffic
        self.device = device
        self.slack = SlackModel()
        self.spans = trace.Spans()
        self.sent: List[stats.Sent] = []
        self.live: Dict[int, stats.Sent] = {}
        self.next_plan = 0
        self.free_clients = int(traffic.spec.get("clients", 0))
        self.freed_at: List[float] = []
        self.t0 = 0.0
        self.cuda = torch.device(device).type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.time_retrieval = time_retrieval and self.cuda
        self.events: List = []
        self.slow: List = []   # iterations of the loop over SLOW_S, for the log

    # ---------------------------------------------------------------- release
    def _due(self, now: float) -> List:
        plans = self.traffic.plans
        out = []
        if self.traffic.loop == "open":
            while self.next_plan < len(plans) and self.t0 + plans[self.next_plan].due <= now:
                p = plans[self.next_plan]
                out.append((p, self.t0 + p.due))
                self.next_plan += 1
        else:
            while self.free_clients > 0:
                p = plans[self.next_plan % len(plans)]
                self.next_plan += 1
                self.free_clients -= 1
                out.append((p, self.freed_at.pop(0) if self.freed_at else now))
        return out

    def _retrieve(self, batch) -> np.ndarray:
        rows = torch.as_tensor([p.index for p, _ in batch], device=self.queries.device)
        kmax = max(len(p.docs) for p, _ in batch)
        if not self.cuda:
            return self.index.search_exact(self.queries[rows], k=kmax)[1].numpy()
        with torch.cuda.stream(self.stream):
            if self.time_retrieval:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            ids = self.index.search_exact(self.queries[rows], k=kmax)[1]
            if self.time_retrieval:
                ev[1].record()
                self.events.append(ev)
            return ids.cpu().numpy()

    def _submit(self, now: float, batch, ids) -> None:
        from repro_torch.serving.segments import assemble_prompt

        tr = self.traffic
        for (p, due), row in zip(batch, ids):
            docs = np.asarray(row[: len(p.docs)], np.int64)
            doc_toks = [tr.doc_tokens(int(d)) for d in docs]
            s = stats.Sent(p, due, now, tr.deadline_s(p), (tr.prelude, doc_toks, p.query), docs)
            prompt = assemble_prompt(p.query, doc_toks, doc_ids=docs, system_tokens=tr.prelude)
            s.feats = {"tokens_in": len(prompt), "tokens_out": p.max_new,
                       "k_docs": len(docs), "docs_tokens": len(docs) * tr.doc_len}
            prio = self.slack.slack(now, due + s.deadline_s, ["generate"], s.feats)
            s.req = self.eng.submit(prompt, max_new=p.max_new, temperature=0.0, priority=prio)
            self.sent.append(s)
            self.live[s.req.req_id] = s

    # ------------------------------------------------------------------- step
    def _busy(self) -> bool:
        e = self.eng
        return bool(e.waiting or any(r is not None for r in e.slots) or e.pending)

    def _land(self, emitted, now: float) -> None:
        for rid, toks in emitted.items():
            s = self.live.get(rid)
            if s is None:
                continue
            s.token_times.extend([now] * len(toks))
            if len(s.token_times) >= s.plan.max_new:
                self._done(s, now)
        for s in [s for s in self.live.values() if s.req.done and not s.token_times]:
            s.failed = True
            self._done(s, now)

    def _done(self, s: stats.Sent, now: float) -> None:
        del self.live[s.req.req_id]
        if not s.failed:
            self.slack.observe("generate", s.feats, now - s.released)
        if self.traffic.loop == "closed":
            self.free_clients += 1
            self.freed_at.append(now)

    def run(self, until: float) -> None:
        """Serve until ``until`` on the benchmark's clock."""
        while True:
            now = time.perf_counter()
            if now >= until:
                return
            t1 = t2 = now
            batch = self._due(now)
            if batch:
                with self.spans("retrieve"):
                    ids = self._retrieve(batch)
                t1 = time.perf_counter()
                with self.spans("submit"):
                    self._submit(t1, batch, ids)
                t2 = time.perf_counter()
            if self._busy():
                with self.spans("step"):
                    emitted = self.eng.step()
                t3 = time.perf_counter()
                self._land(emitted, t3)
                if t3 - now > SLOW_S:
                    self.slow.append((round(t3 - now, 3), round(t1 - now, 3), round(t2 - t1, 3),
                                      round(t3 - t2, 3), len(batch), len(self.eng.waiting)))
            elif self.traffic.loop == "open" and self.next_plan < len(self.traffic.plans):
                nxt = self.t0 + self.traffic.plans[self.next_plan].due
                time.sleep(max(0.0, min(nxt, until) - time.perf_counter()))

    def window(self) -> stats.Window:
        e = self.eng
        live = [s for s in self.sent if s.req is not None]
        return stats.Window(time.perf_counter(), e.steps, e.prefill_tokens, e.tokens_out,
                            {id(s): s.req.prefill_pos for s in live},
                            {id(s): (s.req.prefill_cap, s.req.shared_prefix_tokens)
                             for s in live if s.req.prefill_cap > 0}, len(e.waiting))

    def retrieval_ms(self) -> List[float]:
        if self.events:
            torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _sample(sent: List[stats.Sent], a: float, b: float, seed: int, check: dict) -> List[stats.Sent]:
    """The finished requests the reference runs over: the one with the most
    prompt and answer tokens, then others drawn from the seed, until
    ``min_tokens`` answer tokens or ``max_requests`` requests."""
    done = [s for s in sent if s.finished_at is not None and a <= s.finished_at < b]
    if not done:
        done = [s for s in sent if s.finished_at is not None]
    if not done:
        return []
    longest = max(done, key=lambda s: s.req.prefill_cap + s.plan.max_new)
    rest = [s for s in done if s is not longest]
    order = stream(seed, _CHECK).permutation(len(rest))
    out, tokens = [longest], longest.plan.max_new
    for i in order:
        if tokens >= int(check["min_tokens"]) or len(out) >= int(check["max_requests"]):
            break
        out.append(rest[i])
        tokens += rest[i].plan.max_new
    return out


def _reference_topk(seed: int, corp: dict, queries: torch.Tensor, k: int, device) -> torch.Tensor:
    """The plain exact top-k ids (float32, TF32 off) of ``queries`` over the
    corpus drawn again from the seed, in blocks of passages."""
    emb = corpus.passage_embeddings(seed, int(corp["passages"]), int(corp["embedding_dim"]), device)
    best_s = best_i = None
    with decoder.full_float32():
        for lo in range(0, emb.shape[0], 1 << 18):
            s = queries @ emb[lo: lo + (1 << 18)].T
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            i = i + lo
            if best_s is not None:
                v, j = torch.topk(torch.cat([best_s, v], 1), k, dim=1)
                i = torch.gather(torch.cat([best_i, i], 1), 1, j)
            best_s, best_i = v, i
    return best_i


def make_index(emb: torch.Tensor):
    """The port's ``VectorIndex`` over the unit rows ``emb``, without an IVF
    step: the window searches it exactly (``search_exact`` reads the
    embeddings alone), so it holds one cluster of every passage and no
    k-means runs (one cluster's k-means would add every row into one
    centroid by atomics)."""
    from repro_torch.serving.retrieval import VectorIndex

    n = emb.shape[0]
    every = torch.arange(n, device=emb.device)
    return VectorIndex(emb, emb[:1].clone(), torch.zeros_like(every), every[None], n)


def traced_slice(client: Client, seconds: float, cuda: bool) -> Optional[Dict]:
    """Serve ``seconds`` more under ``torch.profiler`` (the device's
    operations only) and reduce the trace (``trace.reduce``), with the
    slice's mean step time; None without a card."""
    if not cuda:
        return None
    from torch.profiler import ProfilerActivity, profile

    eng = client.eng
    torch.cuda.synchronize()
    client.spans.on = True
    steps0 = eng.steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        host0 = time.perf_counter()
        torch.cuda._sleep(1000)   # the marker that aligns the two clocks
        client.run(host0 + seconds)
        torch.cuda.synchronize()
        host1 = time.perf_counter()
    client.spans.on = False
    steps = eng.steps - steps0
    t = time.perf_counter()
    reduced = trace.reduce(trace.device_events(prof), client.spans.items, host0, host1)
    log(f"trace reduced in {time.perf_counter() - t:.1f}s")
    if reduced is not None:
        reduced["slice_steps"] = steps
        reduced["slice_step_ms"] = 1e3 * (host1 - host0) / steps if steps else None
    return reduced


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, *,
             device="cuda", process_start: Optional[float] = None,
             keep: Optional[Dict] = None) -> Dict:
    """Run ``cell`` once and return the result line's object (``check``
    last). ``keep``, a dict, receives the weights and the served sample the
    reference read (for the control's readings)."""
    from repro_torch.serving.engine import GenerationEngine

    process_start = process_start if process_start is not None else time.perf_counter()
    m, tspec = cell.model, cell.traffic
    cuda = torch.device(device).type == "cuda"
    info = card() if cuda else {"name": "cpu", "power_limit": "none"}
    if cuda:
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.kernels._build import load_library

        with ThreadPoolExecutor(2) as pool:
            libs = list(pool.map(load_library, ("paged_attention", "topk_retrieval")))
        log("kernels:", ", ".join(f"{l.path.name} {l.build_s:.1f}s" for l in libs))
    cfg = port_config(m)
    traffic = Traffic(tspec, seed, seconds, m["vocab_size"])
    params = weights.draw(m, seed, device)
    corp = tspec["corpus"]
    emb = corpus.passage_embeddings(seed, int(corp["passages"]), int(corp["embedding_dim"]), device)
    queries = corpus.query_embeddings(emb, [p.docs for p in traffic.plans], seed,
                                      float(corp["query_noise"]))
    index = make_index(emb)
    del emb
    eng_kw = {k: m["engine"][k] for k in ("max_batch", "max_seq", "block_size",
                                          "prefill_chunk_size", "token_budget")}
    if cuda:
        torch.cuda.empty_cache()
        n_blocks = pool_blocks(eng_kw, cfg, params, device, float(m["engine"]["reserve_gib"]))
    else:
        n_blocks = int(m["engine"].get("n_blocks", 0)) or None
    eng = GenerationEngine(cfg, params=params, device=device, n_blocks=n_blocks,
                           scheduler="edf_slack", prefix_sharing=True, kernel="pallas",
                           ragged=True, **eng_kw)
    client = Client(eng, index, queries, traffic, device, time_retrieval=trace_on)
    if cuda:
        torch.cuda.synchronize()
    log(f"{cell.name} on {info['name']} at a {info['power_limit']} power limit (the peaks of "
        f"mfu are the 700 W datasheet's): {len(traffic.plans)} planned requests, pool "
        f"{eng.kv.pool.n_blocks} blocks, set-up before traffic "
        f"{time.perf_counter() - process_start:.1f}s")

    client.t0 = time.perf_counter()
    client.run(client.t0 + float(tspec["warmup_s"]))
    a = client.window()
    first_call = len(client.events)
    client.run(a.t + float(seconds))
    b = client.window()
    calls = slice(first_call, len(client.events))  # the retrieval calls of the window
    reduced = None
    if trace_on:
        reduced = traced_slice(client, float(tspec.get("trace_s", 2.0)), cuda)
        if reduced is not None:
            reduced["window_step_ms"] = 1e3 * (b.t - a.t) / max(b.steps - a.steps, 1)
            log(f"step ms: {reduced['slice_step_ms']} in the traced slice, "
                f"{reduced['window_step_ms']} in the window; marker {reduced['marker']!r}")
    retrieval_ms = client.retrieval_ms()[calls]
    if client.slow:
        log(f"{len(client.slow)} loop iterations over {SLOW_S}s (total, retrieve, submit, "
            f"step, released, waiting), slowest: {sorted(client.slow)[-5:]}")
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(cell, m, traffic, client.sent, a, b, a.t - process_start, retrieval_ms, reduced)

    metrics = {}
    for mt in (cell.per_layer if trace_on else cell.end_to_end):
        v = spec.reader(mt["name"])(run)
        if v is not None:
            metrics[mt["name"]] = {"value": float(v), "unit": mt["unit"]}
    attempted = [s for s in client.sent if a.t <= s.due < b.t]
    gaps = 1e3 * np.asarray(stats.tpot_samples(client.sent, a.t, b.t))
    if gaps.size:
        log(f"window: {len(attempted)} requests due, {b.steps - a.steps} steps "
            f"({stats.step_ms(run):.2f} ms a step), {gaps.size} token gaps, ms at p"
            f"{'/'.join(map(str, GAP_Q))}: {np.round(np.percentile(gaps, GAP_Q), 2).tolist()}")

    # -- the comparison that decides ``correct``, after the program is freed
    sample = _sample(client.sent, a.t, b.t, seed, tspec["check"])
    served = [decoder.Served(s.segments[0], list(s.segments[1]), s.segments[2],
                             np.asarray(s.req.out_tokens, np.int64)) for s in sample]
    in_window = [s for s in client.sent if a.t <= s.released < b.t]
    got_ids = [s.docs for s in in_window]
    q_rows = torch.as_tensor([s.plan.index for s in in_window], dtype=torch.long,
                             device=queries.device)
    for s in client.sent:
        s.req = None  # a Request's stream holds the engine, and the engine the pool
    del client, eng, index, run
    gc.collect()  # the engine's parts refer to each other: free the pool now
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    mismatches = 0
    if in_window:
        kmax = max(len(p) for p in got_ids)
        want = _reference_topk(seed, corp, queries[q_rows], kmax, device).cpu().numpy()
        mismatches = sum(set(g.tolist()) != set(w[: len(g)].tolist())
                         for g, w in zip(got_ids, want))
    if keep is not None:
        keep.update(params=params, served=served, waiting=(a.waiting, b.waiting))
    ref = decoder.logits(m, params, served, device)
    gap = decoder.widest_gap(ref, [s.answer for s in served]) if served else math.inf
    limit = float(m["correct"]["logit_gap"])
    n_tok = sum(len(s.answer) for s in served)
    log(f"check: {len(served)} requests, {n_tok} served tokens (prompts "
        f"{[s.prompt_len for s in served]}), {len(got_ids)} retrievals, "
        f"{time.perf_counter() - t:.1f}s")
    check = {"logit_gap": {"value": gap, "limit": limit},
             "retrieval_mismatches": {"value": mismatches, "limit": 0}}
    correct = bool(served) and gap <= limit and mismatches == 0
    dev = {"platform": "gpu" if cuda else "cpu", "kind": info["name"],
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace_on and reduced is not None:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    out = {"correct": correct, "attempted": len(attempted),
           "failed": sum(s.failed for s in attempted), "metrics": metrics, "device": dev}
    if trace_on and reduced is not None:
        out["breakdown"] = reduced["breakdown"]
        out["trace_cost"] = {"slice_step_ms": reduced["slice_step_ms"],
                             "window_step_ms": reduced["window_step_ms"]}
    out["check"] = check
    return out
