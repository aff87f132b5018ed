"""Startup profiling: estimate alpha_{i,k}, gamma_i, p_{i,j}.

The paper profiles by running ~100 sampled requests (ShareGPT) through the
pipeline on representative hardware. Here we execute the components' real
code paths (the paged engine: on the CPU in tests, on the GPU at full
width) or their calibrated cost models and fit the LP coefficients:

  alpha_{i,k} = requests/s one unit of resource k sustains for component i
  gamma_i     = mean(outputs per input) (amplification / abridgement)
  p_{i,j}     = empirical branch frequencies from traces
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.graph import WorkflowGraph
from repro_torch.core.spec import meta_of
from repro_torch.data.workload import sample_request_features


def profile_components(
    components: Dict[str, object],
    n_samples: int = 100,
    seed: int = 0,
    real_execution: bool = False,
) -> None:
    """Fill each component's meta.alpha from measured/estimated service time.

    alpha_{i,k}: for the dominant resource, 1 unit sustains 1/mean_service
    req/s; non-dominant resources contribute nothing by themselves (a
    retriever can't run on a GPU) — matching the paper's heterogeneous,
    multi-dimensional resource model.
    """
    rng = np.random.default_rng(seed)
    for name, comp in components.items():
        meta = meta_of(comp)
        times = []
        cold = hasattr(comp, "effective_hit_rate")  # Generators: fit at h=0
        ran_real = real_execution and hasattr(comp, "_profile_run")
        for _ in range(n_samples):
            feats = sample_request_features(rng)
            if ran_real:
                t0 = time.perf_counter()
                comp._profile_run(feats)
                times.append(time.perf_counter() - t0)
            elif cold:
                # cold-cache baseline: the LP discounts Generator alpha by the
                # *measured* hit rates at solve time (solve_allocation
                # alpha_scale), so the fit must not bake any tier's rate in
                # twice — HBM and host both evaluated cold
                times.append(comp.estimate_time(feats, hit_rate=0.0,
                                                host_hit_rate=0.0))
            else:
                times.append(comp.estimate_time(feats))
        mean_t = float(np.mean(times))
        dom = meta.dominant_resource()
        per_inst = meta.resources.get(dom, 1.0)
        # one instance (= per_inst units of dom) sustains 1/mean_t req/s
        meta.alpha = {dom: (1.0 / mean_t) / per_inst}
        meta.mean_service_s = mean_t
        # record the hit rate baked into this alpha so the controller's
        # alpha_scale feedback never double-applies the cache discount:
        # real-execution timings embed the engine's live rate; the estimate
        # branch was explicitly evaluated cold
        if not cold:
            meta.alpha_hit_rate = None
            meta.alpha_host_hit_rate = None
        elif ran_real:
            meta.alpha_hit_rate = float(comp.effective_hit_rate())
            meta.alpha_host_hit_rate = float(comp.effective_host_hit_rate())
        else:
            meta.alpha_hit_rate = 0.0
            meta.alpha_host_hit_rate = 0.0


def engine_kv_bytes_per_token(engine) -> Optional[float]:
    """HBM bytes one cached context token occupies in ``engine``'s KV pools.

    Read off the live pool arrays, so quantized storage is priced as
    deployed: ``2 * layers * kv_heads * head_dim * itemsize`` for the K+V
    payload, plus the amortized per-block scale-pool share
    (``2 * layers * kv_heads * 4 / block_size``) when the pools are int8.
    Returns None for dense-cache engines (no paged pools to measure)."""
    kv = getattr(engine, "kv", None)
    if kv is None or not hasattr(kv, "k"):
        return None
    G, _, block_size, kvh, hd = kv.k.shape
    per_tok = 2.0 * G * kvh * hd * kv.k.dtype.itemsize
    if getattr(kv, "quantized", False):
        per_tok += 2.0 * G * kvh * 4.0 / block_size
    return float(per_tok)


def calibrate_generator_from_engine(
    gen,
    engine,
    prefill_len: int = 64,
    decode_tokens: int = 24,
    long_ctx: int = 96,
    tp_engine=None,
) -> Dict[str, float]:
    """Refit a Generator's cost-model coefficients against a live engine
    (the paged serving engine, on the CPU or the GPU).

    Measures: prefill s/token from a long-prompt/1-token request, the flat
    decode s/token from a short-context decode run, the KV-read term from
    the long-vs-short context decode delta, the chunked-prefill TTFT slope
    from the long-prompt request's recorded first-token timestamp, and the
    prefix hit rate from the engine's shared-block counters. KV bytes per
    cached token are read off the live pools (``engine_kv_bytes_per_token``)
    so the LP's capacity multiplier tracks quantized storage.

    ``tp_engine``: an optional tensor-parallel engine for the SAME config;
    when given, the tp=1 workload is replayed on it and the wall-time ratio
    is inverted through ``fit_tp_comm_fraction`` into a measured
    ``tp_comm_fraction`` — replacing the default guess with an A/B
    measurement from this host. Returns the measured coefficients (also
    written onto ``gen``)."""

    salt = [0]
    last_req = [None]

    def timed(prompt_len: int, max_new: int, eng=None) -> float:
        # distinct prompt per measurement: an accidental prefix-cache hit
        # would fake a near-zero prefill cost
        eng = engine if eng is None else eng
        salt[0] += 1
        prompt = (np.arange(prompt_len) + salt[0] * 131) % 401
        req = eng.submit(prompt, max_new=max_new)
        t0 = time.perf_counter()
        eng.run_until_done()
        dt = time.perf_counter() - t0
        assert req.done
        last_req[0] = req
        return dt

    pc = getattr(engine, "prefill_chunk_size", 0)

    def eff(n: int) -> int:
        # the paged engine pads every prompt to whole prefill chunks; subtract
        # the chunk-quantized prefill cost or its residue leaks into the
        # decode coefficients
        return -(-n // pc) * pc if pc else n

    timed(prefill_len, 2)  # warm up (kernel builds, allocator) so set-up never enters the fit
    timed(8, decode_tokens)
    t_prefill = timed(prefill_len, 1)
    prefill_per_token = t_prefill / eff(prefill_len)
    # chunked-prefill TTFT slope: measured from the engine's own per-request
    # timestamps (submit -> first token) over the chunk-quantized prompt
    ttft_req = last_req[0]
    ttft = max(ttft_req.first_token_at - ttft_req.submitted_at, 1e-9)
    ttft_per_token = ttft / eff(prefill_len)

    t_short = timed(8, decode_tokens)
    t_long = timed(long_ctx, decode_tokens)
    decode_short = max(t_short - eff(8) * prefill_per_token, 1e-9) / decode_tokens
    decode_long = max(t_long - eff(long_ctx) * prefill_per_token, 1e-9) / decode_tokens
    ctx_coeff = max(decode_long - decode_short, 0.0) / max(long_ctx - 8, 1)

    # rolling measured rate from engine telemetry (per-request hit rates over
    # the finished window), not a static configured value; counter-ratio kept
    # as the fallback for engines without the telemetry
    if hasattr(engine, "measured_hit_rate"):
        hit_rate = float(engine.measured_hit_rate())
    else:
        stats = engine.stats()
        seen = stats.get("prefix_hit_tokens", 0) + stats.get("prefill_tokens", 0)
        hit_rate = stats.get("prefix_hit_tokens", 0) / seen if seen else 0.0

    coeffs = {
        "prefill_per_token_s": prefill_per_token,
        "ttft_per_prefill_token_s": ttft_per_token,
        "decode_per_token_s": decode_short,
        "decode_cache_per_ctx_token_s": ctx_coeff,
        "prefix_hit_rate": hit_rate,
    }

    kv_bytes = engine_kv_bytes_per_token(engine)
    if kv_bytes is not None:
        # baseline = what the same pools would cost stored at the model
        # dtype; the ratio is the LP's KV-capacity multiplier
        from repro_torch.params import torch_dtype

        cfg = engine.cfg
        fp_bytes = (2.0 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim
                    * torch_dtype(cfg).itemsize)
        coeffs["kv_bytes_per_token"] = kv_bytes
        coeffs["baseline_kv_bytes_per_token"] = float(fp_bytes)

    if tp_engine is not None:
        tp = (tp_engine.pool_layout.tp_degree
              if getattr(tp_engine, "pool_layout", None) is not None else 1)
        # same fresh-prompt workload on both engines; one warm-up run per
        # engine keeps compile time out of the ratio
        timed(prefill_len, 2, eng=tp_engine)
        t_base = timed(prefill_len, decode_tokens)
        t_tp = timed(prefill_len, decode_tokens, eng=tp_engine)
        coeffs["tp_comm_fraction"] = fit_tp_comm_fraction(
            tp, t_base / max(t_tp, 1e-9))

    gen.calibrate(coeffs)
    return coeffs


def generator_alpha_scale(
    gen,
    features: Optional[Dict[str, float]] = None,
    hit_rate: Optional[float] = None,
    baseline_hit_rate: float = 0.0,
    host_hit_rate: Optional[float] = None,
    baseline_host_hit_rate: float = 0.0,
) -> float:
    """Capacity multiplier the observed cache hit rates buy a Generator:
    alpha was fitted at ``baseline_hit_rate`` / ``baseline_host_hit_rate``
    (0/0 = cold cache, no host tier), so one resource unit now sustains
    ``t(baseline)/t(observed)`` times the fitted request rate. Both tiers
    discount independently — HBM hits skip prefill entirely, host-tier
    promotions pay only the block-copy rate (``Generator
    .host_promote_per_token_s``). Fed to ``solve_allocation(alpha_scale=...)``
    so the LP re-plans Generator capacity as cache effectiveness shifts."""
    feats = features or {
        "tokens_in": 128.0,
        "docs_tokens": 2000.0,
        "tokens_out": float(getattr(gen, "max_new", 64)),
    }
    h = gen.effective_hit_rate() if hit_rate is None else hit_rate
    hh = gen.effective_host_hit_rate() if host_hit_rate is None else host_hit_rate
    t_base = gen.estimate_time(feats, hit_rate=baseline_hit_rate,
                               host_hit_rate=baseline_host_hit_rate)
    t_now = gen.estimate_time(feats, hit_rate=h, host_hit_rate=hh)
    return max(t_base / max(t_now, 1e-12), 1e-6)


def fit_tp_comm_fraction(tp_degree: int, measured_speedup: float) -> float:
    """Invert the saturating TP model from one measured A/B point.

    ``Generator.tp_speedup`` assumes s(t) = t / (1 + f*(t-1)); given the
    measured per-replica speedup of a ``tp_degree``-sharded engine over the
    tp=1 oracle on the same workload (e.g. the wall-time ratio of two
    ``GenerationEngine.run_until_done`` runs), solve for the collective
    fraction f:

        f = (t / s - 1) / (t - 1)

    Clamped to [0, 1]: a super-linear measurement (cache effects) fits f=0, a
    slowdown fits f=1. Write the result to ``gen.tp_comm_fraction`` via
    ``Generator.calibrate`` so estimate_time/estimate_ttft and the LP's
    tp_degree discount track the measured mesh instead of the default."""
    t = max(int(tp_degree), 1)
    if t <= 1:
        return 0.0
    s = max(float(measured_speedup), 1e-9)
    return float(min(max((t / s - 1.0) / (t - 1), 0.0), 1.0))


def profile_routing(graph: WorkflowGraph, traces: List[List[str]]) -> None:
    """Update p_ij and recursion marks from execution traces."""
    graph.update_from_traces(traces)


def estimate_gamma(traces: List[List[str]]) -> Dict[str, float]:
    """gamma_i = mean number of invocations of each component per request
    (amplification > 1 for recursive stages)."""
    counts: Dict[str, List[int]] = {}
    for tr in traces:
        per: Dict[str, int] = {}
        for c in tr:
            per[c] = per.get(c, 0) + 1
        for c, n in per.items():
            counts.setdefault(c, []).append(n)
    n_req = max(len(traces), 1)
    return {c: sum(v) / n_req for c, v in counts.items()}
