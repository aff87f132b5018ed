#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` and print the build seconds.
2. Kernels against their plain PyTorch versions on the card, at qwen2.5-3b
   shapes (H=16, KVH=2, hd=128, bs=16, B=8, ~300 packed tokens, contexts up
   to 2048, RAW -1 holes, pad tokens, segmented spans) for float32,
   bfloat16 and int8 pools (bf16 also against the plain version on the
   same values in float32, int8 also with bf16 q; tolerances in ``TOL``);
   then times (CUDA events, L2 flushed between
   launches, median of 30) of the kernel, its plain version and one PyTorch
   SDPA call on the gathered view, beside the bound the card could reach.
3. Engine parity at smoke width: the same greedy RAG workload on the CPU
   (plain versions) and on the GPU (kernels) gives identical tokens.
4. Serve qwen2.5-3b at full width in bfloat16: 10 requests, 128-1536-token
   prompts, half sharing a 512-token document prefix, one segmented prompt,
   32 new tokens each, with both kernels' launch counts read around the run.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero without a GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12                    # H100 SXM HBM3
PEAK_OPS_S = {"float32": 67e12,          # CUDA cores, no tensor cores
              "bfloat16": 989e12,        # dense tensor-core rate
              "int8": 1979e12}
# (atol, rtol) of each check, by the pools' dtype: the kernel against
# "plain", its plain version on the same inputs, and for bf16 also against
# "plain_f32", the plain version on the same values in float32 (f32
# probabilities, as the kernel keeps), and for int8 also with bf16 q
TOL = {
    "float32": {"plain": (1e-4, 1e-4)},        # summation order differs
    "bfloat16": {
        "plain": (2e-2, 2e-2),                 # the plain version's bf16 probabilities
        "plain_f32": (1e-3, 8e-3),             # bf16 output rounding only (2**-9 rel.)
    },
    "int8": {
        "plain": (1e-4, 1e-4),                 # f32 q, dequantised pools
        "plain_bf16_q": (1e-3, 8e-3),          # bf16 q: bf16 output rounding only
    },
}
REPLACES = {
    "paged_chunk_attention": "src/repro/kernels/decode_attention.py:357",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:191",
}
SOURCE = "src/repro_torch/csrc/paged_attention.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

H, KVH, HD, BS, B = 16, 2, 128, 16, 8
N_BLOCKS = B * (2048 // BS + 1) + 1          # the engine's pool at max_seq 2048
MB_DECODE = 2048 // BS                       # engine.max_blocks
MB_CHUNK = MB_DECODE + 256 // BS             # engine._view_blocks
LENGTHS = [2048, 1536, 1024, 777, 512, 300, 129, 33]
# prefill chunks (row: (n tokens, p_end, s_start)); other rows decode one token
CHUNKS = {2: (64, 0, 0), 4: (96, 128, 400), 5: (100, 0, 0), 7: (33, 0, 0)}
N_PAD = 3


def make_case(dtype_name, gen):
    """Tables, pools and packed arrays at the engine's qwen2.5-3b shapes."""
    perm = torch.randperm(N_BLOCKS - 1, generator=gen) + 1   # block 0: scratch
    tables = np.full((B, MB_CHUNK), -1, np.int32)
    cur = 0
    for b, ln in enumerate(LENGTHS):
        need = -(-ln // BS)
        tables[b, :need] = perm[cur:cur + need].numpy()
        cur += need
    for b in (2, 5):                                     # interior RAW holes
        tables[b, 3] = -1
    row_of, slots, p_end, s_start = [], [], [], []
    for b, ln in enumerate(LENGTHS):
        c, pe, ss = CHUNKS.get(b, (1, 0, 0))
        for s in range(ln - c, ln):
            row_of.append(b)
            slots.append(s)
            p_end.append(pe)
            s_start.append(ss)
    row_of += [-1] * N_PAD
    slots += [0] * N_PAD
    p_end += [0] * N_PAD
    s_start += [0] * N_PAD
    T = len(row_of)
    shape = (N_BLOCKS, BS, KVH, HD)
    if dtype_name == "int8":
        k = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        ks = torch.rand((N_BLOCKS, KVH), generator=gen) * 0.02 + 1e-3
        vs = torch.rand((N_BLOCKS, KVH), generator=gen) * 0.02 + 1e-3
        q_dtype = torch.float32
    else:
        dt = getattr(torch, dtype_name)
        k = torch.randn(shape, generator=gen).to(dt)
        v = torch.randn(shape, generator=gen).to(dt)
        ks = vs = None
        q_dtype = dt
    q_dec = torch.randn((B, H, HD), generator=gen).to(q_dtype)
    q_chunk = torch.randn((T, H, HD), generator=gen).to(q_dtype)
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32)
    return {
        "q_dec": q_dec, "q_chunk": q_chunk, "k": k, "v": v, "ks": ks, "vs": vs,
        "tables_chunk": torch.from_numpy(tables),
        "tables_dec": torch.from_numpy(np.ascontiguousarray(tables[:, :MB_DECODE])),
        "lengths": i32(LENGTHS), "row_of": i32(row_of), "slots": i32(slots),
        "p_end": i32(p_end), "s_start": i32(s_start),
    }


def work(case, kernel):
    """(bytes the function must move, operations it must do) for this data:
    each K/V block the masks reach read once (all KV heads), q and the
    index arrays read once, the output written once; 4*hd flops per query
    head per valid slot (QK and PV)."""
    host = lambda name: case[name].cpu().numpy()
    tables = host("tables_chunk")
    kv_item = case["k"].element_size()
    if kernel == "paged_decode_attention":
        rows = [(b, 0, 0, ln - 1) for b, ln in enumerate(LENGTHS)]
        q = case["q_dec"]
        index_bytes = case["tables_dec"].numel() * 4 + B * 4
    else:
        rows = [(int(r), int(pe), int(ss), int(s)) for r, pe, ss, s in zip(
            host("row_of"), host("p_end"), host("s_start"), host("slots")) if r >= 0]
        q = case["q_chunk"]
        index_bytes = tables.size * 4 + 4 * 4 * q.shape[0]
    blocks, n_valid = set(), 0
    for b, pe, ss, slot in rows:
        s = np.arange(max(slot, pe - 1) + 1)
        backed = tables[b, s // BS] >= 0
        valid = backed & ((s < pe) | ((s >= ss) & (s <= slot)))
        n_valid += int(valid.sum())
        blocks.update(int(x) for x in np.unique(tables[b, s[valid] // BS]))
    block_bytes = 2 * len(blocks) * BS * KVH * HD * kv_item
    if case["ks"] is not None:
        block_bytes += 2 * len(blocks) * KVH * 4
    nbytes = block_bytes + 2 * q.numel() * q.element_size() + index_bytes
    ops = 4 * HD * H * n_valid
    return nbytes, ops


def check_close(name, got, want, valid, tol):
    atol, rtol = tol
    got, want = got.float()[valid], want.float()[valid]
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max abs err "
                             f"{float(err.max()):.3e} at atol {atol}, rtol {rtol}")
    return float(err.max())


def time_ms(fn, flush, reps=30, warmup=3):
    """Median device time of one call, each launch timed alone with CUDA
    events after a write of a buffer larger than the 50 MB L2 (the engine
    calls the kernels between weight-streaming matmuls, so K/V is cold)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def library_call(case, kernel):
    """One PyTorch SDPA call computing the same function on the gathered
    contiguous view with a boolean mask: a yardstick only, never used by
    the port."""
    import torch.nn.functional as F

    k, v = case["k"], case["v"]
    if k.dtype == torch.int8:
        return None
    if kernel == "paged_decode_attention":
        q = case["q_dec"]
        tab = case["tables_dec"].long()
        slot = torch.arange(MB_DECODE * BS, device=q.device)
        mask = (tab[:, slot // BS] >= 0) & (slot[None] < case["lengths"].long()[:, None])
    else:
        q = case["q_chunk"]
        rows = case["row_of"].long().clamp(min=0)
        tab = case["tables_chunk"].long()[rows]
        slot = torch.arange(MB_CHUNK * BS, device=q.device)
        pe, ss = case["p_end"].long()[:, None], case["s_start"].long()[:, None]
        mask = (tab[:, slot // BS] >= 0) & (
            (slot[None] < pe) | ((slot[None] >= ss) & (slot[None] <= case["slots"].long()[:, None])))
        mask[:, 0] |= case["row_of"] < 0        # pad tokens: keep one slot
    safe = tab.clamp(min=0)
    n = q.shape[0]
    kg = k[safe].reshape(n, -1, KVH, HD).transpose(1, 2).contiguous()
    vg = v[safe].reshape(n, -1, KVH, HD).transpose(1, 2).contiguous()
    qq = q[:, :, None, :]
    m = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kg, vg, attn_mask=m, enable_gqa=True)


def phase_kernels(ka):
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}
    calls = {
        "paged_decode_attention": (
            lambda c: ka.paged_decode_attention(
                c["q_dec"], c["k"], c["v"], c["tables_dec"], c["lengths"],
                k_scale=c["ks"], v_scale=c["vs"]),
            lambda c: ka.ref_paged_decode_attention(
                c["q_dec"], c["k"], c["v"], c["tables_dec"], c["lengths"],
                k_scale=c["ks"], v_scale=c["vs"])),
        "paged_chunk_attention": (
            lambda c: ka.paged_chunk_attention(
                c["q_chunk"], c["k"], c["v"], c["tables_chunk"], c["row_of"],
                c["slots"], c["p_end"], c["s_start"], k_scale=c["ks"], v_scale=c["vs"]),
            lambda c: ka.ref_paged_chunk_attention(
                c["q_chunk"], c["k"], c["v"], c["tables_chunk"], c["row_of"],
                c["slots"], c["p_end"], c["s_start"], k_scale=c["ks"], v_scale=c["vs"])),
    }
    for dtype_name in ("float32", "bfloat16", "int8"):
        case = {k: (v.cuda() if v is not None else None)
                for k, v in make_case(dtype_name, gen).items()}
        # the extra inputs of the second check: the same values in f32
        # (bf16 pools), or q in bf16 (int8 pools)
        if dtype_name == "bfloat16":
            other = dict(case, **{k: case[k].float() for k in ("q_dec", "q_chunk", "k", "v")})
        elif dtype_name == "int8":
            other = dict(case, **{k: case[k].bfloat16() for k in ("q_dec", "q_chunk")})
        for name, (kern, plain) in calls.items():
            valid = (case["row_of"] >= 0 if name == "paged_chunk_attention"
                     else torch.ones(B, dtype=torch.bool, device="cuda"))
            got = kern(case)
            torch.cuda.synchronize()
            errs = {"plain": check_close(f"{name}[{dtype_name}]", got, plain(case), valid,
                                         TOL[dtype_name]["plain"])}
            if name == "paged_chunk_attention" and not bool((got[~valid] == 0).all()):
                raise AssertionError("paged_chunk_attention: pad tokens must be zeros")
            if dtype_name == "bfloat16":
                errs["plain_f32"] = check_close(f"{name}[bf16 vs f32]", got, plain(other),
                                                valid, TOL[dtype_name]["plain_f32"])
            elif dtype_name == "int8":
                errs["plain_bf16_q"] = check_close(
                    f"{name}[int8, bf16 q]", kern(other), plain(other), valid,
                    TOL[dtype_name]["plain_bf16_q"])
            nbytes, ops = work(case, name)
            bytes_ms = nbytes / HBM_BYTES_S * 1e3
            ops_ms = ops / PEAK_OPS_S[dtype_name] * 1e3
            lib = library_call(case, name)
            r = {
                "name": name, "dtype": dtype_name, "errs": errs,
                "ms": time_ms(lambda: kern(case), flush),
                "plain_ms": time_ms(lambda: plain(case), flush, reps=20),
                "library_ms": time_ms(lib, flush) if lib is not None else None,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "ops": ops,
            }
            checks = ", ".join(f"vs {k} {e:.3e} (atol, rtol {TOL[dtype_name][k]})"
                               for k, e in errs.items())
            print(f"[kernels] {name} {dtype_name}: max_abs_err {checks}; "
                  f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}: {nbytes} B, {ops} flop)", flush=True)
            rows[(name, dtype_name)] = r
        del case
        other = None
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: engine parity at smoke width, CPU against GPU
# ---------------------------------------------------------------------------


def rag_workload(rng, vocab, doc_len, tail_range, n_shared, n_fresh, fresh_range,
                 seg_lens):
    """Prompts: ``n_shared`` with one retrieved document as a shared prefix,
    ``n_fresh`` unrelated ones, and one SegmentedPrompt of two documents."""
    from repro_torch.serving.segments import assemble_prompt

    doc = rng.integers(0, vocab, doc_len)
    prompts = [np.concatenate([doc, rng.integers(0, vocab, int(rng.integers(*tail_range)))])
               for _ in range(n_shared)]
    prompts += [rng.integers(0, vocab, int(rng.integers(*fresh_range))) for _ in range(n_fresh)]
    sysp, d1, d2, q = (rng.integers(0, vocab, n) for n in seg_lens)
    prompts.append(assemble_prompt(q, [d1, d2], [0, 1], sysp))
    return prompts


def phase_parity():
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("smollm-135m"))
    prompts = rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                           3, 2, (10, 90), (16, 48, 32, 9))
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4, max_seq=256)
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        assert all(len(r.out_tokens) == 12 for r in reqs), dev
        out[dev] = ([r.out_tokens for r in reqs], eng.stats())
    if out["cpu"][0] != out["cuda"][0]:
        raise AssertionError(f"CPU and GPU greedy tokens differ:\n{out['cpu'][0]}\n{out['cuda'][0]}")
    assert out["cuda"][1]["kernel"] == "cuda" and out["cpu"][1]["kernel"] == "plain"
    assert out["cuda"][1]["prefix_hit_tokens"] > 0
    print(f"[parity] smoke width f32: {len(prompts)} requests, identical greedy "
          f"tokens on cpu (plain) and cuda (kernels); prefix-hit tokens "
          f"{out['cuda'][1]['prefix_hit_tokens']}", flush=True)


# ---------------------------------------------------------------------------
# phase 4: serve qwen2.5-3b at full width
# ---------------------------------------------------------------------------


def phase_serve(ka, cfg):
    """Serve the RAG workload on ``cfg`` (qwen2.5-3b, bf16, on the card)."""
    from repro_torch.models import init_params, prefill_packed
    from repro_torch.serving.engine import GenerationEngine

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8,
                           max_seq=2048, block_size=16, prefill_chunk_size=256)
    n_var = eng.warmup_step_variants()
    print(f"[serve] {cfg.name} {cfg.dtype}: params + pools + warmup of {n_var} "
          f"packed lengths in {time.perf_counter() - t0:.1f}s", flush=True)
    prompts = rag_workload(np.random.default_rng(0), cfg.vocab_size, 512, (64, 1025),
                           5, 4, (128, 1537), (32, 256, 384, 40))
    lens = [len(p) for p in prompts]
    assert min(lens) >= 128 and max(lens) <= 1536, lens

    ka.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_chunk_attention": ka.paged_chunk_attention.launches,
                "paged_decode_attention": ka.paged_decode_attention.launches}

    st, lat = eng.stats(), eng.latency_summary()
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["kernel"] == "cuda", st["kernel"]
    assert all(n > 0 for n in launches.values()), launches
    n_mixed = launches["paged_chunk_attention"] // cfg.num_layers
    n_dec = launches["paged_decode_attention"] // cfg.num_layers
    assert n_mixed + n_dec == st["steps"], (launches, st["steps"])
    pool = eng.kv.pool
    assert pool.n_free == pool.n_blocks - 1, (pool.n_free, pool.n_blocks)
    assert st["prefix_hit_tokens"] > 0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve] {len(reqs)} requests (prompts {min(lens)}-{max(lens)} tokens), "
          f"{st['tokens_out']} tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} tok/s "
          f"(prefill tokens {st['prefill_tokens']}); mean TTFT "
          f"{1e3 * lat['ttft_mean']:.1f}ms, p95 TPOT {1e3 * lat.get('tpot_p95', 0):.2f}ms; "
          f"prefix-hit tokens {st['prefix_hit_tokens']}; host gap "
          f"{1e3 * st['host_gap_s']:.1f}ms over {st['dispatches']} dispatches; "
          f"{st['steps']} steps; peak memory {peak:.2f} GiB", flush=True)
    print(f"[serve] launches per step: {cfg.num_layers} (one per layer) of "
          f"paged_chunk_attention on mixed steps, of paged_decode_attention on "
          f"decode-only steps; this run: {launches}", flush=True)

    # where a step's time goes: 8 fresh 300-token requests (~9 mixed steps
    # of prefill), six mixed steps, then six decode-only steps
    rng = np.random.default_rng(1)
    extra = [eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new=40) for _ in range(8)]
    mixed = step_profile(eng, 3)
    while any(r.slot < 0 or r.prefilling for r in extra):
        eng.step()
    decode = step_profile(eng, 3)
    eng.run_until_done()
    for name, (kinds, host_ms, dev_ms, n_launch) in (("mixed", mixed), ("decode-only", decode)):
        assert set(kinds) == {"ragged" if name == "mixed" else "decode"}, kinds
        print(f"[serve] {name} step: wall {host_ms:.2f} ms (mean of 3, profiler off); "
              f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches "
              f"(torch.profiler, mean of 3)", flush=True)

    # the full-width stack gives finite logits of the expected shape
    n = 40
    toks = torch.as_tensor(prompts[0][:n], dtype=torch.int32, device="cuda")
    tables = torch.full((1, eng._view_blocks), -1, dtype=torch.int32, device="cuda")
    tables[0, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    ar = torch.arange(n, dtype=torch.int32, device="cuda")
    zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits = prefill_packed(cfg, eng.params, eng.kv.k, eng.kv.v, tables, toks,
                                zeros, ar, ar, zeros, zeros, block_size=16,
                                null_block=eng._null_block)
    assert tuple(logits.shape) == (n, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    return launches


def step_profile(eng, n):
    """Per engine step, over ``n`` steps each: the mean wall time (profiler
    off, pipelined steps back to back), then the device-busy time and the
    kernel launches (torch.profiler). Returns the plan kinds stepped too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kinds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
        kinds.append(eng.runner._last.plan.kind)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
            kinds.append(eng.runner._last.plan.kind)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    return kinds, wall_ms, dev_us / n / 1e3, launches / n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import decode_attention as ka
    from repro_torch.kernels._build import load_library

    card = card_line()
    print(f"[device] {card} | torch.cuda.get_device_name: {torch.cuda.get_device_name(0)} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib = load_library()
    regs = sorted({ln.strip() for ln in lib.ptxas.splitlines() if "registers" in ln})
    print(f"[build] {SOURCE} -> {lib.path.name} in {time.perf_counter() - t0:.2f}s; "
          f"ptxas: {regs}", flush=True)

    rows = phase_kernels(ka)
    phase_parity()
    from repro_torch.configs import get_arch

    launches = phase_serve(ka, get_arch("qwen2.5-3b").replace(dtype="bfloat16"))

    kernels = []
    for name in ("paged_chunk_attention", "paged_decode_attention"):
        r = rows[(name, "bfloat16")]     # the dtype the serve phase runs
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": r["errs"]["plain"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # every check of every dtype: {dtype: {check: max abs err}}
            "max_abs_err_by_check": {d: rows[(name, d)]["errs"]
                                     for d in ("float32", "bfloat16", "int8")},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
