#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started at once)
   and print each source's build seconds.
2. Paged attention kernels against their plain PyTorch versions on the card,
   at qwen2.5-3b shapes (H=16, KVH=2, hd=128, bs=16, B=8, ~300 packed
   tokens, contexts up to 2048, RAW -1 holes, pad tokens, segmented spans)
   for float32, bfloat16 and int8 pools (bf16 also against the plain version
   on the same values in float32, int8 also with bf16 q; tolerances in
   ``TOL``), and the split decode's edges (a row of length 1, -1 holes at
   the table entries that start splits); then times (CUDA events, L2 flushed between launches, median
   of 30) of the kernel, its plain version and one PyTorch SDPA call on the
   gathered view, beside the bound the card could reach, and the kernel's
   device time alone (calls queued behind a spin kernel, timed back to back
   with CUDA events; every timed kernel has one). The chunk kernel again,
   checked and timed the same way, at the engine's mixed step: one row
   prefills 256 plain-causal tokens at slots 1024-1279, seven rows decode one
   token each at lengths 301-337, one pad (264 packed tokens).
2b. The dense backend's kernels against their plain versions on the card at
   qwen2.5-3b shapes: flash attention (B=1, H=16, KVH=2, hd=128, S in {16,
   64, 65, 200, 1100, 2048}, causal and not; bf16 runs on the tensor cores)
   and dense decode attention (B=8, Sc=2048, the lengths of phase 2, again
   with the shortest row at length 1, and the mixed step's lengths 1280 and
   301-337), float32 and bfloat16 (bf16 also against the plain version in
   float32); then the times of the kernel, its plain version and one SDPA
   call (flash: S=2048 causal; decode: phase 2's and the mixed step's
   lengths) beside the bound.
3. The top-k retrieval kernel against its plain version at B=32 queries,
   N=2^21 docs, d=768, k in {10, 100}: float32 docs (the corpus the index is
   built from), bfloat16 docs, and integer-valued docs with duplicated rows
   (exact ties; tolerances in ``TOPK_TOL``); then the kernel's, the plain
   version's and ``torch.topk(q @ docs.T, k)``'s times (bf16 docs: on the
   f32 upcast) beside the bound of the kernel's route (the split-tf32
   products counted at the tf32 tensor-core rate).
4. Engine parity at smoke width: the same greedy RAG workload on the CPU
   (plain versions) and on the GPU (kernels) gives identical tokens; then
   the same seeded open-loop pipeline trace (vrag + crag, sessions) gives
   identical pipeline records and tokens on both. The dense backend gives
   identical greedy tokens on the CPU and on the GPU, and on the GPU the
   same tokens as the paged backend.
5. Serve qwen2.5-3b at full width in bfloat16: 10 requests, 128-1536-token
   prompts, half sharing a 512-token document prefix, one segmented prompt,
   32 new tokens each, with every ported kernel's launch count read around
   the run (the dense and top-k kernels' must be 0).
5b. Serve the same 10 prompts (the segmented one flattened) on the dense
   backend of qwen2.5-3b bf16 (``max_batch=8``, ``max_seq=2048``): flash
   attention launches must be 36 x the prefills and dense decode launches
   36 x the decode steps, and the paged and top-k kernels' 0; greedy
   agreement with phase 5's paged run on the unsegmented requests is
   reported (bf16 sums differ in order between the two backends, so it is
   not required).
6. RAG requests at full width: a ``VectorIndex`` of 2^21 synthetic 768-d
   passages with 1024 clusters built on the card; recall@10 at n_probe 1,
   8 and 32 (the exact side runs the top-k kernel); 8 queries through
   Retriever -> Reranker -> Augmenter -> the qwen2.5-3b engine, half of
   them repeating an earlier query's text, with every ported kernel's
   launch count read around the phase (the dense kernels' must be 0).
5c. Serve phase 5's ten prompts with phase 5's settings on int8 pools
   (``kv_dtype="int8"``, bf16 weights): both paged kernels take their int8
   route from the engine's running-max scales (launches 36 a step, none of
   the dense, scan or top-k kernels); tokens/s, TTFT, TPOT, steps, peak
   memory, the pool's bytes against phase 5's bf16 pool, greedy agreement
   with phase 5's tokens (reported; the 0.75 floor holds at smoke width
   only), and a step profile of a mixed and a decode-only step.
5d. The host tier and swap at full width: phase 5's prompts in two waves
   (each prompt asked for again in the second) on a 256-block pool (phase
   5: 1033) with a 1024-block host tier, under ``preempt="recompute"``,
   ``"swap"`` and ``"cost"`` and once on int8 pools with swap: demotions,
   promotions and (swap) swap-outs > 0, every swap set restored, the pool
   clean, and swap's prefill tokens below recompute's; steps, tokens/s,
   prefill tokens, bytes swapped, and the device<->host rate of a swap
   chain's pinned copies (CUDA events).
4d. int8 pools and swap/cost preemption at smoke width in float32, CPU
   against the card: the RAG workload on an int8 pool, and the invariant
   harness's long-decode workload on a 6-block pool under swap (float and
   int8) and cost (the per-token step time pinned to 6e-7 s on both):
   identical greedy tokens and counters, int8 payloads within one code and
   scales within 1e-5 relative (the float K/V they quantize differ by the
   devices' summation orders); and the quantized scatter itself equal bit
   for bit on identical inputs, .5 ties included.
7. The open-loop pipelines at full width: ``serve_pipelines`` on
   qwen2.5-3b bfloat16 replays a Poisson trace (4 requests/s for 5
   trace-seconds, 30% sessions) of vrag/crag/srag/planrag with EDF-slack
   priorities and the reference launcher's 128-block host tier; every
   event must complete.
7b. The control plane on the card, on phase 5's qwen2.5-3b bf16 weights:
   ``calibrate_generator_from_engine(prefill_len=1024, decode_tokens=32,
   long_ctx=1536)`` against the paged engine (``max_batch=8``,
   ``max_seq=2048``, 16-token blocks, 256-token chunks) on bf16 and on
   int8 pools, each coefficient printed beside the Generator class default,
   ``kv_bytes_per_token`` exactly 36864 and 18468 and ``kv_capacity_scale``
   1.99610 on int8 pools; ``profile_components(real_execution=True)`` of
   vrag's generator on the bf16 engine (8 draws) beside the calibrated cost
   model on the same draws; both paged kernels launch in the phase and no
   other kernel does. Then, host work only, for vrag/crag/srag/arag with
   32 GPUs, 256 CPUs and 1024 GB: the LP plan under the default and the
   card's coefficients (status ``optimal``), the SLO as benchmarks/common.py
   sets it (2x the mean latency at 0.1x the card plan's throughput), and
   the Patchwork, monolithic and Ray-like runtimes at 0.8x that throughput
   for 30 trace-seconds, each run until it completes all it was offered.
2c. The RWKV-6 WKV kernel against its plain version on the card at
   rwkv6-7b shapes (H=64, hd=64) with a nonzero ``state0``: prefill B=1 at
   S=2048 and S=37, decode B=8 at S=1, the adversarial decay w=0.45 and
   decays near 0 (w=1e-6), and B=1 at the lengths about the kernel's
   segment edges (S in {1, 33, 255, 257, 1519}), r/k/v in float32 and
   bfloat16 (tolerance ``WKV_TOL``), each with the (n_seg, seg_len) the
   kernel ran; then the kernel's and the plain version's times beside the
   bound (prefill S=2048 and decode). No single PyTorch call computes the
   recurrence, so there is no library time.
4b. The RWKV-6 engine at smoke width in float32: identical greedy tokens on
   the CPU (plain versions) and on the GPU (the kernel), with 2 WKV
   launches (one per layer) per prefill and per decode step.
8. Serve rwkv6-7b at full width in bfloat16 on ``GenerationEngine(backend=
   "paged")``, which falls back to the dense backend: ``max_batch=8``,
   ``max_seq=2048``, phase 5's ten prompts (the segmented one flattened,
   tokens taken modulo the 65536-token vocab), 32 new tokens each. The WKV
   launches must be 32 x (prefills + decode steps) and every other kernel's
   0 (the earlier phases must show 0 WKV launches). The qwen2.5-3b weights
   are freed first.
2d. The selective-scan kernel against its plain version on the card at
   hymba-1.5b shapes (Di=1600, N=16) with a nonzero ``h0``: prefill B=1 at
   S=1664 (128 meta + 1536 text tokens) and S=37, decode B=8 at S=1, and
   dt = softplus of extreme values (dt * A down to about -50) at S=1664,
   and B=1 at the lengths about the kernel's segment edges (S in {1, 17,
   129, 1647}), dt/x/B/C in float32 and bfloat16 (bf16 also against the
   plain version in float32; tolerance ``SSM_TOL``), each with the (n_seg,
   seg_len) the kernel ran; then the kernel's, its device and the
   plain version's times beside the bound (prefill S=1664 and decode). No
   single PyTorch call computes the scan, so there is no library time.
2e. The flash kernel with a sliding window at hymba-1.5b's heads (H=25,
   KVH=5, hd=64): S=1664 with window 1024 and S=300 with window 64, float32
   and bfloat16, against the plain version; then its times at S=1664 beside
   the bound and one SDPA call with the windowed causal mask.
2f. The dense decode kernel at the hymba serve phase's shapes (B=8, H=25
   over KVH=5, hd=64, a 1024-slot ring) with lengths that mix full rings
   with rows of 1, 37 and 300 slots, and with the mixed step's lengths on
   the ring, float32 and bfloat16 (bf16 also against the plain version in
   float32; tolerances of phase 2b); then its times beside the bound and
   one SDPA call with the length mask.
4c. The hymba engine at smoke width in float32: identical greedy tokens on
   the CPU (plain versions) and on the GPU (kernels), with 2 scan and 2
   flash launches per prefill and 2 scan and 2 dense decode launches per
   decode step.
9. Serve hymba-1.5b at full width in bfloat16 on ``GenerationEngine(
   backend="paged")``, which falls back to the dense backend: ``max_batch=8``,
   ``max_seq=2048``, phase 5's ten prompts (flattened, tokens modulo the
   32001-token vocab), 32 new tokens each. The scan launches must be 32 x
   (prefills + decode steps), flash 32 x the prefills, dense decode 32 x the
   decode steps, and the paged, top-k and WKV kernels' 0; every earlier phase
   must show 0 scan launches. The rwkv6-7b weights are freed first.

It prints a ``{"int8_serve": ..., "host_tier": ..., "controller": ...}``
line of phases 5c, 5d and 7b's figures, a ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without a GPU.
"""
from __future__ import annotations

import gc
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
              "tf32": 495e12,            # dense tensor-core rate
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
    "topk_retrieval": "src/repro/kernels/topk_retrieval.py:51",
    "flash_attention": "src/repro/kernels/flash_attention.py:69",
    "decode_attention": "src/repro/kernels/decode_attention.py:90",
    "rwkv6_chunked": "src/repro/kernels/rwkv6_scan.py:76",
    "ssm_scan": "src/repro/kernels/ssm_scan.py:55",
}
SOURCES = {
    "paged_chunk_attention": "src/repro_torch/csrc/paged_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_attention.cu",
    "topk_retrieval": "src/repro_torch/csrc/topk_retrieval.cu",
    "flash_attention": "src/repro_torch/csrc/dense_attention.cu",
    "decode_attention": "src/repro_torch/csrc/dense_attention.cu",
    "rwkv6_chunked": "src/repro_torch/csrc/rwkv6_scan.cu",
    "ssm_scan": "src/repro_torch/csrc/ssm_scan.cu",
}


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
# the split decode's edges: at these shapes each split walks 8 table entries
# (128 slots), so -1 holes at entries 8 and 16 sit on split boundaries, and
# the shortest row (length 1) leaves every split but the first empty
SPLIT_HOLES = (8, 16)
SPLIT_LENGTHS = LENGTHS[:-1] + [1]
# the engine's mixed step (max_batch 8, 256-token chunks, pack_align 4): one
# row prefills 256 plain-causal tokens at slots 1024-1279, seven rows decode
# one token each at lengths spread over 300-340, one pad: 264 packed tokens
MIXED_LENGTHS = [1280, 301, 308, 312, 319, 326, 330, 337]
MIXED_CHUNKS = {0: (256, 0, 0)}
MIXED_PAD = 1


def make_case(dtype_name, gen, lengths=LENGTHS, chunks=CHUNKS, n_pad=N_PAD):
    """Tables, pools and packed arrays at the engine's qwen2.5-3b shapes:
    rows of ``lengths`` after the step, ``chunks`` {row: (tokens, p_end,
    s_start)} prefilling (the other rows decode one token), ``n_pad`` pad
    tokens at the tail."""
    perm = torch.randperm(N_BLOCKS - 1, generator=gen) + 1   # block 0: scratch
    tables = np.full((B, MB_CHUNK), -1, np.int32)
    cur = 0
    for b, ln in enumerate(lengths):
        need = -(-ln // BS)
        tables[b, :need] = perm[cur:cur + need].numpy()
        cur += need
    for b in (2, 5):                                     # interior RAW holes
        tables[b, 3] = -1
    row_of, slots, p_end, s_start = [], [], [], []
    for b, ln in enumerate(lengths):
        c, pe, ss = chunks.get(b, (1, 0, 0))
        for s in range(ln - c, ln):
            row_of.append(b)
            slots.append(s)
            p_end.append(pe)
            s_start.append(ss)
    row_of += [-1] * n_pad
    slots += [0] * n_pad
    p_end += [0] * n_pad
    s_start += [0] * n_pad
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
        "lengths": i32(lengths), "row_of": i32(row_of), "slots": i32(slots),
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
    """Median time of one call, each launch timed alone with CUDA events
    after a write of a buffer larger than the 50 MB L2 (the engine calls the
    kernels between weight-streaming matmuls, so K/V is cold). The card
    waits for the call's host side between the two events, so a short
    kernel's time includes its wrapper's launch cost (``device_ms`` does
    not)."""
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


def device_ms(fn, reps=10):
    """Device time of one call with no host gaps: a spin kernel holds the
    stream while the host queues ``reps`` calls behind it, so the card runs
    them back to back, and CUDA events around them give the time (L2 warm:
    no flush between calls). None ("not measured") if the spin ended before
    the host had queued every call."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)      # ~50 ms at the H100's 1.98 GHz boost clock
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    if a.query():
        print(f"[device_ms] the spin ended before {reps} calls were queued; not measured",
              flush=True)
        b.synchronize()
        return None
    b.synchronize()
    return a.elapsed_time(b) / reps


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f}"


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


def paged_calls(ka):
    """name -> (kernel call, plain call) on a case of ``make_case``."""
    return {
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


def on_card(case, dtype_name):
    """The case on the card, and the inputs of its second check: the same
    values in f32 (bf16 pools), or q in bf16 (int8 pools)."""
    case = {k: (v.cuda() if v is not None else None) for k, v in case.items()}
    other = None
    if dtype_name == "bfloat16":
        other = dict(case, **{k: case[k].float() for k in ("q_dec", "q_chunk", "k", "v")})
    elif dtype_name == "int8":
        other = dict(case, **{k: case[k].bfloat16() for k in ("q_dec", "q_chunk")})
    return case, other


def paged_row(name, kern, plain, case, other, dtype_name, flush, label=""):
    """Check one paged kernel on ``case`` against its plain version (and the
    second check on ``other``), then time it, its plain version and SDPA
    beside the bound."""
    valid = (case["row_of"] >= 0 if name == "paged_chunk_attention"
             else torch.ones(B, dtype=torch.bool, device="cuda"))
    got = kern(case)
    torch.cuda.synchronize()
    errs = {"plain": check_close(f"{name}[{dtype_name}{label}]", got, plain(case), valid,
                                 TOL[dtype_name]["plain"])}
    if name == "paged_chunk_attention" and not bool((got[~valid] == 0).all()):
        raise AssertionError("paged_chunk_attention: pad tokens must be zeros")
    if dtype_name == "bfloat16":
        errs["plain_f32"] = check_close(f"{name}[bf16 vs f32{label}]", got, plain(other),
                                        valid, TOL[dtype_name]["plain_f32"])
    elif dtype_name == "int8":
        errs["plain_bf16_q"] = check_close(
            f"{name}[int8, bf16 q{label}]", kern(other), plain(other), valid,
            TOL[dtype_name]["plain_bf16_q"])
    nbytes, ops = work(case, name)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S[dtype_name] * 1e3
    lib = library_call(case, name)
    r = {
        "name": name, "dtype": dtype_name, "errs": errs,
        "ms": time_ms(lambda: kern(case), flush),
        "device_ms": device_ms(lambda: kern(case)),
        "plain_ms": time_ms(lambda: plain(case), flush, reps=20),
        "library_ms": time_ms(lib, flush) if lib is not None else None,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "ops": ops,
    }
    if dtype_name == "int8":     # bf16 q over the int8 pool: the other route of the kernel
        r["device_ms_bf16_q"] = device_ms(lambda: kern(other))
    checks = ", ".join(f"vs {k} {e:.3e} (atol, rtol {TOL[dtype_name][k]})"
                       for k, e in errs.items())
    extra = (f" device_ms_bf16_q={fmt_ms(r['device_ms_bf16_q'])}"
             if "device_ms_bf16_q" in r else "")
    print(f"[kernels] {name} {dtype_name}{label}: max_abs_err {checks}; "
          f"kernel_ms={r['ms']:.4f} device_ms={fmt_ms(r['device_ms'])}{extra} "
          f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
          f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}: {nbytes} B, {ops} flop)",
          flush=True)
    return r


def phase_kernels(ka):
    """Both paged kernels on the ragged case (``LENGTHS``, ``CHUNKS``), the
    split decode's edges, and the chunk kernel at the engine's mixed step
    (``MIXED_LENGTHS``): rows keyed (name, dtype) and, for the mixed step,
    (name, dtype, "mixed_step")."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}
    calls = paged_calls(ka)
    for dtype_name in ("float32", "bfloat16", "int8"):
        case, other = on_card(make_case(dtype_name, gen), dtype_name)
        for name, (kern, plain) in calls.items():
            rows[(name, dtype_name)] = paged_row(name, kern, plain, case, other, dtype_name,
                                                 flush)
        rows[("paged_decode_attention", dtype_name)]["split_edges"] = check_split_edges(
            ka, case, other, dtype_name)
        del case, other
        case, other = on_card(make_case(dtype_name, gen, MIXED_LENGTHS, MIXED_CHUNKS,
                                        MIXED_PAD), dtype_name)
        kern, plain = calls["paged_chunk_attention"]
        rows[("paged_chunk_attention", dtype_name, "mixed_step")] = paged_row(
            "paged_chunk_attention", kern, plain, case, other, dtype_name, flush,
            label=", mixed step")
        del case, other
        torch.cuda.empty_cache()
    return rows


def check_split_edges(ka, case, other, dtype_name):
    """The decode kernel on ``SPLIT_LENGTHS`` with -1 holes at the table
    entries ``SPLIT_HOLES`` (split boundaries), against its plain version at
    the phase's tolerances; bf16 also against the plain version in f32, int8
    also with bf16 q. Returns {check: max abs err}."""
    def edged(c):
        tables = c["tables_dec"].clone()
        tables[:, list(SPLIT_HOLES)] = -1
        return dict(c, tables_dec=tables,
                    lengths=torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device="cuda"))

    def run(c, fn):
        return fn(c["q_dec"], c["k"], c["v"], c["tables_dec"], c["lengths"],
                  k_scale=c["ks"], v_scale=c["vs"])

    c, o = edged(case), edged(other) if other is not None else None
    every = torch.ones(B, dtype=torch.bool, device="cuda")
    name = f"paged_decode_attention[{dtype_name}, split edges]"
    got = run(c, ka.paged_decode_attention)
    torch.cuda.synchronize()
    errs = {"plain": check_close(name, got, run(c, ka.ref_paged_decode_attention), every,
                                 TOL[dtype_name]["plain"])}
    if dtype_name == "bfloat16":
        errs["plain_f32"] = check_close(name + " vs f32", got,
                                        run(o, ka.ref_paged_decode_attention), every,
                                        TOL[dtype_name]["plain_f32"])
    elif dtype_name == "int8":
        errs["plain_bf16_q"] = check_close(
            name + " bf16 q", run(o, ka.paged_decode_attention),
            run(o, ka.ref_paged_decode_attention), every, TOL[dtype_name]["plain_bf16_q"])
    checks = ", ".join(f"vs {k} {e:.3e} (atol, rtol {TOL[dtype_name][k]})"
                       for k, e in errs.items())
    print(f"[kernels] {name}: lengths {SPLIT_LENGTHS}, holes at entries {SPLIT_HOLES}: "
          f"max_abs_err {checks}", flush=True)
    return errs


# ---------------------------------------------------------------------------
# phase 2b: the dense backend's kernels against their plain versions
# ---------------------------------------------------------------------------

# 64 and 65: one whole 64-row tile and one row past it; 200 and 1100: no
# power-of-two tile above 8 divides them; 2048: the dense serve's largest bucket
FLASH_S = (16, 64, 65, 200, 1100, 2048)
DECODE_LENGTHS = {"lengths": LENGTHS, "shortest_1": LENGTHS[:-1] + [1],
                  "mixed_step": MIXED_LENGTHS}


def dense_work(kernel, q, k, causal=True, lengths=None):
    """(bytes, flops) the function needs: q, K/V (decode: the slots below
    each row's length) read once, the output written once; 4*hd flops per
    query head per (query, valid key) pair."""
    item = q.element_size()
    if kernel == "flash_attention":
        B, S, Hq, hd = q.shape
        pairs = B * (S * (S + 1) // 2 if causal else S * S)
        nbytes = (2 * q.numel() + 2 * k.numel()) * item
    else:
        B, Hq, hd = q.shape
        pairs = sum(lengths)
        nbytes = 2 * q.numel() * item + 2 * pairs * k.shape[2] * hd * item + 4 * B
    return nbytes, 4 * hd * Hq * pairs


def phase_dense_kernels(ka, kf):
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for S in FLASH_S:
            q, k, v = (torch.randn((1, S, n, HD), generator=gen, device="cuda").to(dt)
                       for n in (H, KVH, KVH))
            for causal in (True, False):
                name = f"flash_attention[{dtype_name}, S={S}, causal={causal}]"
                got = kf.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                every = slice(None)
                errs = {"plain": check_close(name, got, kf.ref_flash_attention(q, k, v, causal),
                                             every, tol["plain"])}
                if dtype_name == "bfloat16":
                    want = kf.ref_flash_attention(q.float(), k.float(), v.float(), causal)
                    errs["plain_f32"] = check_close(name + " vs f32", got, want, every,
                                                    tol["plain_f32"])
                r = {"errs": errs}
                if S == FLASH_S[-1] and causal:
                    # SDPA on the (B, H, S, hd) layout, transposed outside the timing
                    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                 enable_gqa=True)
                    r.update(timed_row(dense_work("flash_attention", q, k, causal=True),
                                       dtype_name, flush,
                                       lambda: kf.flash_attention(q, k, v, causal=True),
                                       lambda: kf.ref_flash_attention(q, k, v, True), lib))
                rows[("flash_attention", dtype_name, S, causal)] = r
                print_dense_row(name, r, tol)
            del q, k, v
        for case, lengths in DECODE_LENGTHS.items():
            q = torch.randn((B, H, HD), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((B, 2048, KVH, HD), generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            name = f"decode_attention[{dtype_name}, Sc=2048, {case}]"
            got = ka.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            every = slice(None)
            errs = {"plain": check_close(name, got, ka.ref_decode_attention(q, k, v, lens),
                                         every, tol["plain"])}
            if dtype_name == "bfloat16":
                want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
                errs["plain_f32"] = check_close(name + " vs f32", got, want, every,
                                                tol["plain_f32"])
            r = {"errs": errs}
            if case in ("lengths", "mixed_step"):
                qt = q[:, :, None, :]
                kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
                mask = (torch.arange(2048, device="cuda")[None] < lens.long()[:, None])
                mask = mask[:, None, None, :]
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True)
                r.update(timed_row(dense_work("decode_attention", q, k, lengths=lengths),
                                   dtype_name, flush,
                                   lambda: ka.decode_attention(q, k, v, lens),
                                   lambda: ka.ref_decode_attention(q, k, v, lens), lib))
            rows[("decode_attention", dtype_name, case)] = r
            print_dense_row(name, r, tol)
            del q, k, v
        torch.cuda.empty_cache()
    return rows


def timed_row(work, dtype_name, flush, kern, plain, lib):
    nbytes, ops = work
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S[dtype_name] * 1e3
    return {"ms": time_ms(kern, flush), "device_ms": device_ms(kern),
            "plain_ms": time_ms(plain, flush, reps=10),
            "library_ms": time_ms(lib, flush), "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def print_dense_row(name, r, tol):
    checks = ", ".join(f"vs {k} {e:.3e} (atol, rtol {tol[k]})" for k, e in r["errs"].items())
    times = (f"; kernel_ms={r['ms']:.4f} device_ms={fmt_ms(r['device_ms'])} "
             f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
             f"bound_ms={r['bound_ms']:.5f} "
             f"({r['bound_by']}: {r['bytes']} B, {r['ops']} flop)") if "ms" in r else ""
    print(f"[dense kernels] {name}: max_abs_err {checks}{times}", flush=True)


# ---------------------------------------------------------------------------
# phase 2c: the RWKV-6 WKV kernel against its plain version
# ---------------------------------------------------------------------------

WKV_H, WKV_HD = 64, 64                       # rwkv6-7b: d_model 4096, head_dim 64
# (name, B, S, decay): None draws the realistic Finch decay exp(-exp(z)),
# z ~ N(0, 0.5), as tests/test_kernels.py does
WKV_CASES = (("prefill", 1, 2048, None), ("prefill", 1, 37, None), ("decode", 8, 1, None),
             ("w=0.45", 1, 2048, 0.45), ("w=1e-6", 1, 2048, 1e-6),
             # lengths about the kernel's segment edges (wkv_segments: one
             # segment up to 16 steps, then segments of >= 32 steps; 1519 is
             # the longest serve prompt)
             *(("segments", 1, S, None) for S in (1, 33, 255, 257, 1519)))
# both sides compute in f32 (bf16 r, k and v widen exactly): summation
# order only
WKV_TOL = (1e-4, 1e-4)


def wkv_inputs(gen, B, S, dtype, decay):
    shape = (B, S, WKV_H, WKV_HD)
    r, k = (0.5 * torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    v = torch.randn(shape, generator=gen, device="cuda")
    if decay is None:
        w = torch.exp(-torch.exp(0.5 * torch.randn(shape, generator=gen, device="cuda")))
    else:
        w = torch.full(shape, decay, device="cuda")
    u = 0.3 * torch.randn((WKV_H, WKV_HD), generator=gen, device="cuda")
    state0 = 0.5 * torch.randn((B, WKV_H, WKV_HD, WKV_HD), generator=gen, device="cuda")
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, state0


def wkv_work(r, state0):
    """(bytes, flops) of one call: r, k, v (their dtype), w (f32), u and
    state0 read once, y (f32) and the final state written once; 5 flops per
    state element per step (the y product 2, the decay and the k v^T
    update 3), the bonus term's O(hd) per step besides."""
    B, S, H, hd = r.shape
    nbytes = (3 * r.numel() * r.element_size() + r.numel() * 4 * 2 + H * hd * 4
              + 2 * state0.numel() * 4)
    ops = B * S * H * (5 * hd * hd + 5 * hd)
    return nbytes, ops


def phase_wkv_kernel(kw):
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for case, B, S, decay in WKV_CASES:
            r, k, v, w, u, state0 = wkv_inputs(gen, B, S, dt, decay)
            name = f"rwkv6_chunked[{dtype_name}, {case}, B={B}, S={S}]"
            y, st = kw.rwkv6_chunked(r, k, v, w, u, state0)
            torch.cuda.synchronize()
            y_ref, st_ref = kw.ref_rwkv6_chunked(r, k, v, w, u, state0)
            every = slice(None)
            err = max(check_close(name + " y", y, y_ref, every, WKV_TOL),
                      check_close(name + " state", st, st_ref, every, WKV_TOL))
            r_ = {"errs": {"plain": err}, "segments": kw.rwkv6_chunked.segments}
            if case in ("prefill", "decode") and (case == "decode" or S == 2048):
                # the serve phase updates the state in place; here the
                # output goes to its own buffer, so every call sees the
                # same state0
                out = torch.empty_like(state0)
                kern = lambda: kw.rwkv6_chunked(r, k, v, w, u, state0, state_out=out)
                nbytes, ops = wkv_work(r, state0)
                bytes_ms = nbytes / HBM_BYTES_S * 1e3
                ops_ms = ops / PEAK_OPS_S["float32"] * 1e3
                r_.update({"ms": time_ms(kern, flush), "device_ms": device_ms(kern),
                           "plain_ms": time_ms(lambda: kw.ref_rwkv6_chunked(r, k, v, w, u, state0),
                                               flush, reps=5),
                           "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                           "bytes": nbytes, "ops": ops})
            rows[(dtype_name, case, S)] = r_
            times = (f"; kernel_ms={r_['ms']:.4f} device_ms={fmt_ms(r_['device_ms'])} "
                     f"plain_ms={r_['plain_ms']:.4f} library_ms=none (no single PyTorch call "
                     f"computes the recurrence) bound_ms={r_['bound_ms']:.5f} "
                     f"({r_['bound_by']}: {r_['bytes']} B, {r_['ops']} flop)") if "ms" in r_ else ""
            print(f"[wkv kernel] {name}: max_abs_err vs plain {err:.3e} (atol, rtol {WKV_TOL}), "
                  f"finite, (n_seg, seg_len) {r_['segments']}{times}", flush=True)
            del r, k, v, w, u, state0, y, st, y_ref, st_ref
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2d: the selective-scan kernel against its plain version
# ---------------------------------------------------------------------------

SSM_DI, SSM_N = 1600, 16                     # hymba-1.5b: d_model 1600, ssm_state 16
# (name, B, S, extreme): dt = softplus(z), z ~ N(-2, 1) as tests/test_kernels.py
# draws it (dt * A near -0.1 .. -3), or for "extreme" z ~ N(1, 2) clipped to
# [-10, 3.1] (dt up to ~3.1: dt * A down to about -50 at A = -16)
SSM_CASES = (("prefill", 1, 1664, False), ("prefill", 1, 37, False), ("decode", 8, 1, False),
             ("extreme", 1, 1664, True),
             # lengths about the kernel's segment edges (ssm_segments; 1647 is
             # the longest hymba serve prefill: 128 meta + 1519 tokens)
             *(("segments", 1, S, False) for S in (1, 17, 129, 1647)))
# both sides compute in f32 (bf16 inputs widen exactly); the kernel's exp2 of
# dt * A * log2(e) against exp(dt * A): a few ulps a step
SSM_TOL = (1e-4, 1e-4)
SFU_PER_CLOCK = 16                           # exp2 results per clock per SM (sm_90)


def sfu_rate():
    """Exponentials per second the card can issue: SMs x 16 a clock at the
    card's maximum SM clock (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SFU_PER_CLOCK * float(out) * 1e6, sms, float(out)


def ssm_inputs(gen, B, S, dtype, extreme):
    shape = (B, S, SSM_DI)
    z = torch.randn(shape, generator=gen, device="cuda")
    z = (2.0 * z + 1.0).clamp(-10.0, 3.1) if extreme else z - 2.0
    dt = torch.nn.functional.softplus(z)
    x = torch.randn(shape, generator=gen, device="cuda")
    bm, cm = (0.5 * torch.randn((B, S, SSM_N), generator=gen, device="cuda") for _ in range(2))
    a_log = torch.log(torch.arange(1, SSM_N + 1, dtype=torch.float32, device="cuda"))
    a_log = a_log.expand(SSM_DI, SSM_N).contiguous()
    h0 = 0.5 * torch.randn((B, SSM_DI, SSM_N), generator=gen, device="cuda")
    return dt.to(dtype), x.to(dtype), bm.to(dtype), cm.to(dtype), a_log, h0


def ssm_work(dt, bm, h0):
    """(bytes, f32 flops, exponentials) of one call: dt, x, B and C (their
    dtype) read once, a_log and h0 read once, y and the final h (f32)
    written once; 6 flops per state element per step (dt * A, (dt x) * B,
    the FMA of h, C * h and its sum) and one exponential."""
    B, S, Di = dt.shape
    item = dt.element_size()
    nbytes = (2 * dt.numel() + 2 * bm.numel()) * item + dt.numel() * 4 + Di * SSM_N * 4 \
        + 2 * h0.numel() * 4
    elems = B * S * Di * SSM_N
    return nbytes, 6 * elems, elems


def phase_ssm_kernel(ks):
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    exp_s, sms, clock = sfu_rate()
    print(f"[ssm kernel] SFU bound: {sms} SMs x {SFU_PER_CLOCK} exp2 a clock x {clock:.0f} MHz "
          f"(max SM clock) = {exp_s:.4e} exponentials/s", flush=True)
    rows = {}
    for dtype_name in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype_name)
        for case, B, S, extreme in SSM_CASES:
            dt, x, bm, cm, a_log, h0 = ssm_inputs(gen, B, S, dt_, extreme)
            name = f"ssm_scan[{dtype_name}, {case}, B={B}, S={S}]"
            y, h = ks.ssm_scan(dt, x, bm, cm, a_log, h0)
            torch.cuda.synchronize()
            y_ref, h_ref = ks.ref_ssm_scan(dt, x, bm, cm, a_log, h0)
            every = slice(None)
            errs = {"plain": max(check_close(name + " y", y, y_ref, every, SSM_TOL),
                                 check_close(name + " h", h, h_ref, every, SSM_TOL))}
            if dtype_name == "bfloat16":
                y32, h32 = ks.ref_ssm_scan(dt.float(), x.float(), bm.float(), cm.float(),
                                           a_log, h0)
                errs["plain_f32"] = max(check_close(name + " y vs f32", y, y32, every, SSM_TOL),
                                        check_close(name + " h vs f32", h, h32, every, SSM_TOL))
            r_ = {"errs": errs, "dA_min": float((dt.float().max() * -SSM_N)),
                  "segments": ks.ssm_scan.segments}
            if case in ("prefill", "decode") and S != 37:
                # the serve phase updates h in place; here the output goes
                # to its own buffer, so every call sees the same h0
                out = torch.empty_like(h0)
                kern = lambda: ks.ssm_scan(dt, x, bm, cm, a_log, h0, h_out=out)
                nbytes, ops, exps = ssm_work(dt, bm, h0)
                parts = {"bytes": nbytes / HBM_BYTES_S * 1e3,
                         "operations": max(ops / PEAK_OPS_S["float32"], exps / exp_s) * 1e3}
                bound_by = max(parts, key=parts.get)
                r_.update({"ms": time_ms(kern, flush), "device_ms": device_ms(kern),
                           "plain_ms": time_ms(lambda: ks.ref_ssm_scan(dt, x, bm, cm, a_log, h0),
                                               flush, reps=5),
                           "library_ms": None, "bound_ms": parts[bound_by],
                           "bound_by": bound_by, "bytes": nbytes, "ops": ops, "exps": exps,
                           "exp_ms": exps / exp_s * 1e3,
                           "flop_ms": ops / PEAK_OPS_S["float32"] * 1e3})
            rows[(dtype_name, case, S)] = r_
            times = (f"; kernel_ms={r_['ms']:.4f} device_ms={fmt_ms(r_['device_ms'])} "
                     f"plain_ms={r_['plain_ms']:.4f} library_ms=none (no single PyTorch call "
                     f"computes the scan) bound_ms={r_['bound_ms']:.5f} ({r_['bound_by']}: "
                     f"{r_['bytes']} B = {r_['bytes'] / HBM_BYTES_S * 1e3:.5f} ms, "
                     f"{r_['ops']} flop = {r_['flop_ms']:.5f} ms, {r_['exps']} exp = "
                     f"{r_['exp_ms']:.5f} ms)") if "ms" in r_ else ""
            checks = ", ".join(f"vs {k} {e:.3e}" for k, e in errs.items())
            print(f"[ssm kernel] {name}: max_abs_err {checks} (atol, rtol {SSM_TOL}), finite, "
                  f"min dt*A {r_['dA_min']:.1f}, (n_seg, seg_len) {r_['segments']}{times}",
                  flush=True)
            del dt, x, bm, cm, a_log, h0, y, h, y_ref, h_ref
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2e: the flash kernel with a sliding window
# ---------------------------------------------------------------------------

SWA_H, SWA_KVH, SWA_HD = 25, 5, 64           # hymba-1.5b's heads
SWA_CASES = ((1664, 1024), (300, 64))        # (S, window): full width, smoke window


def swa_work(q, k, window):
    """(bytes, flops): q, K, V read once, the output written once; 4*hd
    flops per query head per (query, key) pair inside the causal window."""
    B, S, Hq, hd = q.shape
    pairs = B * sum(min(i + 1, window) for i in range(S))
    return (2 * q.numel() + 2 * k.numel()) * q.element_size(), 4 * hd * Hq * pairs


def phase_swa_kernels(kf):
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for S, window in SWA_CASES:
            q, k, v = (torch.randn((1, S, n, SWA_HD), generator=gen, device="cuda").to(dt)
                       for n in (SWA_H, SWA_KVH, SWA_KVH))
            name = f"flash_attention[{dtype_name}, S={S}, window={window}]"
            got = kf.flash_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            every = slice(None)
            errs = {"plain": check_close(name, got, kf.ref_flash_attention(q, k, v, window=window),
                                         every, tol["plain"])}
            if dtype_name == "bfloat16":
                want = kf.ref_flash_attention(q.float(), k.float(), v.float(), window=window)
                errs["plain_f32"] = check_close(name + " vs f32", got, want, every,
                                                tol["plain_f32"])
            r = {"errs": errs}
            if S == SWA_CASES[0][0]:
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                i = torch.arange(S, device="cuda")
                mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True)
                r.update(timed_row(swa_work(q, k, window), dtype_name, flush,
                                   lambda: kf.flash_attention(q, k, v, window=window),
                                   lambda: kf.ref_flash_attention(q, k, v, window=window), lib))
            rows[(dtype_name, S, window)] = r
            print_dense_row(name, r, tol)
            del q, k, v
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2f: the dense decode kernel at hymba's heads
# ---------------------------------------------------------------------------

SWA_SC = 1024                                # hymba-1.5b's ring: min(max_seq + 128, window)
# full rings (every decode step past the window) beside short rows; and the
# mixed step's lengths on the ring
SWA_DECODE_CASES = {"rings": [1024, 1024, 1, 1024, 37, 1024, 300, 1024],
                    "mixed_step": [min(n, SWA_SC) for n in MIXED_LENGTHS]}


def phase_swa_decode_kernel(ka):
    """``decode_attention`` at the hymba serve phase's shapes (B 8, H 25 over
    KVH 5, hd 64, a 1024-slot ring, lengths min(pos + 1, 1024)) against its
    plain version, in f32 and bf16 (bf16 also against the plain version in
    f32), with the tolerances of phase 2b, on each of ``SWA_DECODE_CASES``;
    then its times beside the bound and a masked SDPA."""
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    for case, lengths in SWA_DECODE_CASES.items():
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        Bd = len(lengths)
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            tol = TOL[dtype_name]
            q = torch.randn((Bd, SWA_H, SWA_HD), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((Bd, SWA_SC, SWA_KVH, SWA_HD), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            name = (f"decode_attention[{dtype_name}, H={SWA_H}, KVH={SWA_KVH}, hd={SWA_HD}, "
                    f"Sc={SWA_SC}, {case}]")
            got = ka.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            every = slice(None)
            errs = {"plain": check_close(name, got, ka.ref_decode_attention(q, k, v, lens),
                                         every, tol["plain"])}
            if dtype_name == "bfloat16":
                want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
                errs["plain_f32"] = check_close(name + " vs f32", got, want, every,
                                                tol["plain_f32"])
            qt = q[:, :, None, :]
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            mask = (torch.arange(SWA_SC, device="cuda")[None] < lens.long()[:, None])[:, None, None]
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         enable_gqa=True)
            r = {"errs": errs}
            r.update(timed_row(dense_work("decode_attention", q, k, lengths=lengths),
                               dtype_name, flush, lambda: ka.decode_attention(q, k, v, lens),
                               lambda: ka.ref_decode_attention(q, k, v, lens), lib))
            rows[(dtype_name, case)] = r
            print_dense_row(name, r, tol)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the top-k retrieval kernel against its plain version
# ---------------------------------------------------------------------------

N_DOCS, DIM, N_QUERIES, N_CLUSTERS = 1 << 21, 768, 32, 1024
TOPK_KS = (10, 100)
# scores: the kernel sums each dot product in another order than the plain
# version's matrix product (a few ulps); ids: two docs may swap places only
# where the plain version's scores of the two lie within "swap"; on exact
# ties (integer-valued docs, all products exact) the ids must be equal
TOPK_TOL = {"score_atol": 1e-4, "swap": 1e-5}


def check_topk(name, got, want, q, docs, exact_ids):
    (gs, gi), (ws, wi) = got, want
    if gs.shape != ws.shape or gi.dtype != torch.int32 or gs.dtype != torch.float32:
        raise AssertionError(f"{name}: got {gs.dtype}{tuple(gs.shape)}/{gi.dtype}, "
                             f"want {ws.dtype}{tuple(ws.shape)}/{wi.dtype}")
    if not bool(torch.isfinite(gs).all()):
        raise AssertionError(f"{name}: non-finite scores")
    err = float((gs - ws).abs().max())
    if err > TOPK_TOL["score_atol"]:
        raise AssertionError(f"{name}: max abs score err {err:.3e} > {TOPK_TOL['score_atol']}")
    diff = gi != wi
    if exact_ids:
        if bool(diff.any()):
            raise AssertionError(f"{name}: {int(diff.sum())} ids differ on exact ties")
    elif bool(diff.any()):
        full = q.float() @ docs.float().T
        gap = (full.gather(1, gi.long()) - full.gather(1, wi.long())).abs()[diff]
        if float(gap.max()) > TOPK_TOL["swap"]:
            raise AssertionError(f"{name}: {int(diff.sum())} ids differ, plain-score gap "
                                 f"up to {float(gap.max()):.3e} > {TOPK_TOL['swap']}")
    return err, int(diff.sum())


def topk_work(q, docs, k):
    """(bytes, flops, products) of the kernel's route: docs and queries
    read once, (B, k) scores and ids written once; the products the split
    needs on the tensor cores, 2*B*N*d flops each at the dense tf32 rate:
    3 with float32 docs (hi*hi, hi*lo, lo*hi) and 2 with bfloat16 docs
    (exact in tf32: the query alone is split; the kernel takes it as three
    bf16 parts at twice the rate, the same time)."""
    B, d = q.shape
    nbytes = docs.numel() * docs.element_size() + q.numel() * 4 + B * k * 8
    products = 3 if docs.dtype == torch.float32 else 2
    return nbytes, products * 2 * B * docs.shape[0] * d, products


def phase_topk(tk, corpus, queries):
    """``corpus``: the (N_DOCS, DIM) float32 corpus on the card; ``queries``:
    (N_QUERIES, DIM) float32 on the card."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for case in ("float32", "bfloat16", "ties_float32", "ties_bfloat16"):
        if case.startswith("ties"):
            base = torch.randint(-2, 3, (4096, DIM), generator=gen, device="cuda").float()
            docs = base[torch.randint(0, 4096, (N_DOCS,), generator=gen, device="cuda")]
            q = torch.randint(-2, 3, (N_QUERIES, DIM), generator=gen, device="cuda").float()
            del base
        else:
            docs, q = corpus, queries
        if case.endswith("bfloat16"):
            docs = docs.bfloat16()
        for k in TOPK_KS:
            got = tk.topk_retrieval(q, docs, k)
            torch.cuda.synchronize()
            err, n_swapped = check_topk(f"topk_retrieval[{case}, k={k}]", got,
                                        tk.ref_topk_retrieval(q, docs, k), q, docs,
                                        exact_ids=case.startswith("ties"))
            r = {"case": case, "k": k, "max_abs_err": err, "swapped": n_swapped}
            if not case.startswith("ties"):
                nbytes, ops, products = topk_work(q, docs, k)
                bytes_ms = nbytes / HBM_BYTES_S * 1e3
                ops_ms = ops / PEAK_OPS_S["tf32"] * 1e3
                # bf16 docs: one PyTorch call on the f32 upcast (no bf16 x f32 product)
                lib = ((lambda: torch.topk(q @ docs.T, k)) if docs.dtype == torch.float32
                       else (lambda: torch.topk(q @ docs.float().T, k)))
                r.update({
                    "ms": time_ms(lambda: tk.topk_retrieval(q, docs, k), flush),
                    "device_ms": device_ms(lambda: tk.topk_retrieval(q, docs, k)),
                    "plain_ms": time_ms(lambda: tk.ref_topk_retrieval(q, docs, k), flush,
                                        reps=10),
                    "library_ms": time_ms(lib, flush, reps=10),
                    "library": ("torch.topk(q @ docs.T, k)" if docs.dtype == torch.float32
                                else "torch.topk(q @ docs.float().T, k), the upcast included"),
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "bytes": nbytes, "ops": ops, "products": products,
                })
            rows[(case, k)] = r
            times = (f"; kernel_ms={r['ms']:.4f} device_ms={fmt_ms(r['device_ms'])} "
                     f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
                     f"[{r['library']}] bound_ms={r['bound_ms']:.4f} ({r['bound_by']}: "
                     f"{r['bytes']} B; {r['ops']} flop = {r['products']} split-tf32 "
                     f"products of 2BNd at 495 TFLOP/s)") if "ms" in r else ""
            print(f"[topk] {case} B={N_QUERIES} N={N_DOCS} d={DIM} k={k}: max_abs_err "
                  f"{err:.3e} (atol {TOPK_TOL['score_atol']}), {n_swapped} ids swapped "
                  f"within {TOPK_TOL['swap']}{times}", flush=True)
        del docs, q
        torch.cuda.empty_cache()
    return rows

# ---------------------------------------------------------------------------
# phase 4: engine parity at smoke width, CPU against GPU
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


def phase_pipeline_parity():
    """The same seeded open-loop trace (vrag + crag at 10 requests/s for 1
    trace-second, 30% sessions) through ``serve_pipelines`` on the CPU and on
    the card: identical driver records and tokens."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.launch.serve import serve_pipelines
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("smollm-135m"))
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        drv = serve_pipelines("smollm-135m", 10.0, 1.0, smoke=True, device=dev,
                              params=params, apps=("vrag", "crag"),
                              session_fraction=0.3, seed=1)
        reqs = sorted(drv.engine.finished, key=lambda r: r.req_id)
        out[dev] = (drv.records, [r.out_tokens for r in reqs], drv.engine.stats())
    if out["cpu"][:2] != out["cuda"][:2]:
        raise AssertionError("CPU and GPU pipeline runs differ:\n"
                             f"{out['cpu'][:2]}\n{out['cuda'][:2]}")
    assert out["cuda"][2]["kernel"] == "cuda" and out["cpu"][2]["kernel"] == "plain"
    assert out["cuda"][2]["session_shared_tokens"] > 0
    print(f"[parity] pipelines at smoke width f32: {len(out['cuda'][0])} pipelines, "
          f"{len(out['cuda'][1])} engine requests, identical records and tokens on cpu "
          f"and cuda; session-shared tokens {out['cuda'][2]['session_shared_tokens']}",
          flush=True)


def phase_dense_parity(ka, kf, kw):
    """The RAG workload of ``phase_parity`` on the dense backend: identical
    greedy tokens on the CPU (plain versions) and on the GPU (kernels), and
    on the GPU identical to the paged backend's. The segmented prompt is
    submitted flat to all three (the paged backend would otherwise give its
    documents their own positions, which the dense backend does not)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("smollm-135m"))
    prompts = [p.tokens if isinstance(p, SegmentedPrompt) else p
               for p in rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                                     3, 2, (10, 90), (16, 48, 32, 9))]
    out = {}
    for dev, backend in (("cpu", "dense"), ("cuda", "dense"), ("cuda", "paged")):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, backend=backend,
                               max_batch=4, max_seq=256)
        ka.reset_launch_counts()
        kf.reset_launch_counts()
        kw.reset_launch_counts()
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        assert all(len(r.out_tokens) == 12 for r in reqs), (dev, backend)
        assert eng.stats()["backend"] == backend
        out[(dev, backend)] = [r.out_tokens for r in reqs]
        if (dev, backend) == ("cuda", "dense"):
            launches = (kf.flash_attention.launches, ka.decode_attention.launches)
            assert launches == (cfg.num_layers * len(prompts),
                                cfg.num_layers * eng.stats()["steps"]), launches
            assert kw.rwkv6_chunked.launches == 0
    if out[("cpu", "dense")] != out[("cuda", "dense")]:
        raise AssertionError("dense backend: CPU and GPU greedy tokens differ:\n"
                             f"{out[('cpu', 'dense')]}\n{out[('cuda', 'dense')]}")
    if out[("cuda", "dense")] != out[("cuda", "paged")]:
        raise AssertionError("GPU dense and paged greedy tokens differ:\n"
                             f"{out[('cuda', 'dense')]}\n{out[('cuda', 'paged')]}")
    print(f"[parity] dense backend at smoke width f32: {len(prompts)} requests, identical "
          f"greedy tokens on cpu (plain) and cuda (kernels), and equal to the paged "
          f"backend's on cuda; flash/decode launches {launches}", flush=True)


def phase_rwkv_parity(kw):
    """The RWKV-6 smoke model's engine (``backend="paged"``, which falls
    back to dense) on the RAG workload of ``phase_parity``, flattened:
    identical greedy tokens on the CPU (plain versions) and on the GPU (the
    WKV kernel)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("rwkv6-7b"))
    prompts = [p.tokens if isinstance(p, SegmentedPrompt) else p
               for p in rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                                     3, 2, (10, 90), (16, 48, 32, 9))]
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4, max_seq=256)
        kw.reset_launch_counts()
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        st = eng.stats()
        assert st["backend"] == "dense" and all(len(r.out_tokens) == 12 for r in reqs), dev
        out[dev] = [r.out_tokens for r in reqs]
        if dev == "cuda":
            launches = kw.rwkv6_chunked.launches
            assert launches == cfg.num_layers * (len(prompts) + st["steps"]), (launches, st)
    if out["cpu"] != out["cuda"]:
        raise AssertionError("RWKV-6 engine: CPU and GPU greedy tokens differ:\n"
                             f"{out['cpu']}\n{out['cuda']}")
    print(f"[parity] rwkv6-7b smoke engine f32 (backend paged -> dense): {len(prompts)} "
          f"requests (prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens), "
          f"identical greedy tokens on cpu (plain) and cuda (kernel); rwkv6_chunked "
          f"launches {launches} = {cfg.num_layers} x ({len(prompts)} prefills + "
          f"{launches // cfg.num_layers - len(prompts)} decode steps)", flush=True)


def phase_hymba_parity(ka, kf, ks):
    """The hymba smoke model's engine (``backend="paged"``, which falls back
    to dense) on the RAG workload of ``phase_parity``, flattened: identical
    greedy tokens on the CPU (plain versions) and on the GPU (kernels).
    Its prompts (plus 8 meta tokens) run past the 64-token window."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("hymba-1.5b"))
    prompts = [p.tokens if isinstance(p, SegmentedPrompt) else p
               for p in rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                                     3, 2, (10, 90), (16, 48, 32, 9))]
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4, max_seq=256)
        ka.reset_launch_counts()
        kf.reset_launch_counts()
        ks.reset_launch_counts()
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        st = eng.stats()
        assert st["backend"] == "dense" and all(len(r.out_tokens) == 12 for r in reqs), dev
        out[dev] = [r.out_tokens for r in reqs]
        if dev == "cuda":
            L, n_pre, n_dec = cfg.num_layers, len(prompts), st["steps"]
            launches = (ks.ssm_scan.launches, kf.flash_attention.launches,
                        ka.decode_attention.launches)
            assert launches == (L * (n_pre + n_dec), L * n_pre, L * n_dec), (launches, st)
    if out["cpu"] != out["cuda"]:
        raise AssertionError("hymba engine: CPU and GPU greedy tokens differ:\n"
                             f"{out['cpu']}\n{out['cuda']}")
    print(f"[parity] hymba-1.5b smoke engine f32 (backend paged -> dense): {len(prompts)} "
          f"requests (prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens + "
          f"{cfg.num_meta_tokens} meta, window {cfg.window}), identical greedy tokens on cpu "
          f"(plain) and cuda (kernels); ssm_scan/flash/decode launches {launches} = "
          f"{cfg.num_layers} x ({len(prompts)} prefills + {n_dec} decode steps), "
          f"{cfg.num_layers} x {len(prompts)}, {cfg.num_layers} x {n_dec}", flush=True)


# ---------------------------------------------------------------------------
# phase 4d: int8 pools and swap/cost preemption at smoke width, CPU and card
# ---------------------------------------------------------------------------

# the cost model's per-token step time, pinned on both devices (a wall-clock
# quantity otherwise); at 6e-7 s the float pool of LONG_DECODE's workload
# swaps some victims and recomputes others
PINNED_TOKEN_S = 6e-7


def long_decode_workload(eng, seed):
    """The invariant harness's long-decode workload (tests/
    test_engine_invariants.py ``_run_workload(long_decode=True)``), greedy:
    bursts of short prompts with 28-38 new tokens each, interleaved with
    engine steps, so decodes outgrow a tiny pool and preempt."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(4):
        for _ in range(int(rng.integers(1, 4))):
            prompt = rng.integers(0, 90, size=int(rng.integers(3, 13)))
            reqs.append(eng.submit(prompt, max_new=int(rng.integers(28, 39)),
                                   priority=float(rng.random())))
        for _ in range(int(rng.integers(0, 4))):
            eng.step()
    eng.run_until_done(max_steps=2000)
    return reqs


def pin_token_time(eng, value):
    """Hold the runner's per-token step time at ``value`` through a run."""
    runner = eng.runner
    orig = runner.materialize

    def materialize(ex):
        out = orig(ex)
        runner.token_time_ema = value
        return out

    runner.materialize = materialize
    runner.token_time_ema = value


# the engine's int8 state, CPU against card: the K/V both quantize come
# from float32 stacks summing in different orders (cuBLAS against the CPU's
# matmuls), so payloads may sit one code apart where a value lies near a
# .5 boundary, and scales (absmax / 127) agree as the K/V do: 1e-5
# relative. On identical inputs the quantized write is exact
# (``check_scatter_exact``).
INT8_SCALE_RTOL = 1e-5


def int8_state_diff(cpu_kv, gpu_kv):
    """(max code difference of the int8 payloads, max relative scale
    difference), over every block but the null block (block 0: pad tokens
    write it and nothing reads it)."""
    codes = max(int((a[:, 1:].int() - b.cpu()[:, 1:].int()).abs().max())
                for a, b in ((cpu_kv.k, gpu_kv.k), (cpu_kv.v, gpu_kv.v)))
    rel = 0.0
    for a, b in ((cpu_kv.k_scale, gpu_kv.k_scale), (cpu_kv.v_scale, gpu_kv.v_scale)):
        a, b = a[:, 1:], b.cpu()[:, 1:]
        rel = max(rel, float(((a - b).abs() / a.abs().clamp(min=1e-30)).max()))
    return codes, rel


def check_scatter_exact():
    """The quantized scatter on the card against the CPU on identical
    inputs at qwen2.5-3b's pool geometry (one layer slice, 264 packed
    tokens): random values over partly zero scales, and values that all lie
    exactly on a .5 code (scale 2**-7), which both round half to even.
    Payloads and scales must be equal bit for bit. Returns the case count."""
    from repro_torch.serving.paged_cache import _quantized_scatter

    g = torch.Generator().manual_seed(5)
    nb, T = 64, 264
    for ties in (False, True):
        if ties:
            pool = torch.zeros((1, nb, BS, KVH, HD), dtype=torch.int8)
            sc = torch.zeros((1, nb, KVH))
            dest = torch.arange(1, nb) * BS + torch.randint(0, BS, (nb - 1,), generator=g)
            vals = (torch.randint(-127, 127, (1, nb - 1, KVH, HD), generator=g) + 0.5) / 128
            vals[..., 0] = 127.0 / 128.0
        else:
            pool = torch.randint(-127, 128, (1, nb, BS, KVH, HD), generator=g,
                                 dtype=torch.int8)
            sc = torch.rand((1, nb, KVH), generator=g) * 0.02
            sc[:, :8] = 0.0
            dest = torch.randperm(nb * BS, generator=g)[:T]
            vals = torch.randn((1, T, KVH, HD), generator=g) * 3.0
        cpu, card = (pool.clone(), sc.clone()), (pool.cuda(), sc.cuda())
        _quantized_scatter(*cpu, dest, vals)
        _quantized_scatter(*card, dest.cuda(), vals.cuda())
        if not (torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])):
            raise AssertionError(f"quantized scatter (ties={ties}): card and CPU differ")
    return 2


def phase_int8_swap_parity():
    """int8 pools and the preemption strategies on the CPU and on the card:
    the RAG workload of ``phase_parity`` on an int8 pool (full
    provisioning), and the harness's long-decode workload on a 6-block pool
    under ``preempt="swap"`` (float and int8) and ``"cost"`` (the step time
    pinned). Identical greedy tokens and preemption/swap counts; int8
    payloads within one code and scales within ``INT8_SCALE_RTOL``; and the
    quantized scatter exact on identical inputs, .5 ties included."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    n_exact = check_scatter_exact()
    print(f"[parity] quantized scatter at qwen2.5-3b's pool geometry: {n_exact} cases "
          f"(random, all .5 ties) equal bit for bit on cpu and cuda", flush=True)
    cfg = smoke_variant(get_arch("smollm-135m"))
    prompts = rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                           3, 2, (10, 90), (16, 48, 32, 9))
    counters = ("steps", "preemptions", "swap_outs", "swap_ins", "cost_swap_choices",
                "cost_recompute_choices", "prefix_hit_tokens", "host_hit_tokens",
                "prefill_tokens")
    cases = {
        "int8 full pool": dict(kv_dtype="int8"),
        "swap float": dict(n_blocks=6, preempt="swap", seed=5),
        "swap int8": dict(n_blocks=6, preempt="swap", kv_dtype="int8", seed=5),
        "cost float": dict(n_blocks=6, preempt="cost", seed=6, scheduler="edf_slack"),
    }
    for name, kw in cases.items():
        kw = dict(kw)
        seed = kw.pop("seed", None)
        out = {}
        for dev in ("cpu", "cuda"):
            params = init_params(cfg, torch.Generator().manual_seed(0), dev)
            if seed is None:
                eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4,
                                       max_seq=256, **kw)
                reqs = [eng.submit(p, max_new=12) for p in prompts]
                eng.run_until_done()
            else:
                eng = GenerationEngine(cfg, params=params, device=dev, max_batch=3,
                                       max_seq=96, prefill_chunk_size=16, token_budget=20,
                                       **kw)
                if kw["preempt"] == "cost":
                    pin_token_time(eng, PINNED_TOKEN_S)
                reqs = long_decode_workload(eng, seed)
            st = eng.stats()
            assert all(r.done and len(r.out_tokens) == r.max_new for r in reqs), (name, dev)
            assert pool_is_clean(eng), (name, dev)
            if eng.host_store is not None:
                assert eng.host_store.n_swapped == 0 and st["swap_ins"] == st["swap_outs"]
            out[dev] = ([r.out_tokens for r in reqs], {c: st[c] for c in counters}, eng)
        if out["cpu"][0] != out["cuda"][0]:
            raise AssertionError(f"{name}: CPU and GPU greedy tokens differ:\n"
                                 f"{out['cpu'][0]}\n{out['cuda'][0]}")
        if out["cpu"][1] != out["cuda"][1]:
            raise AssertionError(f"{name}: counters differ: {out['cpu'][1]} {out['cuda'][1]}")
        st = out["cuda"][1]
        extra = ""
        if "int8" in name:
            codes, rel = int8_state_diff(out["cpu"][2].kv, out["cuda"][2].kv)
            assert codes <= 1 and rel <= INT8_SCALE_RTOL, (name, codes, rel)
            extra = (f"; int8 payloads within {codes} code(s), scales within {rel:.3g} "
                     f"relative")
        if kw.get("preempt") in ("swap", "cost"):
            assert st["preemptions"] >= 1 and st["swap_outs"] >= 1, (name, st)
        print(f"[parity] {name} smoke width f32: {len(out['cuda'][0])} requests, identical "
              f"greedy tokens and counters on cpu (plain) and cuda (kernels): {st}{extra}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 5: serve qwen2.5-3b at full width
# ---------------------------------------------------------------------------


def phase_serve(ka, kf, tk, cfg, params):
    """Serve the RAG workload on ``cfg`` (qwen2.5-3b, bf16, on the card).
    Returns the kernels' launches in the run, the prompts, the greedy tokens
    and the pool's bytes."""
    from repro_torch.models import prefill_packed
    from repro_torch.serving.engine import GenerationEngine

    t0 = time.perf_counter()
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8,
                           max_seq=2048, block_size=16, prefill_chunk_size=256)
    n_var = eng.warmup_step_variants()
    print(f"[serve] {cfg.name} {cfg.dtype}: pools + warmup of {n_var} "
          f"packed lengths in {time.perf_counter() - t0:.1f}s", flush=True)
    prompts = rag_workload(np.random.default_rng(0), cfg.vocab_size, 512, (64, 1025),
                           5, 4, (128, 1537), (32, 256, 384, 40))
    lens = [len(p) for p in prompts]
    assert min(lens) >= 128 and max(lens) <= 1536, lens

    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)

    st, lat = eng.stats(), eng.latency_summary()
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["kernel"] == "cuda", st["kernel"]
    assert all(launches[n] > 0 for n in PAGED), launches
    assert all(launches[n] == 0 for n in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                          "ssm_scan")), launches
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
    # the paged attention kernels of each step: the chunk kernel's tile plan,
    # tiles and merge on mixed steps, the split decode and its merge on
    # decode-only steps
    attention = ("paged_chunk", "chunk_plan", "paged_decode_split", "split_merge")
    mixed = step_profile(eng, 3, attention)
    while any(r.slot < 0 or r.prefilling for r in extra):
        eng.step()
    decode = step_profile(eng, 3, attention)
    eng.run_until_done()
    for name, (kinds, host_ms, dev_ms, n_launch, attn_ms) in (("mixed", mixed),
                                                               ("decode-only", decode)):
        assert set(kinds) == {"ragged" if name == "mixed" else "decode"}, kinds
        print(f"[serve] {name} step: wall {host_ms:.2f} ms (mean of 3, profiler off); "
              f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches, of which "
              f"{attn_ms:.3f} ms in the paged attention kernels (torch.profiler, mean of 3)",
              flush=True)

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
    return launches, prompts, [r.out_tokens for r in reqs], pool_bytes(eng)


def phase_dense_serve(ka, kf, tk, cfg, params, prompts, paged_tokens):
    """Serve phase 5's prompts on the dense backend of ``cfg`` (qwen2.5-3b
    bf16); returns the five kernels' launches in the run (the paged and
    top-k kernels' are 0: the dense path goes through neither)."""
    from repro_torch.models import prefill
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", backend="dense",
                           max_batch=8, max_seq=2048)
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    st, lat = eng.stats(), eng.latency_summary()
    assert st["backend"] == "dense" and st["kernel"] == "cuda", st
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert launches == {"flash_attention": cfg.num_layers * len(reqs),
                        "decode_attention": cfg.num_layers * st["steps"],
                        "paged_chunk_attention": 0, "paged_decode_attention": 0,
                        "topk_retrieval": 0, "rwkv6_chunked": 0,
                        "ssm_scan": 0}, (launches, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[dense serve] {cfg.name} {cfg.dtype}: {len(reqs)} requests, {st['tokens_out']} "
          f"tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} tok/s (prefill tokens "
          f"{st['prefill_tokens']}); mean TTFT {1e3 * lat['ttft_mean']:.1f}ms, p95 TPOT "
          f"{1e3 * lat.get('tpot_p95', 0):.2f}ms; {st['steps']} decode steps; peak memory "
          f"{peak:.2f} GiB; launches {launches} ({cfg.num_layers} x {len(reqs)} prefills, "
          f"{cfg.num_layers} x {st['steps']} decode steps)", flush=True)
    # for information: the bf16 sums of the two backends differ in order
    pairs = [(a, r.out_tokens) for p, a, r in zip(prompts, paged_tokens, reqs)
             if not isinstance(p, SegmentedPrompt)]
    common = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
              for a, b in pairs]
    print(f"[dense serve] greedy agreement with the paged run on {len(pairs)} unsegmented "
          f"requests: {sum(a == b for a, b in pairs)}/{len(pairs)} rows identical, mean "
          f"common prefix {np.mean(common):.1f} of 32 tokens", flush=True)
    # the full-width dense stack gives finite logits of the expected shape
    toks = torch.as_tensor(np.asarray(prompts[0][:40]), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        last, cache = prefill(cfg, params, {"tokens": toks[None]})
    assert tuple(last.shape) == (1, cfg.padded_vocab)
    assert tuple(cache[0]["k"].shape) == (cfg.num_layers, 1, 40, cfg.num_kv_heads, cfg.head_dim)
    assert bool(torch.isfinite(last.float()).all())
    del eng
    torch.cuda.empty_cache()
    return launches


def step_profile(eng, n, kernels=None):
    """Per engine step, over ``n`` steps each: the mean wall time (profiler
    off, pipelined steps back to back), then the device-busy time and the
    kernel launches (torch.profiler). Returns the plan kinds stepped too
    ("dense" for each step of the dense backend). With ``kernels`` (a
    tuple of name fragments) it also returns the device ms per step of the
    kernels whose names hold one of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kind = lambda: eng.runner._last.plan.kind if eng.backend == "paged" else "dense"
    kinds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
        kinds.append(kind())
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
            kinds.append(kind())
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in cuda)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    out = (kinds, wall_ms, dev_us / n / 1e3, launches / n)
    if kernels is None:
        return out
    part_us = sum(e.self_device_time_total for e in cuda if any(k in e.key for k in kernels))
    return out + (part_us / n / 1e3,)


PAGED = ("paged_chunk_attention", "paged_decode_attention")
DENSE = ("flash_attention", "decode_attention")


def read_launches(ka, kf, tk):
    """Every ported kernel's launch count since ``reset_launches``."""
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    return {"paged_chunk_attention": ka.paged_chunk_attention.launches,
            "paged_decode_attention": ka.paged_decode_attention.launches,
            "topk_retrieval": tk.topk_retrieval.launches,
            "flash_attention": kf.flash_attention.launches,
            "decode_attention": ka.decode_attention.launches,
            "rwkv6_chunked": kw.rwkv6_chunked.launches,
            "ssm_scan": ks.ssm_scan.launches}


def reset_launches(ka, kf, tk):
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    ka.reset_launch_counts()
    kf.reset_launch_counts()
    tk.reset_launch_counts()
    kw.reset_launch_counts()
    ks.reset_launch_counts()


def pool_is_clean(eng):
    pool = eng.kv.pool
    return pool.n_free == pool.n_blocks - 1


def pool_bytes(eng):
    """Device bytes of the engine's K/V pools (and an int8 pool's scales)."""
    kv = eng.kv
    return sum(t.numel() * t.element_size()
               for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None)


# ---------------------------------------------------------------------------
# phase 5c: serve qwen2.5-3b on int8 pools
# ---------------------------------------------------------------------------


def agreement(tokens_a, tokens_b):
    """Share of positions where two runs' greedy tokens agree."""
    pairs = [(x, y) for a, b in zip(tokens_a, tokens_b) for x, y in zip(a, b)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_int8_serve(ka, kf, tk, cfg, params, prompts, bf16_tokens, bf16_pool_bytes):
    """Phase 5's ten prompts and engine settings on int8 pools
    (``kv_dtype="int8"``): the two paged kernels take their int8 route from
    the engine's running-max scales. Returns the launches, the step
    profiles and the figures."""
    from repro_torch.models import prefill_packed
    from repro_torch.serving.engine import GenerationEngine

    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=2048,
                           block_size=16, prefill_chunk_size=256, kv_dtype="int8")
    eng.warmup_step_variants()
    assert eng.kv.k.dtype == torch.int8 and eng.stats()["kv_dtype"] == "int8"
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    st, lat = eng.stats(), eng.latency_summary()
    assert st["kernel"] == "cuda", st["kernel"]
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert all(launches[n] > 0 and launches[n] % cfg.num_layers == 0 for n in PAGED), launches
    assert all(launches[n] == 0 for n in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                          "ssm_scan")), launches
    n_mixed = launches["paged_chunk_attention"] // cfg.num_layers
    n_dec = launches["paged_decode_attention"] // cfg.num_layers
    assert n_mixed + n_dec == st["steps"], (launches, st["steps"])
    assert pool_is_clean(eng) and st["prefix_hit_tokens"] > 0, st
    peak = torch.cuda.max_memory_allocated() / 2**30
    nbytes = pool_bytes(eng)
    agree = agreement(bf16_tokens, [r.out_tokens for r in reqs])
    print(f"[int8 serve] {cfg.name} {cfg.dtype} weights, int8 pools: {len(reqs)} requests, "
          f"{st['tokens_out']} tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} tok/s "
          f"(prefill tokens {st['prefill_tokens']}); mean TTFT {1e3 * lat['ttft_mean']:.1f}ms, "
          f"p95 TPOT {1e3 * lat.get('tpot_p95', 0):.2f}ms; {st['steps']} steps ({n_mixed} mixed, "
          f"{n_dec} decode-only); peak memory {peak:.2f} GiB; pool {nbytes / 2**20:.1f} MiB "
          f"against phase 5's bf16 pool {bf16_pool_bytes / 2**20:.1f} MiB "
          f"({nbytes / bf16_pool_bytes:.4f}x); launches {launches}", flush=True)
    print(f"[int8 serve] greedy agreement with phase 5's bf16 pools: {agree:.4f} of "
          f"{sum(map(len, bf16_tokens))} tokens (random full-width weights: reported, not "
          f"held to the smoke-width floor of 0.75)", flush=True)

    rng = np.random.default_rng(1)
    extra = [eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new=40) for _ in range(8)]
    attention = ("paged_chunk", "chunk_plan", "paged_decode_split", "split_merge")
    mixed = step_profile(eng, 3, attention)
    while any(r.slot < 0 or r.prefilling for r in extra):
        eng.step()
    decode = step_profile(eng, 3, attention)
    eng.run_until_done()
    profiles = {}
    for name, (kinds, host_ms, dev_ms, n_launch, attn_ms) in (("mixed", mixed),
                                                               ("decode-only", decode)):
        assert set(kinds) == {"ragged" if name == "mixed" else "decode"}, kinds
        profiles[name] = {"wall_ms": host_ms, "device_busy_ms": dev_ms,
                          "launches": n_launch, "paged_attention_ms": attn_ms}
        print(f"[int8 serve] {name} step: wall {host_ms:.2f} ms (mean of 3, profiler off); "
              f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches, of which "
              f"{attn_ms:.3f} ms in the paged attention kernels (torch.profiler, mean of 3)",
              flush=True)

    # the full-width int8 stack gives finite logits of the expected shape
    n = 40
    toks = torch.as_tensor(prompts[0][:n], dtype=torch.int32, device="cuda")
    tables = torch.full((1, eng._view_blocks), -1, dtype=torch.int32, device="cuda")
    tables[0, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    eng.kv.reset_block_scales([1, 2, 3])
    ar = torch.arange(n, dtype=torch.int32, device="cuda")
    zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits = prefill_packed(cfg, eng.params, eng.kv.k, eng.kv.v, tables, toks,
                                zeros, ar, ar, zeros, zeros, block_size=16,
                                null_block=eng._null_block, k_scales=eng.kv.k_scale,
                                v_scales=eng.kv.v_scale)
    assert tuple(logits.shape) == (n, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    figures = {"tok_s": st["tokens_out"] / wall, "ttft_mean_ms": 1e3 * lat["ttft_mean"],
               "tpot_p95_ms": 1e3 * lat.get("tpot_p95", 0), "steps": st["steps"],
               "peak_gib": peak, "pool_bytes": nbytes, "bf16_pool_bytes": bf16_pool_bytes,
               "greedy_agreement": agree, "step_profile": profiles}
    del eng
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phase 5d: the host tier and swap preemption at full width
# ---------------------------------------------------------------------------

# 192 blocks of 16 tokens (3072 token slots, against phase 5's 1033 blocks):
# the ten prompts (301-1519 tokens, 5946 in all) outgrow it, so admission
# evicts the first wave's finished documents from the warm LRU (demotion to
# the host tier) before the second wave asks for them again (promotion),
# and twice the running decodes run the pool dry (preemption). The plan
# sequence depends on token counts only (no eos), so a CPU run of the same
# prompts at smoke width shows the same schedule: at 256 blocks and 32 new
# tokens no decode ran the pool dry
TIGHT_POOL = 192
HOST_BLOCKS = 1024


def host_copy_rates(eng, n_blocks, reps=5):
    """Device->host and host->device rates (GB/s) of the engine's own copy
    path for an ``n_blocks`` chain: the gather plus the non-blocking copy
    into pinned memory, and the pinned staging plus the copy and scatter
    back, each between CUDA events (median of ``reps``)."""
    from repro_torch.serving.paged_cache import device_to_host

    ids = list(range(1, n_blocks + 1))
    nbytes = n_blocks * eng.host_store.block_bytes
    d2h, h2d = [], []
    for _ in range(reps):
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        host, wait = device_to_host(*eng.kv.gather_blocks(ids))
        mid.record()
        wait()
        eng.kv.write_blocks(ids, *(t for t in host if t is not None))
        end.record()
        end.synchronize()
        d2h.append(start.elapsed_time(mid))
        h2d.append(mid.elapsed_time(end))
    return (nbytes / (np.median(d2h) * 1e-3) / 1e9, nbytes / (np.median(h2d) * 1e-3) / 1e9,
            nbytes)


def phase_host_tier(ka, kf, tk, cfg, params, prompts):
    """Phase 5's prompts in two waves (every prompt's documents asked for
    again in the second) on a tight pool with a host tier, under each
    preemption strategy and once on int8 pools with swap. Returns the
    launches of the swap run and the per-strategy figures."""
    from repro_torch.serving.engine import GenerationEngine

    figures, launches = {}, None
    for name, kw in (("recompute", dict(preempt="recompute")),
                     ("swap", dict(preempt="swap")),
                     ("cost", dict(preempt="cost")),
                     ("swap int8", dict(preempt="swap", kv_dtype="int8"))):
        eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=2048,
                               block_size=16, prefill_chunk_size=256, n_blocks=TIGHT_POOL,
                               host_blocks=HOST_BLOCKS, **kw)
        eng.warmup_step_variants()
        reset_launches(ka, kf, tk)
        t0 = time.perf_counter()
        reqs = []
        for _wave in range(2):
            reqs += [eng.submit(p, max_new=32) for p in prompts]
            eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = read_launches(ka, kf, tk)
        st = eng.stats()
        hs = st["host_store"]
        assert st["kernel"] == "cuda" and all(len(r.out_tokens) == 32 for r in reqs), st
        assert all(run_launches[n] == 0 for n in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                                  "ssm_scan")), run_launches
        assert pool_is_clean(eng), (name, eng.kv.pool.n_free)
        assert hs["n_swapped"] == 0 and st["swap_ins"] == st["swap_outs"], (name, st)
        assert hs["puts"] > 0 and hs["hits"] > 0, (name, hs)       # demoted, promoted
        if name.startswith("swap"):
            assert st["swap_outs"] > 0, (name, st)
        if name == "swap":
            launches = run_launches
        figures[name] = {k: st[k] for k in (
            "steps", "tokens_out", "prefill_tokens", "preemptions", "swap_outs", "swap_ins",
            "swap_out_bytes", "swap_in_bytes", "swap_reshared_blocks", "cost_swap_choices",
            "cost_recompute_choices", "prefix_hit_tokens", "host_hit_tokens")}
        figures[name].update(tok_s=st["tokens_out"] / wall, wall_s=wall, host_store=hs)
        if name == "swap int8" or name == "swap":
            n = max(1, st["swap_out_bytes"] // max(st["swap_outs"], 1)
                    // eng.host_store.block_bytes)
            d2h, h2d, nbytes = host_copy_rates(eng, n)
            figures[name].update(d2h_gb_s=d2h, h2d_gb_s=h2d, copy_chain_blocks=n,
                                 copy_chain_bytes=nbytes)
        print(f"[host tier] {cfg.name} {cfg.dtype}, pool {TIGHT_POOL} blocks, host tier "
              f"{HOST_BLOCKS} blocks, preempt={name}: 2 waves of {len(prompts)} requests, "
              f"{st['tokens_out']} tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} "
              f"tok/s; {st['steps']} steps; prefill tokens {st['prefill_tokens']}; "
              f"preemptions {st['preemptions']}, swap outs/ins {st['swap_outs']}/"
              f"{st['swap_ins']} ({st['swap_out_bytes'] / 2**20:.1f} MiB out, "
              f"{st['swap_in_bytes'] / 2**20:.1f} MiB in, {st['swap_reshared_blocks']} blocks "
              f"re-shared); cost choices swap/recompute {st['cost_swap_choices']}/"
              f"{st['cost_recompute_choices']}; prefix-hit tokens {st['prefix_hit_tokens']}, "
              f"host-hit tokens {st['host_hit_tokens']}; host store {hs}", flush=True)
        if "d2h_gb_s" in figures[name]:
            f = figures[name]
            print(f"[host tier] {name}: a {f['copy_chain_blocks']}-block chain "
                  f"({f['copy_chain_bytes'] / 2**20:.2f} MiB) device->host {f['d2h_gb_s']:.2f} "
                  f"GB/s (gather + pinned copy), host->device {f['h2d_gb_s']:.2f} GB/s (pinned "
                  f"staging + copy + scatter), CUDA events, median of 5", flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # swap repays no prefill: fewer prefill tokens than recompute on the same pool
    assert figures["swap"]["prefill_tokens"] < figures["recompute"]["prefill_tokens"], figures
    return launches, figures


# ---------------------------------------------------------------------------
# phase 6: RAG requests at full width
# ---------------------------------------------------------------------------


def phase_rag(ka, kf, tk, cfg, params, corpus, queries):
    """Index the (N_DOCS, DIM) ``corpus`` (numpy) on the card, read recall@10
    at three probe counts, and serve 8 retrieval-augmented requests on
    ``cfg`` (qwen2.5-3b bf16). Returns the five kernels' launches."""
    from repro_torch.core.components import Augmenter, Reranker, Retriever
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.retrieval import DocTokenStore, VectorIndex, recall_at_k

    reset_launches(ka, kf, tk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = VectorIndex.build(corpus, n_clusters=N_CLUSTERS, seed=0, device="cuda")
    torch.cuda.synchronize()
    sizes = torch.bincount(index.cluster_of, minlength=N_CLUSTERS)
    print(f"[rag] VectorIndex.build of {index.size} x {index.embeddings.shape[1]} "
          f"float32 passages, {N_CLUSTERS} clusters (k-means, 8 Lloyd iterations) in "
          f"{time.perf_counter() - t0:.2f}s; index {index.nbytes() / 2**30:.2f} GiB on "
          f"the card; cluster sizes {int(sizes.min())}-{int(sizes.max())}", flush=True)
    recalls = {}
    for n_probe in (1, 8, 32):
        t0 = time.perf_counter()
        recalls[n_probe] = recall_at_k(index, queries, 10, n_probe)
        torch.cuda.synchronize()
        assert 0.0 <= recalls[n_probe] <= 1.0
        print(f"[rag] recall@10 over {len(queries)} queries at n_probe={n_probe}: "
              f"{recalls[n_probe]:.4f} (IVF + exact search in "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms)", flush=True)
    assert recalls[32] >= recalls[1], recalls

    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8,
                           max_seq=2048, block_size=16, prefill_chunk_size=256)
    store = DocTokenStore(vocab=cfg.vocab_size, doc_len=256)
    retriever, reranker, augmenter = Retriever(index, n_probe=8), Reranker(), Augmenter()
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab_size, 32)
    texts = [f"rag query {i}" for i in range(4)]
    text_tokens = {t: rng.integers(0, cfg.vocab_size, 24) for t in texts}
    reqs, retrieve_ms = [], []
    t_all = time.perf_counter()
    # two waves: four fresh queries, then the same four texts with other
    # user tails, whose documents' KV blocks are then in the pool
    for wave in range(2):
        for text in texts:
            t0 = time.perf_counter()
            docs = retriever.retrieve(text, k=100)
            retrieve_ms.append(1e3 * (time.perf_counter() - t0))
            assert len(docs) == 100 and len(set(docs)) == 100 and min(docs) >= 0
            top = reranker.rerank(text, docs, top_n=4)
            tail = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 17)))
            prompt = augmenter.build_prompt(np.concatenate([text_tokens[text], tail]),
                                            top, store, system)
            reqs.append(eng.submit(prompt, max_new=32))
        eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = read_launches(ka, kf, tk)
    st = eng.stats()
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["prefix_hit_tokens"] > 0 and pool_is_clean(eng), st
    assert all(launches[n] > 0 for n in (*PAGED, "topk_retrieval")), launches
    assert all(launches[n] == 0 for n in (*DENSE, "rwkv6_chunked", "ssm_scan")), launches
    print(f"[rag] 8 requests (prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens: system + 4 reranked docs of 256 + "
          f"query) through Retriever(n_probe=8, k=100) -> Reranker(top 4) -> Augmenter -> "
          f"{cfg.name} {cfg.dtype}: {st['tokens_out']} tokens out in {wall:.3f}s wall; "
          f"retrieve {np.mean(retrieve_ms):.1f} ms mean per query; prefix-hit tokens "
          f"{st['prefix_hit_tokens']}; {st['steps']} steps; launches {launches}", flush=True)
    del eng, index
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: the open-loop pipelines at full width
# ---------------------------------------------------------------------------

APP_MIX = ("vrag", "crag", "srag", "planrag")   # benchmarks/slo_violations.py


def phase_pipelines(ka, kf, tk, cfg, params):
    from repro_torch.launch.serve import serve_pipelines

    torch.cuda.reset_peak_memory_stats()
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    drv = serve_pipelines(cfg.name, 4.0, 5.0, arrival="poisson", session_fraction=0.3,
                          device="cuda", params=params, dtype=cfg.dtype, apps=APP_MIX,
                          max_batch=8, max_seq=2048, prefill_chunk_size=256,
                          token_budget=None, doc_len=256, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    eng = drv.engine
    st = eng.stats()
    summary = drv.violation_summary()
    assert len(drv.records) == len(drv.events) > 0, (len(drv.records), len(drv.events))
    assert set(summary) == set(APP_MIX), summary
    assert all(np.isfinite(c["violation_rate"]) and 0 <= c["violation_rate"] <= 1
               for c in summary.values()), summary
    assert st["session_shared_tokens"] > 0 and pool_is_clean(eng), st
    assert st["kernel"] == "cuda" and launches["paged_chunk_attention"] > 0, launches
    assert all(launches[n] == 0 for n in (*DENSE, "rwkv6_chunked", "ssm_scan")), launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[pipelines] {cfg.name} {cfg.dtype}: {len(drv.events)} events "
          f"({sum(e.session_id >= 0 for e in drv.events)} session turns) all completed; "
          f"{len(eng.finished)} engine requests, {st['tokens_out']} tokens out; "
          f"violation_summary {json.dumps(summary)}; session-shared tokens "
          f"{st['session_shared_tokens']}; prefix-hit tokens {st['prefix_hit_tokens']}; "
          f"{st['steps']} steps; {wall:.2f}s wall; peak memory {peak:.2f} GiB; "
          f"launches {launches}", flush=True)
    print(f"[pipelines] host tier ({eng.host_store.n_blocks} blocks, the reference "
          f"launcher's): host-hit tokens {st['host_hit_tokens']}, session host-hit tokens "
          f"{st['session_hit_tokens']}; host_store {json.dumps(st['host_store'])}", flush=True)
    assert eng.host_store.n_blocks == 128 and st["host_store"]["n_swapped"] == 0, st
    del drv, eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7b: the control plane, calibrated against the paged engine
# ---------------------------------------------------------------------------

CONTROL_APPS = ("vrag", "crag", "srag", "arag")   # benchmarks/common.py APP_NAMES
CONTROL_BUDGETS = {"GPU": 32, "CPU": 256, "RAM": 1024}
DRAIN_S = 3600.0
COEFFS = ("prefill_per_token_s", "ttft_per_prefill_token_s", "decode_per_token_s",
          "decode_cache_per_ctx_token_s", "prefix_hit_rate")


def calibrated_app(name, coeffs):
    """``make_app(name)`` with every Generator-class component (Grader,
    Rewriter and Critic too) calibrated with ``coeffs`` (None: defaults)."""
    from repro_torch.apps import make_app
    from repro_torch.core.components import Generator

    app = make_app(name)
    for comp in app.components.values():
        if coeffs is not None and isinstance(comp, Generator):
            comp.calibrate(coeffs)
    return app


def runtime(name, coeffs, engine, slo_s=None):
    """``PatchworkRuntime`` of ``calibrated_app(name, coeffs)`` on the
    simulated cluster, seed 0. Python's ``random``, which WebSearch's jitter
    draws from (in profiling and in service times), is reseeded to 0 so the
    run repeats."""
    import random

    from repro_torch.core.controller import PatchworkRuntime

    random.seed(0)
    return PatchworkRuntime(calibrated_app(name, coeffs), CONTROL_BUDGETS, engine=engine,
                            slo_s=slo_s, seed=0)


def plan_and_serve(card):
    """For each of the paper's four apps: the LP plan under the default and
    the ``card`` coefficients, the SLO (``slo_multiplier`` x the mean
    latency of a Patchwork run at 0.1x the card plan's throughput for 15
    trace-seconds, as benchmarks/common.py sets it), and Patchwork,
    monolithic and Ray-like runs at 0.8x that throughput for 30
    trace-seconds (three re-plans at the 10 s period in the window), each
    run until all it was offered has completed. Host work only: no device.
    Returns the figures."""
    from repro_torch.core.controller import MONOLITHIC, PATCHWORK, RAY_LIKE
    from repro_torch.data.workload import make_workload

    out = {}
    for name in CONTROL_APPS:
        t0 = time.perf_counter()
        plans = {}
        for which, co in (("default", None), ("card", card)):
            p = runtime(name, co, PATCHWORK).plan
            assert p.status == "optimal", (name, which, p.status)
            plans[which] = {"instances": p.instances, "throughput": p.throughput,
                            "solve_time_s": p.solve_time_s}
            print(f"[controller] {name} plan ({which} coefficients): instances "
                  f"{p.instances}, throughput {p.throughput:.4f} req/s, solve "
                  f"{1e3 * p.solve_time_s:.2f} ms", flush=True)
        thr = plans["card"]["throughput"]
        low = runtime(name, card, PATCHWORK).run(make_workload(0.1 * thr, 15.0, seed=0))
        slo = PATCHWORK.slo_multiplier * (float(np.mean(low.latencies)) if low.latencies
                                          else 0.5)
        runs = {}
        for engine in (PATCHWORK, MONOLITHIC, RAY_LIKE):
            # the horizon runs DRAIN_S past the window (the runtime's default:
            # 120 s) so the slower engines finish what they were offered
            m = runtime(name, card, engine, slo).run(make_workload(0.8 * thr, 30.0, seed=0),
                                                     duration_s=30.0 + DRAIN_S)
            assert m.completed == m.offered > 0, (name, engine.name, m.completed, m.offered)
            r = runs[engine.name] = {
                "completed": m.completed, "offered": m.offered, "throughput": m.throughput,
                "goodput": m.goodput, "p50_s": m.latency_pct(50), "p99_s": m.latency_pct(99),
                "slo_violation_rate": m.slo_violation_rate,
                "realloc_events": m.realloc_events, "instance_counts": m.instance_counts,
                "decision_ms": 1e3 * float(np.mean(m.controller_overhead_s))}
            print(f"[controller] {name} {engine.name} at {0.8 * thr:.4f} req/s for 30 "
                  f"trace-s (SLO {slo:.3f}s): {m.completed}/{m.offered} completed, "
                  f"throughput {m.throughput:.4f}/s, goodput {m.goodput:.4f}/s, p50 "
                  f"{r['p50_s']:.3f}s, p99 {r['p99_s']:.3f}s, SLO violations "
                  f"{100 * m.slo_violation_rate:.1f}%, plan changes applied {m.realloc_events}, "
                  f"instances {m.instance_counts}, decision {r['decision_ms']:.4f} ms",
                  flush=True)
        out[name] = {"plans": plans, "slo_s": slo, "runs": runs,
                     "wall_s": time.perf_counter() - t0}
    return out


def phase_controller(ka, kf, tk, cfg, params):
    """Calibrate the Generator cost model against the paged engine on the
    card (bf16 and int8 pools), profile the vrag generator by real
    execution, then plan and serve the paper's four apps on the simulated
    cluster under the default and the card's coefficients. Returns the
    launches and the figures."""
    import scipy

    from repro_torch.apps import make_app
    from repro_torch.core.components import Generator
    from repro_torch.core.profiling import calibrate_generator_from_engine, profile_components
    from repro_torch.data.workload import sample_request_features
    from repro_torch.serving.engine import GenerationEngine

    print(f"[controller] scipy {scipy.__version__} (solve_allocation's linprog, HiGHS)",
          flush=True)
    gc.collect()                     # earlier phases' engines hold reference cycles
    reset_launches(ka, kf, tk)
    fp_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    figures = {"scipy": scipy.__version__, "calibration": {}}
    coeffs = {}
    for kv_dtype in (None, "int8"):
        label = kv_dtype or cfg.dtype
        t0 = time.perf_counter()
        eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=2048,
                               block_size=16, prefill_chunk_size=256, kv_dtype=kv_dtype)
        eng.warmup_step_variants()
        gen = Generator(engine=eng)
        t1 = time.perf_counter()
        c = calibrate_generator_from_engine(gen, eng, prefill_len=1024, decode_tokens=32,
                                            long_ctx=1536)
        # the fit times a host-bound step loop: its mean step wall says how
        # fast the host ran while it measured
        step_ms = 1e3 * (time.perf_counter() - t1) / eng.stats()["steps"]
        wall = time.perf_counter() - t0
        # int8: one byte a value plus the (n_blocks, KVH) f32 scales of K and
        # V amortized over a 16-token block
        want = (fp_bytes // 2 + 2 * cfg.num_layers * cfg.num_kv_heads * 4 / 16 if kv_dtype
                else fp_bytes)
        assert c["kv_bytes_per_token"] == want, (label, c["kv_bytes_per_token"], want)
        assert c["baseline_kv_bytes_per_token"] == fp_bytes, c
        scale = gen.kv_capacity_scale()
        assert scale == (fp_bytes / want), scale
        assert all(c[k] > 0 for k in ("prefill_per_token_s", "ttft_per_prefill_token_s",
                                      "decode_per_token_s")), c
        assert pool_is_clean(eng)
        for k in COEFFS:
            print(f"[controller] {label} pools: {k} {c[k]!r} (class default "
                  f"{getattr(Generator, k)!r}; x{c[k] / getattr(Generator, k):.4g})"
                  if getattr(Generator, k) else
                  f"[controller] {label} pools: {k} {c[k]!r} (class default "
                  f"{getattr(Generator, k)!r})", flush=True)
        print(f"[controller] {label} pools: kv_bytes_per_token {c['kv_bytes_per_token']!r}, "
              f"baseline_kv_bytes_per_token {c['baseline_kv_bytes_per_token']!r}, "
              f"kv_capacity_scale {scale:.5f}; {len(eng.finished)} calibration requests, "
              f"{eng.stats()['steps']} steps, {step_ms:.2f} ms a step; {wall:.1f}s wall "
              f"(engine, warmup and fit)", flush=True)
        figures["calibration"][label] = {**c, "kv_capacity_scale": scale,
                                         "step_ms": step_ms, "wall_s": wall}
        coeffs[label] = c
        if kv_dtype is None:
            bf16_eng = eng
        else:
            del eng
    assert round(figures["calibration"]["int8"]["kv_capacity_scale"], 5) == 1.99610
    card = {k: coeffs[cfg.dtype][k] for k in COEFFS}

    # real-execution profiling of vrag's generator on the bf16 engine, beside
    # the card-calibrated cost model on the same 8 feature draws (cold), on
    # the draws as drawn and as _profile_run caps them (prompt <= max_seq/2,
    # at most 64 new tokens)
    t0 = time.perf_counter()
    app = make_app("vrag", engine=bf16_eng)
    gen = app.components["VGenerator"]
    gen.calibrate(coeffs[cfg.dtype])
    rng = np.random.default_rng(0)
    draws = [sample_request_features(rng) for _ in range(8)]
    capped = []
    for f in draws:
        n = max(int(min(f["tokens_in"], bf16_eng.max_seq // 2)), 4)
        out = max(int(min(f["tokens_out"], max(bf16_eng.max_seq - n - 1, 1), 64)), 1)
        capped.append({**f, "tokens_in": float(n), "tokens_out": float(out)})
    model = float(np.mean([gen.estimate_time(f, hit_rate=0.0, host_hit_rate=0.0)
                           for f in draws]))
    model_capped = float(np.mean([gen.estimate_time(f, hit_rate=0.0, host_hit_rate=0.0)
                                  for f in capped]))
    n_before = len(bf16_eng.finished)
    profile_components({"VGenerator": gen}, n_samples=8, real_execution=True)
    meta = gen.meta
    assert len(bf16_eng.finished) == n_before + 8 and pool_is_clean(bf16_eng)
    real = {"alpha": meta.alpha, "mean_service_s": meta.mean_service_s,
            "alpha_hit_rate": meta.alpha_hit_rate, "model_mean_s": model,
            "model_capped_mean_s": model_capped,
            "real_over_model_capped": meta.mean_service_s / model_capped,
            "wall_s": time.perf_counter() - t0}
    figures["real_execution"] = real
    print(f"[controller] profile_components(real_execution) of vrag's VGenerator, 8 draws: "
          f"alpha {meta.alpha} (mean_service_s {meta.mean_service_s:.4f}, baked hit rate "
          f"{meta.alpha_hit_rate:.3f}); card-calibrated estimate_time (cold) on the same "
          f"draws {model:.4f}s, on the draws as run (capped) {model_capped:.4f}s: measured "
          f"/ model {real['real_over_model_capped']:.3f}; {real['wall_s']:.1f}s wall",
          flush=True)
    del app, gen, bf16_eng
    torch.cuda.empty_cache()
    figures["apps"] = plan_and_serve(card)
    launches = read_launches(ka, kf, tk)
    assert all(launches[n] > 0 for n in PAGED), launches
    assert all(launches[n] == 0 for n in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                          "ssm_scan")), launches
    print(f"[controller] launches in the phase: {launches}", flush=True)
    return launches, figures


# ---------------------------------------------------------------------------
# phase 8: serve rwkv6-7b at full width
# ---------------------------------------------------------------------------


def phase_rwkv_serve(ka, kf, tk, prompts):
    """Serve phase 5's prompts (flattened, tokens modulo the vocab) on
    rwkv6-7b in bfloat16 with random weights from seed 0, through
    ``backend="paged"``, which falls back to the dense backend. Returns the
    six kernels' launches in the run."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, prefill
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    cfg = get_arch("rwkv6-7b").replace(dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(x.numel() for x in _tensors(params))
    torch.cuda.synchronize()
    print(f"[rwkv serve] {cfg.name} {cfg.dtype}: {n_params / 1e9:.3f}B parameters "
          f"({sum(x.numel() * x.element_size() for x in _tensors(params)) / 2**30:.2f} GiB) "
          f"drawn on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", backend="paged",
                           max_batch=8, max_seq=2048)
    assert eng.backend == "dense", eng.backend
    resident = torch.cuda.memory_allocated() / 2**30
    flat = [np.asarray(p.tokens if isinstance(p, SegmentedPrompt) else p) % cfg.vocab_size
            for p in prompts]
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in flat]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    st, lat = eng.stats(), eng.latency_summary()
    assert st["backend"] == "dense" and st["kernel"] == "cuda", st
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["prefill_tokens"] == sum(len(p) for p in flat), st   # unpadded prefills
    want = {n: 0 for n in launches}
    want["rwkv6_chunked"] = cfg.num_layers * (len(reqs) + st["steps"])
    assert launches == want, (launches, want, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = eng.cache[0]["state"]
    print(f"[rwkv serve] {len(reqs)} requests (prompts {min(map(len, flat))}-"
          f"{max(map(len, flat))} tokens), {st['tokens_out']} tokens out in {wall:.3f}s = "
          f"{st['tokens_out'] / wall:.1f} tok/s (prefill tokens {st['prefill_tokens']}, "
          f"unpadded); mean TTFT {1e3 * lat['ttft_mean']:.1f}ms, p95 TPOT "
          f"{1e3 * lat.get('tpot_p95', 0):.2f}ms; {st['steps']} decode steps; peak memory "
          f"{peak:.2f} GiB ({resident:.2f} GiB resident before serving, state cache "
          f"{state.numel() * 4 / 2**30:.3f} GiB of it); launches "
          f"{launches} ({cfg.num_layers} x ({len(reqs)} prefills + {st['steps']} decode "
          f"steps))", flush=True)
    # where a decode step's time goes: 8 fresh 300-token requests admitted
    # (and prefilled) in one step, then three decode steps of 8 rows
    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new=40)
    eng.step()
    kinds, wall_ms, dev_ms, n_launch = step_profile(eng, 3)
    assert set(kinds) == {"dense"} and not eng.waiting, kinds
    eng.run_until_done()
    print(f"[rwkv serve] decode step (8 rows): wall {wall_ms:.2f} ms (mean of 3, profiler off); "
          f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches (torch.profiler, "
          f"mean of 3)", flush=True)
    # the full-width stack gives finite logits of the expected shape, and
    # the engine's first token is the greedy token of the unpadded prefill
    toks = torch.as_tensor(flat[0], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        last, cache = prefill(cfg, params, {"tokens": toks[None]})
    hd = cfg.rwkv_head_dim
    assert tuple(last.shape) == (1, cfg.padded_vocab)
    assert tuple(cache[0]["state"].shape) == (cfg.num_layers, 1, cfg.d_model // hd, hd, hd)
    assert bool(torch.isfinite(last.float()).all())
    assert bool(torch.isfinite(cache[0]["state"]).all())
    assert int(last[0].float().argmax()) == reqs[0].out_tokens[0], (
        int(last[0].float().argmax()), reqs[0].out_tokens[0])
    del eng, params, cache
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9: serve hymba-1.5b at full width
# ---------------------------------------------------------------------------


def phase_hymba_serve(ka, kf, tk, prompts):
    """Serve phase 5's prompts (flattened, tokens modulo the vocab) on
    hymba-1.5b in bfloat16 with random weights from seed 0, through
    ``backend="paged"``, which falls back to the dense backend. Returns the
    seven kernels' launches in the run."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, prefill
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    cfg = get_arch("hymba-1.5b").replace(dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(x.numel() for x in _tensors(params))
    torch.cuda.synchronize()
    print(f"[hymba serve] {cfg.name} {cfg.dtype}: {n_params / 1e9:.3f}B parameters "
          f"({sum(x.numel() * x.element_size() for x in _tensors(params)) / 2**30:.2f} GiB) "
          f"drawn on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", backend="paged",
                           max_batch=8, max_seq=2048)
    assert eng.backend == "dense", eng.backend
    resident = torch.cuda.memory_allocated() / 2**30
    cache_gib = sum(x.numel() * x.element_size() for x in eng.cache[0].values()) / 2**30
    flat = [np.asarray(p.tokens if isinstance(p, SegmentedPrompt) else p) % cfg.vocab_size
            for p in prompts]
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in flat]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    st, lat = eng.stats(), eng.latency_summary()
    assert st["backend"] == "dense" and st["kernel"] == "cuda", st
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["prefill_tokens"] == sum(len(p) for p in flat), st   # unpadded prefills
    want = {n: 0 for n in launches}
    want["ssm_scan"] = cfg.num_layers * (len(reqs) + st["steps"])
    want["flash_attention"] = cfg.num_layers * len(reqs)
    want["decode_attention"] = cfg.num_layers * st["steps"]
    assert launches == want, (launches, want, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[hymba serve] {len(reqs)} requests (prompts {min(map(len, flat))}-"
          f"{max(map(len, flat))} tokens + {cfg.num_meta_tokens} meta), {st['tokens_out']} "
          f"tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} tok/s (prefill tokens "
          f"{st['prefill_tokens']}, unpadded); mean TTFT {1e3 * lat['ttft_mean']:.1f}ms, p95 "
          f"TPOT {1e3 * lat.get('tpot_p95', 0):.2f}ms; {st['steps']} decode steps; peak memory "
          f"{peak:.2f} GiB ({resident:.2f} GiB resident before serving, cache {cache_gib:.3f} "
          f"GiB of it: {eng.cache[0]['k'].shape[2]}-slot K/V rings and the SSM state); launches "
          f"{launches} (ssm_scan {cfg.num_layers} x ({len(reqs)} prefills + {st['steps']} "
          f"decode steps), flash {cfg.num_layers} x {len(reqs)}, decode {cfg.num_layers} x "
          f"{st['steps']})", flush=True)
    # where a decode step's time goes: 8 fresh 300-token requests admitted
    # (and prefilled) in one step, then three decode steps of 8 rows
    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new=40)
    eng.step()
    kinds, wall_ms, dev_ms, n_launch = step_profile(eng, 3)
    assert set(kinds) == {"dense"} and not eng.waiting, kinds
    eng.run_until_done()
    print(f"[hymba serve] decode step (8 rows): wall {wall_ms:.2f} ms (mean of 3, profiler off); "
          f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches (torch.profiler, "
          f"mean of 3)", flush=True)
    # the full-width stack gives finite logits of the expected shape, and
    # the engine's first token is the greedy token of the unpadded prefill
    toks = torch.as_tensor(flat[0], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        last, cache = prefill(cfg, params, {"tokens": toks[None]})
    total = cfg.num_meta_tokens + len(flat[0])
    assert tuple(last.shape) == (1, cfg.padded_vocab)
    assert tuple(cache[0]["k"].shape) == (cfg.num_layers, 1, min(total, cfg.window),
                                          cfg.num_kv_heads, cfg.head_dim)
    assert tuple(cache[0]["h"].shape) == (cfg.num_layers, 1, cfg.d_model, cfg.ssm_state)
    assert bool(torch.isfinite(last[:, :cfg.vocab_size].float()).all())
    assert bool(torch.isfinite(cache[0]["h"]).all())
    assert int(last[0].float().argmax()) == reqs[0].out_tokens[0], (
        int(last[0].float().argmax()), reqs[0].out_tokens[0])
    del eng, params, cache
    torch.cuda.empty_cache()
    return launches


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def timed(name, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s wall", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.data.workload import synthetic_corpus
    from repro_torch.kernels import decode_attention as ka
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.kernels import topk_retrieval as tk
    from repro_torch.kernels._build import build_all
    from repro_torch.models import init_params

    t_start = time.perf_counter()
    card = card_line()
    print(f"[device] {card} | torch.cuda.get_device_name: {torch.cuda.get_device_name(0)} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = build_all()
    print(f"[build] {len(libs)} sources in parallel in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for lib in libs.values():
        regs = sorted({ln.strip() for ln in lib.ptxas.splitlines() if "registers" in ln})
        print(f"[build] {lib.source.relative_to(ROOT)} -> {lib.path.name} in "
              f"{lib.build_s:.2f}s; ptxas: {regs}", flush=True)

    def no_scan(name, fn, *args):
        """A phase of an earlier slice: it must launch no selective scan."""
        ks.reset_launch_counts()
        out = timed(name, fn, *args)
        assert ks.ssm_scan.launches == 0, (name, ks.ssm_scan.launches)
        return out

    rows = no_scan("paged attention kernels", phase_kernels, ka)
    dense_rows = no_scan("dense attention kernels", phase_dense_kernels, ka, kf)
    wkv_rows = no_scan("rwkv6 wkv kernel", phase_wkv_kernel, kw)
    ssm_rows = timed("ssm scan kernel", phase_ssm_kernel, ks)
    swa_rows = no_scan("windowed flash kernel", phase_swa_kernels, kf)
    swa_decode_rows = no_scan("hymba decode kernel", phase_swa_decode_kernel, ka)
    # the queries are drawn as benchmarks/retrieval_knob.py draws them
    corpus, queries = no_scan("synthetic_corpus on the host", lambda: (
        synthetic_corpus(N_DOCS, DIM, seed=0), synthetic_corpus(N_QUERIES, DIM, seed=7)))
    corpus_gpu, queries_gpu = torch.from_numpy(corpus).cuda(), torch.from_numpy(queries).cuda()
    topk_rows = no_scan("top-k kernel", phase_topk, tk, corpus_gpu, queries_gpu)
    del corpus_gpu
    torch.cuda.empty_cache()
    no_scan("engine parity", phase_parity)
    no_scan("pipeline parity", phase_pipeline_parity)
    no_scan("dense parity", phase_dense_parity, ka, kf, kw)
    no_scan("rwkv parity", phase_rwkv_parity, kw)
    timed("hymba parity", phase_hymba_parity, ka, kf, ks)
    no_scan("int8 and swap parity", phase_int8_swap_parity)

    cfg = get_arch("qwen2.5-3b").replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    serve_launches, prompts, paged_tokens, bf16_pool = no_scan("serve", phase_serve, ka, kf,
                                                               tk, cfg, params)
    launches = {"serve": serve_launches}
    launches["int8 serve"], int8_figures = no_scan(
        "int8 serve", phase_int8_serve, ka, kf, tk, cfg, params, prompts, paged_tokens,
        bf16_pool)
    launches["host tier"], host_figures = no_scan("host tier", phase_host_tier, ka, kf, tk,
                                                  cfg, params, prompts)
    launches["dense serve"] = no_scan("dense serve", phase_dense_serve, ka, kf, tk, cfg, params,
                                      prompts, paged_tokens)
    launches["rag"] = no_scan("rag", phase_rag, ka, kf, tk, cfg, params, corpus, queries_gpu)
    launches["pipelines"] = no_scan("pipelines", phase_pipelines, ka, kf, tk, cfg, params)
    launches["controller"], controller_figures = no_scan("controller", phase_controller, ka,
                                                         kf, tk, cfg, params)
    del params                       # room for rwkv6-7b's ~15 GB of bf16 weights
    gc.collect()                     # engines hold reference cycles
    torch.cuda.empty_cache()
    launches["rwkv serve"] = no_scan("rwkv serve", phase_rwkv_serve, ka, kf, tk, prompts)
    gc.collect()                     # rwkv6-7b's weights go before hymba-1.5b's
    torch.cuda.empty_cache()
    launches["hymba serve"] = timed("hymba serve", phase_hymba_serve, ka, kf, tk, prompts)

    kernels = []
    for name in ("paged_chunk_attention", "paged_decode_attention"):
        r = rows[(name, "bfloat16")]     # the dtype the serve phase runs
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches["serve"][name],
            "max_abs_err": r["errs"]["plain"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # every check of every dtype: {dtype: {check: max abs err}}
            "max_abs_err_by_check": {d: rows[(name, d)]["errs"]
                                     for d in ("float32", "bfloat16", "int8")},
            **({"split_edges": {d: rows[(name, d)]["split_edges"]
                                for d in ("float32", "bfloat16", "int8")}}
               if name == "paged_decode_attention" else {}),
            "launches_by_phase": {ph: n[name] for ph, n in launches.items()},
            # the kernel on the engine's int8 pools: device ms a step of
            # both paged kernels inside the int8 serve's step profile
            "int8_serve_step_ms": {
                step: int8_figures["step_profile"][step]["paged_attention_ms"]
                for step in ("mixed", "decode-only")},
        })
    # the chunk kernel at the engine's mixed step
    chunk = next(k for k in kernels if k["name"] == "paged_chunk_attention")
    chunk["mixed_step"] = {
        "shape": {"lengths": MIXED_LENGTHS, "chunks": MIXED_CHUNKS, "pads": MIXED_PAD},
        **{d: {key2: rows[("paged_chunk_attention", d, "mixed_step")].get(key2)
               for key2 in ("errs", "ms", "device_ms", "device_ms_bf16_q", "plain_ms",
                            "library_ms", "bound_ms", "bound_by")}
           for d in ("float32", "bfloat16", "int8")},
    }
    # the RAG phase's shape: float32 index, B=32, k=10 (recall_at_k)
    r = topk_rows[("float32", 10)]
    kernels.append({
        "name": "topk_retrieval", "route": "cuda", "source": SOURCES["topk_retrieval"],
        "replaces": REPLACES["topk_retrieval"], "launches": launches["rag"]["topk_retrieval"],
        "max_abs_err": max(x["max_abs_err"] for x in topk_rows.values()), "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "by_case": {f"{c}/k={k}": {key: x.get(key) for key in
                                   ("max_abs_err", "swapped", "ms", "device_ms", "plain_ms",
                                    "library_ms", "library", "bound_ms", "bound_by",
                                    "products")}
                    for (c, k), x in topk_rows.items()},
        "launches_by_phase": {ph: n["topk_retrieval"] for ph, n in launches.items()},
    })
    # the dense serve phase's shapes in bf16: flash at S=2048 causal (its
    # largest bucket), decode over the phase-2 lengths
    for name, key in (("flash_attention", (FLASH_S[-1], True)), ("decode_attention", ("lengths",))):
        r = dense_rows[(name, "bfloat16", *key)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches["dense serve"][name],
            "max_abs_err": r["errs"]["plain"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "max_abs_err_by_case": {"/".join(map(str, k[1:])): x["errs"]
                                    for k, x in dense_rows.items() if k[0] == name},
            "float32": {key2: dense_rows[(name, "float32", *key)][key2]
                        for key2 in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
            **({"mixed_step": {d: {key2: dense_rows[(name, d, "mixed_step")][key2]
                                   for key2 in ("ms", "device_ms", "plain_ms", "library_ms",
                                                "bound_ms", "bound_by")}
                               for d in ("float32", "bfloat16")}}
               if name == "decode_attention" else {}),
            "launches_by_phase": {ph: n[name] for ph, n in launches.items()},
        })
    # the rwkv serve phase's shapes in bf16: prefill at S=2048 (the longest
    # prompt the engine admits), and a decode step at B=8
    r = wkv_rows[("bfloat16", "prefill", 2048)]
    kernels.append({
        "name": "rwkv6_chunked", "route": "cuda", "source": SOURCES["rwkv6_chunked"],
        "replaces": REPLACES["rwkv6_chunked"], "launches": launches["rwkv serve"]["rwkv6_chunked"],
        "max_abs_err": r["errs"]["plain"], "ms": r["ms"], "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes the WKV recurrence",
        "segments": r["segments"],
        "max_abs_err_by_case": {f"{d}/{c}/S={S}": x["errs"]["plain"]
                                for (d, c, S), x in wkv_rows.items()},
        "decode": {key2: wkv_rows[("bfloat16", "decode", 1)][key2]
                   for key2 in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "float32": {key2: wkv_rows[("float32", "prefill", 2048)][key2]
                    for key2 in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "launches_by_phase": {ph: n["rwkv6_chunked"] for ph, n in launches.items()},
    })
    # the hymba serve phase's shapes in bf16: prefill at S=1664 (128 meta +
    # the longest prompt, 1536 tokens), and a decode step at B=8
    r = ssm_rows[("bfloat16", "prefill", 1664)]
    kernels.append({
        "name": "ssm_scan", "route": "cuda", "source": SOURCES["ssm_scan"],
        "replaces": REPLACES["ssm_scan"], "launches": launches["hymba serve"]["ssm_scan"],
        "max_abs_err": r["errs"]["plain"], "ms": r["ms"], "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes the selective scan",
        "segments": r["segments"],
        "bound_parts_ms": {"bytes": r["bytes"] / HBM_BYTES_S * 1e3, "flops": r["flop_ms"],
                           "exponentials": r["exp_ms"]},
        "max_abs_err_by_case": {f"{d}/{c}/S={S}": x["errs"] for (d, c, S), x in ssm_rows.items()},
        "decode": {key2: ssm_rows[("bfloat16", "decode", 1)][key2]
                   for key2 in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "float32": {key2: ssm_rows[("float32", "prefill", 1664)][key2]
                    for key2 in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "launches_by_phase": {ph: n["ssm_scan"] for ph, n in launches.items()},
    })
    # the flash kernel's windowed case (hymba serve: S up to 1664, window 1024)
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash["window"] = {
        "max_abs_err_by_case": {f"{d}/S={S}/window={w}": x["errs"]
                                for (d, S, w), x in swa_rows.items()},
        **{d: {key2: swa_rows[(d, *SWA_CASES[0])][key2]
               for key2 in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
           for d in ("float32", "bfloat16")},
    }
    # the decode kernel at the hymba serve phase's shapes
    dec = next(k for k in kernels if k["name"] == "decode_attention")
    dec["hymba"] = {
        "shape": {"B": B, "H": SWA_H, "KVH": SWA_KVH, "hd": SWA_HD,
                  "Sc": SWA_SC, "lengths": SWA_DECODE_CASES},
        **{f"{d}/{c}": {key2: swa_decode_rows[(d, c)][key2]
                        for key2 in ("errs", "ms", "device_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
           for d in ("float32", "bfloat16") for c in SWA_DECODE_CASES},
    }
    print(json.dumps({"int8_serve": int8_figures, "host_tier": host_figures,
                      "controller": controller_figures}))
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s in all", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
