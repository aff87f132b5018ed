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
   ``TOL``); then times (CUDA events, L2 flushed between launches, median
   of 30) of the kernel, its plain version and one PyTorch SDPA call on the
   gathered view, beside the bound the card could reach.
3. The top-k retrieval kernel against its plain version at B=32 queries,
   N=2^21 docs, d=768, k in {10, 100}: float32 docs (the corpus the index is
   built from), bfloat16 docs, and integer-valued docs with duplicated rows
   (exact ties; tolerances in ``TOPK_TOL``); then the kernel's, the plain
   version's and ``torch.topk(q @ docs.T, k)``'s times beside the bound.
4. Engine parity at smoke width: the same greedy RAG workload on the CPU
   (plain versions) and on the GPU (kernels) gives identical tokens; then
   the same seeded open-loop pipeline trace (vrag + crag, sessions) gives
   identical driver records and tokens on both.
5. Serve qwen2.5-3b at full width in bfloat16: 10 requests, 128-1536-token
   prompts, half sharing a 512-token document prefix, one segmented prompt,
   32 new tokens each, with both attention kernels' launch counts read
   around the run.
6. RAG requests at full width: a ``VectorIndex`` of 2^21 synthetic 768-d
   passages with 1024 clusters built on the card; recall@10 at n_probe 1,
   8 and 32 (the exact side runs the top-k kernel); 8 queries through
   Retriever -> Reranker -> Augmenter -> the qwen2.5-3b engine, half of
   them repeating an earlier query's text, with all three kernels' launch
   counts read around the phase.
7. The open-loop pipelines at full width: ``serve_pipelines`` on
   qwen2.5-3b bfloat16 replays a Poisson trace (4 requests/s for 5
   trace-seconds, 30% sessions) of vrag/crag/srag/planrag with EDF-slack
   priorities; every event must complete.

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
    "topk_retrieval": "src/repro/kernels/topk_retrieval.py:51",
}
SOURCES = {
    "paged_chunk_attention": "src/repro_torch/csrc/paged_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_attention.cu",
    "topk_retrieval": "src/repro_torch/csrc/topk_retrieval.cu",
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
    """(bytes, flops): docs and queries read once, (B, k) scores and ids
    written once; 2*B*N*d float32 flops."""
    B, d = q.shape
    nbytes = docs.numel() * docs.element_size() + q.numel() * 4 + B * k * 8
    return nbytes, 2 * B * docs.shape[0] * d


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
                nbytes, ops = topk_work(q, docs, k)
                bytes_ms = nbytes / HBM_BYTES_S * 1e3
                ops_ms = ops / PEAK_OPS_S["float32"] * 1e3
                lib = ((lambda: torch.topk(q @ docs.T, k)) if docs.dtype == torch.float32
                       else None)
                r.update({
                    "ms": time_ms(lambda: tk.topk_retrieval(q, docs, k), flush),
                    "plain_ms": time_ms(lambda: tk.ref_topk_retrieval(q, docs, k), flush,
                                        reps=10),
                    "library_ms": time_ms(lib, flush, reps=10) if lib is not None else None,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "bytes": nbytes, "ops": ops,
                })
            rows[(case, k)] = r
            times = (f"; kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                     f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.4f} "
                     f"({r['bound_by']}: {r['bytes']} B, {r['ops']} flop)") if "ms" in r else ""
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


# ---------------------------------------------------------------------------
# phase 5: serve qwen2.5-3b at full width
# ---------------------------------------------------------------------------


def phase_serve(ka, cfg, params):
    """Serve the RAG workload on ``cfg`` (qwen2.5-3b, bf16, on the card)."""
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


def read_launches(ka, tk):
    return {"paged_chunk_attention": ka.paged_chunk_attention.launches,
            "paged_decode_attention": ka.paged_decode_attention.launches,
            "topk_retrieval": tk.topk_retrieval.launches}


def reset_launches(ka, tk):
    ka.reset_launch_counts()
    tk.reset_launch_counts()


def pool_is_clean(eng):
    pool = eng.kv.pool
    return pool.n_free == pool.n_blocks - 1


# ---------------------------------------------------------------------------
# phase 6: RAG requests at full width
# ---------------------------------------------------------------------------


def phase_rag(ka, tk, cfg, params, corpus, queries):
    """Index the (N_DOCS, DIM) ``corpus`` (numpy) on the card, read recall@10
    at three probe counts, and serve 8 retrieval-augmented requests on
    ``cfg`` (qwen2.5-3b bf16). Returns the three kernels' launches."""
    from repro_torch.core.components import Augmenter, Reranker, Retriever
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.retrieval import DocTokenStore, VectorIndex, recall_at_k

    reset_launches(ka, tk)
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
    launches = read_launches(ka, tk)
    st = eng.stats()
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["prefix_hit_tokens"] > 0 and pool_is_clean(eng), st
    assert all(n > 0 for n in launches.values()), launches
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


def phase_pipelines(ka, tk, cfg, params):
    from repro_torch.launch.serve import serve_pipelines

    torch.cuda.reset_peak_memory_stats()
    reset_launches(ka, tk)
    t0 = time.perf_counter()
    drv = serve_pipelines(cfg.name, 4.0, 5.0, arrival="poisson", session_fraction=0.3,
                          device="cuda", params=params, dtype=cfg.dtype, apps=APP_MIX,
                          max_batch=8, max_seq=2048, prefill_chunk_size=256,
                          token_budget=None, doc_len=256, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, tk)
    eng = drv.engine
    st = eng.stats()
    summary = drv.violation_summary()
    assert len(drv.records) == len(drv.events) > 0, (len(drv.records), len(drv.events))
    assert set(summary) == set(APP_MIX), summary
    assert all(np.isfinite(c["violation_rate"]) and 0 <= c["violation_rate"] <= 1
               for c in summary.values()), summary
    assert st["session_shared_tokens"] > 0 and pool_is_clean(eng), st
    assert st["kernel"] == "cuda" and launches["paged_chunk_attention"] > 0, launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[pipelines] {cfg.name} {cfg.dtype}: {len(drv.events)} events "
          f"({sum(e.session_id >= 0 for e in drv.events)} session turns) all completed; "
          f"{len(eng.finished)} engine requests, {st['tokens_out']} tokens out; "
          f"violation_summary {json.dumps(summary)}; session-shared tokens "
          f"{st['session_shared_tokens']}; prefix-hit tokens {st['prefix_hit_tokens']}; "
          f"{st['steps']} steps; {wall:.2f}s wall; peak memory {peak:.2f} GiB; "
          f"launches {launches}", flush=True)
    del drv, eng
    torch.cuda.empty_cache()
    return launches


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

    rows = timed("paged attention kernels", phase_kernels, ka)
    # the queries are drawn as benchmarks/retrieval_knob.py draws them
    corpus, queries = timed("synthetic_corpus on the host", lambda: (
        synthetic_corpus(N_DOCS, DIM, seed=0), synthetic_corpus(N_QUERIES, DIM, seed=7)))
    corpus_gpu, queries_gpu = torch.from_numpy(corpus).cuda(), torch.from_numpy(queries).cuda()
    topk_rows = timed("top-k kernel", phase_topk, tk, corpus_gpu, queries_gpu)
    del corpus_gpu
    torch.cuda.empty_cache()
    timed("engine parity", phase_parity)
    timed("pipeline parity", phase_pipeline_parity)

    cfg = get_arch("qwen2.5-3b").replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    launches = {"serve": timed("serve", phase_serve, ka, cfg, params)}
    launches["rag"] = timed("rag", phase_rag, ka, tk, cfg, params, corpus, queries_gpu)
    launches["pipelines"] = timed("pipelines", phase_pipelines, ka, tk, cfg, params)

    kernels = []
    for name in ("paged_chunk_attention", "paged_decode_attention"):
        r = rows[(name, "bfloat16")]     # the dtype the serve phase runs
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches["serve"][name],
            "max_abs_err": r["errs"]["plain"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # every check of every dtype: {dtype: {check: max abs err}}
            "max_abs_err_by_check": {d: rows[(name, d)]["errs"]
                                     for d in ("float32", "bfloat16", "int8")},
            "launches_by_phase": {ph: n[name] for ph, n in launches.items()},
        })
    # the RAG phase's shape: float32 index, B=32, k=10 (recall_at_k)
    r = topk_rows[("float32", 10)]
    kernels.append({
        "name": "topk_retrieval", "route": "cuda", "source": SOURCES["topk_retrieval"],
        "replaces": REPLACES["topk_retrieval"], "launches": launches["rag"]["topk_retrieval"],
        "max_abs_err": max(x["max_abs_err"] for x in topk_rows.values()), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "by_case": {f"{c}/k={k}": {key: x.get(key) for key in
                                   ("max_abs_err", "swapped", "ms", "plain_ms",
                                    "library_ms", "bound_ms")}
                    for (c, k), x in topk_rows.items()},
        "launches_by_phase": {ph: n.get("topk_retrieval", 0) for ph, n in launches.items()},
    })
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s in all", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
