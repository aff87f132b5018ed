"""Device times of the bf16 attention, scan and top-k kernels, one source tree
against another, or this tree against diagnostic variants of it, or this
tree's split targets, on one GPU.

    python -m repro_torch.launch.kernel_ab --trees build/parent/src src src build/parent/src
    python -m repro_torch.launch.kernel_ab --variants base exp2f p_once no_softmax no_loads
    python -m repro_torch.launch.kernel_ab --cases attention --variants base chunk_runtime chunk_runtime base
    python -m repro_torch.launch.kernel_ab --variants base chunk_rows64 chunk_rows64 base
    python -m repro_torch.launch.kernel_ab --cases scans --variants base wkv_output_only wkv_segment_only base
    python -m repro_torch.launch.kernel_ab --sweep
    python -m repro_torch.launch.kernel_ab --cases retrieval --variants base topk_no_select topk_loads_only topk_merge_only base
    python -m repro_torch.launch.kernel_ab --cases backward --trees build/parent/src src src build/parent/src
    python -m repro_torch.launch.kernel_ab --cases scans --variants base wkvb_no_local wkvb_no_output ssmb_no_local base

Each tree (a directory holding ``repro_torch``) or variant runs in a process
of its own, in the order given, so that its kernels are built from its own
sources; a variant is this tree's ``repro_torch`` copied under
``build/kernel_ab/<name>/`` with the edits of ``VARIANTS`` applied. The
flash variants after ``exp2f`` and the scan variants but ``wkv_unroll2``
and ``ssm_batch2`` change what the kernel computes: they only show what a
part of it costs; ``chunk_rows64`` halves the chunk kernel's tiles;
``chunk_runtime`` makes the flash kernel's chunk tests at run time in every
instantiation (same results). Cases are ``chip_smoke.py``'s: flash bf16
causal at S 2048 (H 16 / KVH 2, hd 128), windowed at S 1664 (window 1024, H
25 / KVH 5, hd 64), chunked at S 2048 (chunk 800, so tiles straddle chunk
boundaries, H 40 / KVH 8, hd 128) and at MLA's head dims 96 / 64 at S 6000
(H 40; a tree without the chunk mask or those head dims reports the case
unsupported); at H 16 / KVH 2, hd
128, paged decode at B 8 over contexts 33-2048 (128 blocks of 16 a row),
the chunk kernel on phase 2's ragged case (303 packed tokens) and at the
engine's mixed step (a 256-token prefill chunk at slots 1024-1279, seven
decode rows of 301-337 slots, one pad), and dense decode over a 2048-slot
cache at phase 2's lengths and at the mixed step's, and at hymba-1.5b's
heads (H 25 / KVH 5, hd 64, a 1024-slot ring) at the mixed step's lengths
(``--cases attention``); the RWKV-6 WKV kernel at rwkv6-7b's heads (H 64,
hd 64) prefilling B 1 at S 2048 and decoding B 8 at S 1, and the selective
scan at hymba-1.5b's (Di 1600, N 16) prefilling B 1 at S 1664 and decoding
B 8 at S 1, each from a given state, and the two backward kernels at the
training microbatch (WKV B 1 x S 2048, scan B 1 x S 2176; a tree without
them reports them unsupported) (``--cases scans``); the top-k
retrieval kernel at chip_smoke.py phase 3's timed shapes, B 32 unit-row
queries over N 2^21 unit-row docs of d 768 in float32 and in bfloat16, k
10 and 100 (``--cases retrieval``, not run unless named); the bf16 flash
backward (``--cases backward``, not run unless named) at qwen2.5-3b's
training microbatch (causal, B 1, S 2048, H 16 / KVH 2, hd 128) and at one
case of each other form of the forward: window 1024 at S 1664 (H 25 / KVH
5, hd 64), window 4096 at S 6000 (H 16 / KVH 2, hd 128), chunk 800 at S
2048 (H 40 / KVH 8, hd 128), cross attention of B 8 x S 448 over 1500 keys
(H 20 = KVH 20, hd 64) and MLA's (96, 64) at S 2048 (H 40 = KVH 40), each
with the largest of dq's, dk's and dv's errors over chip_smoke.py's
``BWD_TOL`` bound (a tree without the form reports it unsupported); its
``bwd_*`` variants leave passes out (the dQ kernel, the dK/dV kernel, the
group sum, all but the rows pass) to show what each costs; the
``wkvb_no_*`` and ``ssmb_no_*`` variants leave one pass of the scans'
backward kernels out in the same way (the WKV's local pass, output pass or
du sum; the scan's local pass, output pass or dB / dC / da_log sums), the
``wkvb_out_no_*`` and ``ssmb_out_no_*`` variants a part of an output pass
(the WKV's walks, tensor-core products, checkpoint loads or A's sums and
dv; the scan's walk back or checkpoint loads). Each process
prints one JSON line: per case the device time three times (calls queued
behind a spin kernel, L2 warm), the largest error against the plain
version in f32 and how many elements miss the check (attention: atol 1e-3,
rtol 8e-3, the bf16 output rounding; scans: y and the final state at atol
1e-4, rtol 1e-4, their unchanged tolerance, and each backward gradient at
atol 1e-5 of its largest entry, rtol 2**-7; top-k: the scores' largest
error, and the ids that differ from the plain version's where the plain
scores of the two lie further apart than 1e-5, chip_smoke.py's TOPK_TOL),
and the card's name and power limit. ``--sweep`` prints instead the dense
decode's and the chunk kernel's device times at each split target of
``sweep``, the two scans' prefill device times at each segment count of
``SEGMENTS``, and the top-k cases' at each ring depth of ``STAGES`` and
slice count a SM of ``SLICES_PER_SM``. The ``topk_*`` variants show where
the top-k kernel's time goes: the products without the selection
(``topk_no_select``), the corpus stream alone (``topk_loads_only``: no
products, no selection), the products alone (``topk_products_only``: no
copies, no selection), the merge kernel alone (``topk_merge_only``, on
stale scratch), one wgmma a step in place of two (``topk_one_wgmma``,
wrong scores), the f32 d_lo pass without its stores (``topk_no_lo_pass``,
wrong scores) and the products without the proxy fence after each stage's
copies (``topk_no_stage_fence``). A variant still stores the scores:
wgmma results nobody reads are dropped by the compiler.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
PKG = Path(__file__).resolve().parents[1]

_TILE_LOADS = ('''    bf16* Ks = stage0 + (it & 1) * STAGE;
    bf16* Vs = Ks + kTile * RS;
    if (kt + 1 < kt_end) {''', '''    bf16* Ks = stage0;
    bf16* Vs = Ks + kTile * RS;
    if (false) {''')
_SOFTMAX = "    // scale, mask where this tile can hold a masked key, online softmax\n"
_PV = "    // O += P V over 16-key steps."

_DENSE = "csrc/dense_attention.cu"
_CHUNK_SRC = "csrc/paged_attention.cu"
_WRAPPERS = "kernels/decode_attention.py"
_WKV = "csrc/rwkv6_scan.cu"
_SSM = "csrc/ssm_scan.cu"
_TOPK = "csrc/topk_retrieval.cu"
_NO_SELECT = ("      const bool select = q0 + qi < B;               // warp-uniform",
              "      const bool select = false;")

_BWD = "csrc/flash_backward.cu"
_WKVB = "csrc/rwkv6_scan_backward.cu"
_SSMB = "csrc/ssm_scan_backward.cu"
_BWD_LAUNCHER = "template <typename T, int HDK, int HDV, bool CHUNKED>\ncudaError_t launch_backward_hd("


def _bwd_skip(*kernels):
    """An edit of the flash backward's launcher that launches none of
    ``kernels`` (each pass's cost, from the time it saves; wrong results)."""
    def edit(text):
        text = text.replace(_BWD_LAUNCHER, "template <typename Kernel, typename... P>\n"
                            "cudaError_t launch_none(Kernel, dim3, int, size_t, cudaStream_t, "
                            "P...) { return cudaSuccess; }\n\n" + _BWD_LAUNCHER)
        for name in kernels:
            if f"launch({name}<" not in text:
                raise ValueError(f"variant: {_BWD} launches no {name}")
            text = text.replace(f"launch({name}<", f"launch_none({name}<")
        return text
    return edit


def _skip_launches(path, *kernels):
    """An edit of a CUDA source that launches none of ``kernels`` (each
    ``name<...><<<...>>>(...);`` statement made ``if (false) ...``): what
    the passes left out cost, from the time they save; wrong results."""
    def edit(text):
        for name in kernels:
            text, n = re.subn(rf"(?<![\w]){name}(<[^<>;]*>)?<<<", rf"if (false) \g<0>", text)
            if n == 0:
                raise ValueError(f"variant: {path} launches no {name}")
        return text
    return edit


# name -> edits of files of repro_torch: (file, old, new), or (file, callable
# on its text). The flash kernel's, the chunk kernel's, the scans', the top-k
# kernel's, then the flash backward's.
VARIANTS = {
    "base": [],
    # the CUDA math library's exp2f in place of ex2.approx (every call site)
    "exp2f": [(_DENSE, ": ex2(", ": exp2f(")],
    # P rounded to bf16 once: one value product instead of two
    "p_once": [(_DENSE, "        mma_bf16(o[n], pl, vf[0], vf[1]);\n", ""),
               (_DENSE, "        mma_bf16(o[n + 1], pl, vf[2], vf[3]);\n", "")],
    # no online softmax: the raw scores go to the value product
    "no_softmax": [(_DENSE, lambda s: (s[:s.index(_SOFTMAX)] + "    l_a += 1.f;\n    l_b += 1.f;\n\n"
                                       + s[s.index(_PV):]))],
    # the first K/V tile only: no loads after the prologue
    "no_loads": [(_DENSE, *_TILE_LOADS)],
    # the chunk tests made at run time in every instantiation, as before
    # the chunk mask became a template argument (same results)
    "chunk_runtime": [(_DENSE, "    if constexpr (CHUNKED) {", "    if (chunk > 0) {"),
                      (_DENSE, "(!CHUNKED || col / chunk == row / chunk)",
                       "(chunk <= 0 || col / chunk == row / chunk)"),
                      (_DENSE, "(CHUNKED && min(k0, q0)", "(chunk > 0 && min(k0, q0)")],
    # chunk tiles of 64 query rows (8 tokens at 8 heads a KV head, four
    # warps), two blocks an SM
    "chunk_rows64": [(_CHUNK_SRC, "constexpr int kTileRows = 128;", "constexpr int kTileRows = 64;"),
                     (_WRAPPERS, "_TILE_ROWS = 128\n", "_TILE_ROWS = 64\n"),
                     (_WRAPPERS, "_CHUNK_BLOCKS_PER_SM = 1\n", "_CHUNK_BLOCKS_PER_SM = 2\n")],
    # the one-loop kernels that preceded the split of the time axis (apply
    # them with this file copied into a checkout of that tree, run from
    # there): the WKV kernel without its stores of the partial sums of y (the
    # compiler drops the y products with them), with the global loads of its
    # first chunk only, and the scan with a multiply in place of its
    # exponential
    "oneloop_wkv_no_ystore": [(_WKV, "      syp[t * L::KS * L::VB] = a;\n", "")],
    "oneloop_wkv_no_loads": [(_WKV, "    if (c + 1 < n_chunks) load_chunk(c + 1);", "")],
    "oneloop_ssm_no_exp": [(_SSM, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(da[j]) : "f"(d2.x * a2));',
                            "da[j] = d2.x * a2;")],
    # one of the two passes of each scan alone (the other's launch skipped;
    # the output pass then starts from stale scratch): what each pass costs
    "wkv_output_only": [(_WKV, "    wkv_segment_kernel<T, HD><<<",
                         "    if (false) wkv_segment_kernel<T, HD><<<")],
    "wkv_segment_only": [(_WKV, "  wkv_output_kernel<T, HD><<<dim3(n_seg, H, B)",
                          "  if (false) wkv_output_kernel<T, HD><<<dim3(n_seg, H, B)")],
    "ssm_output_only": [(_SSM, "    ssm_pass_kernel<T, N, false><<<",
                         "    if (false) ssm_pass_kernel<T, N, false><<<")],
    "ssm_segment_only": [(_SSM, "  ssm_pass_kernel<T, N, true><<<",
                          "  if (false) ssm_pass_kernel<T, N, true><<<")],
    # the WKV output pass's step loop unrolled twice, not four times
    "wkv_unroll2": [(_WKV, "#pragma unroll 4\n    for (int t = 0; t < tc; ++t) {",
                     "#pragma unroll 2\n    for (int t = 0; t < tc; ++t) {")],
    # the scan's steps in batches of 2 (loads and exponentials ahead of h)
    "ssm_batch2": [(_SSM, "constexpr int kBatch = 4;", "constexpr int kBatch = 2;")],
    # the output passes without the carry (each segment after the first
    # starts from segment 0's end state): what the carry costs
    "wkv_no_carry": [(_WKV, "    for (int i = 1; i < j; ++i) {", "    for (int i = 1; i < 1; ++i) {")],
    "ssm_no_carry": [(_SSM, "    for (int i0 = 1; i0 < j; i0 += kCarryBatch) {",
                      "    for (int i0 = 1; i0 < 1; i0 += kCarryBatch) {")],
    # the scan's exponentials replaced by a copy (what the SFU costs), and
    # its output pass with the shared-memory loads out of the step loop
    # (every step reads step 0's values: what the loads cost)
    "ssm_no_exp": [(_SSM, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));', "r = x;")],
    "ssm_output_no_lds": [(_SSM, "    ssm_pass_kernel<T, N, false><<<",
                           "    if (false) ssm_pass_kernel<T, N, false><<<"),
                          (_SSM, "        const float4 d4 = ld4(s_d + ((r0 + st) * CP + cp) * 4);\n"
                                 "        const float4 b4 = ld4(s_b + (r0 + st) * N + n0);",
                           "        const float4 d4 = ld4(s_d + cp * 4);\n"
                           "        const float4 b4 = ld4(s_b + n0);"),
                          (_SSM, "          const float4 c4 = ld4(s_c + (r0 + st) * N + n0);",
                           "          const float4 c4 = ld4(s_c + n0);")],
    # the top-k kernel: no selection (no score passes); the stream alone
    # (the consumers wait for each stage and release it, no products); the
    # products alone (no copies issued: the stages' arrivals still pace the
    # ring; no selection); the merge kernel alone (pass 1 not launched: it
    # merges stale scratch); one wgmma a step (f32: d_hi alone, bf16: b0 and
    # b1 alone); the f32 d_lo pass's stores dropped (its wgmma reads stale
    # d_lo)
    "topk_no_select": [(_TOPK, *_NO_SELECT)],
    "topk_loads_only": [(_TOPK, *_NO_SELECT),
                        (_TOPK, "        Doc<T>::products(acc, ring + st * kStageBytes, lo_buf, "
                                "qrow, c, t, tid);\n", "")],
    "topk_products_only": [(_TOPK, *_NO_SELECT),
                           (_TOPK, "          cp_async16(dst + (m & 1 ? dst1 : dst0) + (m >> 1) "
                                   "* 8 * kRowBytes,\n                     ok ? src + m * "
                                   "row_step : docs, ok ? 16 : 0);\n", "")],
    "topk_merge_only": [(_TOPK, "  pass1<<<grid, kThreads, smem, stream>>>(",
                         "  if (false) pass1<<<grid, kThreads, smem, stream>>>(")],
    "topk_one_wgmma": [(_TOPK, "    for (int kk = 0; kk < 4; ++kk) wgmma_tf32(acc, a[kk], "
                               "desc_sw128(la + 32 * kk), 1);\n", ""),
                       (_TOPK, "      wgmma_bf16(acc, a2[kk], desc_sw128(sa + 32 * kk), 1);\n", "")],
    "topk_no_lo_pass": [(_TOPK, "      *reinterpret_cast<uint4*>(lo + off) = l;\n", "")],
    # no proxy fence between the stage's copies and the products (what the
    # fence costs; the products may read stale data)
    "topk_no_stage_fence": [(_TOPK, "    fence_proxy_async();                   // the stage's copies, "
                                    "for the async proxy\n    wgmma_fence();", "    wgmma_fence();"),
                            (_TOPK, "    fence_proxy_async();                   // the stage's copies, "
                                    "for the async proxy\n    uint32_t a1", "    uint32_t a1")],
}


VARIANTS.update({
    # the flash backward without its dQ kernel, its dK/dV kernel, its group
    # sum, or with the rows pass alone (bf16 and f32 launchers alike)
    "bwd_no_dq": [(_BWD, _bwd_skip("fb_dq_tc_kernel", "fb_dq_kernel"))],
    "bwd_no_dkdv": [(_BWD, _bwd_skip("fb_dkdv_tc_kernel", "fb_dkdv_kernel"))],
    "bwd_no_sum": [(_BWD, _bwd_skip("fb_group_sum_kernel"))],
    "bwd_rows_only": [(_BWD, _bwd_skip("fb_dkdv_tc_kernel", "fb_dkdv_kernel", "fb_dq_tc_kernel",
                                       "fb_dq_kernel", "fb_group_sum_kernel"))],
    # the bf16 dK/dV kernel taking a whole 64-query tile a step (its K and V
    # fragments loaded once a tile, twice the score registers), the dQ kernel
    # half a 64-key tile (same results)
    "bwd_subq64": [(_BWD, "constexpr int kSubQ = 32;", "constexpr int kSubQ = 64;")],
    "bwd_subk32": [(_BWD, "constexpr int kSubK = 64;", "constexpr int kSubK = 32;")],
    # this tree's scans' backward kernels without one pass each: the WKV's
    # local pass (states and adjoints), output pass or du's sum; the scan's
    # local pass, output pass or dB / dC / da_log sums
    "wkvb_no_local": [(_WKVB, _skip_launches(_WKVB, "wkvb_local_kernel"))],
    "wkvb_no_output": [(_WKVB, _skip_launches(_WKVB, "wkvb_output_kernel"))],
    "wkvb_no_du": [(_WKVB, _skip_launches(_WKVB, "wkvb_du_kernel"))],
    "ssmb_no_local": [(_SSMB, _skip_launches(_SSMB, "ssmb_local_kernel"))],
    "ssmb_no_output": [(_SSMB, _skip_launches(_SSMB, "ssmb_output_kernel"))],
    "ssmb_no_reduce": [(_SSMB, _skip_launches(_SSMB, "ssmb_reduce_kernel"))],
    # parts of the two output passes left out (wrong results): the WKV's
    # walks inside a chunk, its tensor-core products, its checkpoint loads
    # (each chunk from the segment's start state), A's sums and dv; the
    # scan's walk back and its checkpoint loads
    "wkvb_out_no_walks": [(_WKVB, "      if (fwd) {\n        // phi[l]",
                           "      if (false) {\n        // phi[l]"),
                          (_WKVB, "      } else {\n        // e[l] = W(i,l) r_l (l > i)",
                           "      } else if (false) {\n        // e[l] = W(i,l) r_l (l > i)")],
    "wkvb_out_no_products": [(_WKVB, "      for (int kk = 0; kk < HD / 8; ++kk) {\n"
                                     "        const int c0 = 8 * kk + t4, c1 = c0 + 4;",
                              "      for (int kk = 0; kk < 0; ++kk) {\n"
                              "        const int c0 = 8 * kk + t4, c1 = c0 + 4;")],
    "wkvb_out_no_ckpt": [(_WKVB, "    if (q > q_first) {\n      const size_t c = bh * n_chunk + q;",
                          "    if (false) {\n      const size_t c = bh * n_chunk + q;")],
    "wkvb_out_no_dv": [(_WKVB, "    for (int p = tid; p < kPairs; p += F::NT) {",
                        "    for (int p = tid; p < 0; p += F::NT) {"),
                       (_WKVB, "    for (int e = tid; e < tc * (HD / 4); e += F::NT) {",
                        "    for (int e = tid; e < 0; e += F::NT) {")],
    "ssmb_out_no_walk_back": [(_SSMB, "    for (int i = kT - 1; i >= 0; --i) {\n      const float4 dd",
                               "    for (int i = kT - 1; i >= kT; --i) {\n      const float4 dd")],
    "ssmb_out_no_ckpt": [(_SSMB, "      if (qc > q_first && live[e]) {", "      if (false) {")],
    # the WKV backward in chunks of 8 steps, not 16: half the walks' work a
    # step, twice the checkpoints (same results)
    "wkvb_chunk8": [(_WKVB, "constexpr int kT = 16; ", "constexpr int kT = 8; "),
                    ("kernels/rwkv6_scan.py", "BACKWARD_CHUNK = 16\n_BACKWARD_MIN_CHUNKS = 2\n",
                     "BACKWARD_CHUNK = 8\n_BACKWARD_MIN_CHUNKS = 4\n")],
})


def _variant_tree(name: str) -> Path:
    dst = ROOT / "build" / "kernel_ab" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(PKG, dst / "repro_torch", ignore=shutil.ignore_patterns("__pycache__"))
    for rel, *edit in VARIANTS[name]:
        path = dst / "repro_torch" / rel
        text = path.read_text()
        if len(edit) == 1:
            text = edit[0](text)
        else:
            old, new = edit
            if old not in text:
                raise ValueError(f"variant {name}: {rel} no longer holds {old!r}")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def _device_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    late = a.query()     # the spin ended before the calls were queued
    b.synchronize()
    return None if late else a.elapsed_time(b) / reps


def _off(got, want, atol=1e-3, rtol=8e-3):
    err = (got.float() - want).abs()
    return float(err.max()), int((err > atol + rtol * want.abs()).sum())


def measure(cases=("attention", "scans")) -> dict:
    """Run in the child process, with the tree's ``repro_torch`` importable."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    if "attention" in cases:
        out.update(_flash_cases(g))
        out.update(_attention_cases(g))
    if "scans" in cases:
        out.update(_scan_cases(g))
    if "retrieval" in cases:
        out.update(_retrieval_cases(g))
    if "backward" in cases:
        out.update(_backward_cases(g))
    return out


# (name, B, S, S_kv or None, H, KVH, hd, hd_v, form) of the bf16 backward cases
BACKWARD_CASES = (
    ("backward_causal_S2048", 1, 2048, None, 16, 2, 128, 128, {}),
    ("backward_window1024_S1664", 1, 1664, None, 25, 5, 64, 64, {"window": 1024}),
    ("backward_window4096_S6000", 1, 6000, None, 16, 2, 128, 128, {"window": 4096}),
    ("backward_chunk800_S2048", 1, 2048, None, 40, 8, 128, 128, {"chunk": 800}),
    ("backward_cross_S448_Skv1500", 8, 448, 1500, 20, 20, 64, 64, {"causal": False}),
    ("backward_mla_S2048", 1, 2048, None, 40, 40, 96, 64, {}),
)


def _backward_cases(g) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as kf

    out = {}
    for name, B, S, S_kv, H, KVH, hd, hd_v, form in BACKWARD_CASES:
        S_kv = S_kv or S
        q, k, v = (torch.randn((B, n_, n, d), generator=g, device="cuda").bfloat16()
                   for n_, n, d in ((S, H, hd), (S_kv, KVH, hd), (S_kv, KVH, hd_v)))
        o = kf.flash_attention(q, k, v, **form)
        do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
        try:
            got = kf.flash_attention_backward(q, k, v, o, do, **form)
        except (TypeError, ValueError, NotImplementedError) as e:  # a tree without the form
            out[name] = {"unsupported": str(e)}
            continue
        want = kf.ref_flash_attention_backward(q, k, v, o, do, **form)
        excess = 0.0
        for a, w in zip(got, want):        # chip_smoke.py's BWD_TOL["bfloat16"]
            w = w.float()
            bound = 1e-5 * max(1.0, float(w.abs().max())) + 2 ** -7 * w.abs()
            excess = max(excess, float(((a.float() - w).abs() / bound).max()))
        out[name] = {"device_ms": [_device_ms(lambda: kf.flash_attention_backward(
                         q, k, v, o, do, **form), reps=10) for _ in range(3)],
                     "excess": excess}
        del q, k, v, o, do, got, want
        torch.cuda.empty_cache()
    return out


def _flash_cases(g) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as kf

    out = {}
    for name, S, H, KVH, hd, hd_v, mask in (
            ("flash_causal_S2048", 2048, 16, 2, 128, 128, {}),
            ("flash_window_S1664", 1664, 25, 5, 64, 64, {"window": 1024}),
            ("flash_chunk_S2048", 2048, 40, 8, 128, 128, {"chunk": 800}),
            ("flash_mla_S6000", 6000, 40, 40, 96, 64, {})):
        q, k, v = (torch.randn((1, S, n, d), generator=g, device="cuda").bfloat16()
                   for n, d in ((H, hd), (KVH, hd), (KVH, hd_v)))
        try:
            got = kf.flash_attention(q, k, v, **mask)
        except (TypeError, ValueError) as e:   # a tree without this mask or head dims
            out[name] = {"unsupported": str(e)}
            continue
        err, off = _off(got, kf.ref_flash_attention(q.float(), k.float(), v.float(), **mask))
        out[name] = {"device_ms": [_device_ms(lambda: kf.flash_attention(q, k, v, **mask))
                                   for _ in range(3)], "max_abs_err": err, "n_off": off}
    return out


LENGTHS = [2048, 1536, 1024, 777, 512, 300, 129, 33]
CHUNKS = {2: (64, 0, 0), 4: (96, 128, 400), 5: (100, 0, 0), 7: (33, 0, 0)}
MIXED_LENGTHS = [1280, 301, 308, 312, 319, 326, 330, 337]
MIXED_CHUNKS = {0: (256, 0, 0)}


def _paged_case(g, lengths, chunks, n_pad, B=8, H=16, KVH=2, hd=128, bs=16, mb=144):
    """bf16 pools, RAW tables and packed arrays as chip_smoke.py's
    make_case builds them: rows of ``lengths`` after the step, ``chunks``
    {row: (tokens, p_end, s_start)} prefilling, the rest decoding one token,
    ``n_pad`` pads."""
    import torch

    n_blocks = B * mb + 1
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(0)) + 1
    tables = torch.full((B, mb), -1, dtype=torch.int32)
    cur = 0
    for b, ln in enumerate(lengths):
        need = -(-ln // bs)
        tables[b, :need] = perm[cur:cur + need].int()
        cur += need
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
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")
    kp, vp = (torch.randn((n_blocks, bs, KVH, hd), generator=g, device="cuda").bfloat16()
              for _ in range(2))
    return {"tables": tables.cuda(), "k": kp, "v": vp, "lengths": i32(lengths),
            "q_dec": torch.randn((B, H, hd), generator=g, device="cuda").bfloat16(),
            "q_chunk": torch.randn((len(row_of), H, hd), generator=g, device="cuda").bfloat16(),
            "row_of": i32(row_of), "slots": i32(slots), "p_end": i32(p_end),
            "s_start": i32(s_start)}


def _attention_cases(g) -> dict:
    import torch
    from repro_torch.kernels import decode_attention as ka

    out = {}

    def record(name, kern, plain_f32, valid=None):
        got = kern()
        want = plain_f32()
        if valid is not None:
            got, want = got[valid], want[valid]
        err, off = _off(got, want)
        out[name] = {"device_ms": [_device_ms(kern) for _ in range(3)], "max_abs_err": err,
                     "n_off": off}

    c = _paged_case(g, LENGTHS, {}, 0)
    f = {k: c[k].float() for k in ("q_dec", "k", "v")}
    record("paged_decode",
           lambda: ka.paged_decode_attention(c["q_dec"], c["k"], c["v"], c["tables"][:, :128]
                                             .contiguous(), c["lengths"]),
           lambda: ka.ref_paged_decode_attention(f["q_dec"], f["k"], f["v"],
                                                 c["tables"][:, :128], c["lengths"]))
    for name, lengths, chunks, n_pad in (("chunk_ragged", LENGTHS, CHUNKS, 3),
                                         ("chunk_mixed_step", MIXED_LENGTHS, MIXED_CHUNKS, 1)):
        c = _paged_case(g, lengths, chunks, n_pad)
        f = {k: c[k].float() for k in ("q_chunk", "k", "v")}
        keys = ("tables", "row_of", "slots", "p_end", "s_start")
        record(name, lambda: ka.paged_chunk_attention(c["q_chunk"], c["k"], c["v"],
                                                      *(c[k] for k in keys)),
               lambda: ka.ref_paged_chunk_attention(f["q_chunk"], f["k"], f["v"],
                                                    *(c[k] for k in keys)),
               valid=c["row_of"] >= 0)
    for name, H, KVH, hd, Sc, lengths in (
            ("dense_decode_lengths", 16, 2, 128, 2048, LENGTHS),
            ("dense_decode_mixed_step", 16, 2, 128, 2048, MIXED_LENGTHS),
            ("dense_decode_hymba_mixed_step", 25, 5, 64, 1024,
             [min(n, 1024) for n in MIXED_LENGTHS])):
        q = torch.randn((8, H, hd), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((8, Sc, KVH, hd), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        record(name, lambda: ka.decode_attention(q, k, v, lens),
               lambda: ka.ref_decode_attention(q.float(), k.float(), v.float(), lens))
    return out


# the scans' cases: rwkv6-7b's heads and hymba-1.5b's SSM widths, bf16
WKV_H, WKV_HD = 64, 64
WKV_CASES = (("wkv_prefill_S2048", 1, 2048), ("wkv_decode_B8", 8, 1))
SSM_DI, SSM_N = 1600, 16
SSM_CASES = (("ssm_prefill_S1664", 1, 1664), ("ssm_decode_B8", 8, 1))
SCAN_TOL = (1e-4, 1e-4)
# the backward kernels at chip_smoke.py phase 18g's main shapes (the
# training microbatch: hymba's 2048 tokens + 128 meta tokens), with
# cotangents on y and on the final state; each gradient against the plain
# version at atol 1e-5 x max(1, max |want|), rtol 2**-7 (BWD_TOL's bf16
# bound: one bf16 rounding of the f32 result apart)
SCAN_BACKWARD_CASES = (("wkv_backward_S2048", 1, 2048), ("ssm_backward_S2176", 1, 2176))


def _wkv_inputs(g, B, S):
    """chip_smoke.py's phase 2c inputs: realistic Finch decay, a state."""
    import torch

    shape = (B, S, WKV_H, WKV_HD)
    r, k = (0.5 * torch.randn(shape, generator=g, device="cuda") for _ in range(2))
    v = torch.randn(shape, generator=g, device="cuda")
    w = torch.exp(-torch.exp(0.5 * torch.randn(shape, generator=g, device="cuda")))
    u = 0.3 * torch.randn((WKV_H, WKV_HD), generator=g, device="cuda")
    state0 = 0.5 * torch.randn((B, WKV_H, WKV_HD, WKV_HD), generator=g, device="cuda")
    return r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u, state0


def _ssm_inputs(g, B, S):
    """chip_smoke.py's phase 2d inputs: dt = softplus(N(-2, 1)), an h0."""
    import torch

    shape = (B, S, SSM_DI)
    dt = torch.nn.functional.softplus(torch.randn(shape, generator=g, device="cuda") - 2.0)
    x = torch.randn(shape, generator=g, device="cuda")
    bm, cm = (0.5 * torch.randn((B, S, SSM_N), generator=g, device="cuda") for _ in range(2))
    a_log = torch.log(torch.arange(1, SSM_N + 1, dtype=torch.float32, device="cuda"))
    a_log = a_log.expand(SSM_DI, SSM_N).contiguous()
    h0 = 0.5 * torch.randn((B, SSM_DI, SSM_N), generator=g, device="cuda")
    return dt.bfloat16(), x.bfloat16(), bm.bfloat16(), cm.bfloat16(), a_log, h0


def _scan_calls(g):
    """(name, kernel call, plain call) of each scan case; the kernel writes
    its final state to a buffer of its own, so every call sees the same
    state."""
    import torch
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    calls = []
    for name, B, S in WKV_CASES:
        args = _wkv_inputs(g, B, S)
        out = torch.empty_like(args[-1])
        calls.append((name, lambda a=args, o=out: kw.rwkv6_chunked(*a, state_out=o),
                      lambda a=args: kw.ref_rwkv6_chunked(*a)))
    for name, B, S in SSM_CASES:
        args = _ssm_inputs(g, B, S)
        out = torch.empty_like(args[-1])
        calls.append((name, lambda a=args, o=out: ks.ssm_scan(*a, h_out=o),
                      lambda a=args: ks.ref_ssm_scan(*a)))
    return calls


def _scan_backward_calls(g):
    """(name, kernel call, plain call) of each backward case, or (name,
    None, None) where the tree has no backward kernel."""
    import torch
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    calls = []
    for (name, B, S), (mod, fn, inputs) in zip(
            SCAN_BACKWARD_CASES, ((kw, "rwkv6_chunked_backward", _wkv_inputs),
                                  (ks, "ssm_scan_backward", _ssm_inputs))):
        if not hasattr(mod, fn):
            calls.append((name, None, None))
            continue
        args = inputs(g, B, S)
        y, st = getattr(mod, fn.removesuffix("_backward"))(*args)
        cot = (torch.randn(y.shape, generator=g, device="cuda"),
               torch.randn(st.shape, generator=g, device="cuda"))
        calls.append((name, lambda a=args + cot, f=getattr(mod, fn): f(*a),
                      lambda a=args + cot, f=getattr(mod, "ref_" + fn): f(*a)))
    return calls


def _scan_cases(g) -> dict:
    out = {}
    for name, kern, plain in _scan_calls(g):
        (y, st), (y_ref, st_ref) = kern(), plain()
        err_y, off_y = _off(y, y_ref, *SCAN_TOL)
        err_s, off_s = _off(st, st_ref, *SCAN_TOL)
        out[name] = {"device_ms": [_device_ms(kern) for _ in range(3)],
                     "max_abs_err": max(err_y, err_s), "n_off": off_y + off_s}
    for name, kern, plain in _scan_backward_calls(g):
        if kern is None:
            out[name] = "unsupported"
            continue
        errs, offs = zip(*(_off(a, w.float(), 1e-5 * max(1.0, float(w.float().abs().max())),
                                2 ** -7) for a, w in zip(kern(), plain())))
        out[name] = {"device_ms": [_device_ms(kern) for _ in range(3)],
                     "max_abs_err": max(errs), "n_off": sum(offs)}
    return out


# chip_smoke.py phase 3's timed shapes
TOPK_B, TOPK_N, TOPK_D, TOPK_KS = 32, 1 << 21, 768, (10, 100)
TOPK_SWAP = 1e-5


def _topk_calls(g):
    """(name, kernel call, plain call, q, docs, k) of each top-k case: unit rows,
    as the index holds them, float32 and bfloat16 docs."""
    import torch
    from repro_torch.kernels import topk_retrieval as tk

    unit = lambda x: x / x.norm(dim=1, keepdim=True)
    q = unit(torch.randn((TOPK_B, TOPK_D), generator=g, device="cuda"))
    docs32 = unit(torch.randn((TOPK_N, TOPK_D), generator=g, device="cuda"))
    calls = []
    for dname, docs in (("f32", docs32), ("bf16", docs32.bfloat16())):
        for k in TOPK_KS:
            calls.append((f"topk_{dname}_k{k}",
                          lambda docs=docs, k=k: tk.topk_retrieval(q, docs, k),
                          lambda docs=docs, k=k: tk.ref_topk_retrieval(q, docs, k), q, docs, k))
    return calls


def _retrieval_cases(g) -> dict:
    import torch

    out = {}
    for name, kern, plain, q, docs, _ in _topk_calls(g):
        (gs, gi), (ws, wi) = kern(), plain()
        diff = gi != wi
        off = 0
        if bool(diff.any()):
            # a variant may leave ids that are no doc: they count as off
            real = (gi >= 0) & (gi < docs.shape[0])
            full = q @ docs.float().T
            gap = (full.gather(1, torch.where(real, gi, 0).long())
                   - full.gather(1, wi.long())).abs()
            off = int(((gap > TOPK_SWAP) | ~real)[diff].sum())
            del full
        out[name] = {"device_ms": [_device_ms(kern) for _ in range(3)],
                     "max_abs_err": float((gs - ws).abs().max()), "n_off": off,
                     "ids_swapped": int(diff.sum())}
    return out


# segment counts of the scans' prefill sweep
SEGMENTS = (1, 2, 4, 6, 8, 10, 12, 16, 24)
# the top-k sweep: ring stages (at most what shared memory leaves) and
# slices a SM
STAGES = (2, 3, 4, 5, 6)
SLICES_PER_SM = (1, 2, 3, 4)


def sweep(cases=("attention", "scans")) -> dict:
    """This tree's split targets: the dense decode at 1, 2, 4, 8 and 16
    warps per SM (``_DENSE_WARPS_PER_SM``) and the chunk kernel at 1, 2, 4
    and 8 blocks per SM (``_CHUNK_BLOCKS_PER_SM``) (``cases`` attention),
    and the scans' prefills at each segment count of ``SEGMENTS`` (scans),
    device ms twice each."""
    import torch
    from repro_torch.kernels import decode_attention as ka

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    if "scans" in cases:
        out.update(_segment_sweep(g))
    if "retrieval" in cases:
        out.update(_topk_sweep(g))
    if "attention" not in cases:
        return out
    for name, H, KVH, hd, Sc, lengths in (
            ("dense_lengths", 16, 2, 128, 2048, LENGTHS),
            ("dense_mixed_step", 16, 2, 128, 2048, MIXED_LENGTHS),
            ("dense_hymba_mixed_step", 25, 5, 64, 1024, [min(n, 1024) for n in MIXED_LENGTHS]),
            ("dense_hymba_rings", 25, 5, 64, 1024, [1024, 1024, 1, 1024, 37, 1024, 300, 1024])):
        q = torch.randn((8, H, hd), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((8, Sc, KVH, hd), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for target in (1, 2, 4, 8, 16):
            ka._DENSE_WARPS_PER_SM = target
            out[f"{name}/warps_per_sm={target}"] = [
                _device_ms(lambda: ka.decode_attention(q, k, v, lens)) for _ in range(2)]
    for name, lengths, chunks, n_pad in (("chunk_ragged", LENGTHS, CHUNKS, 3),
                                         ("chunk_mixed_step", MIXED_LENGTHS, MIXED_CHUNKS, 1)):
        c = _paged_case(g, lengths, chunks, n_pad)
        args = [c[k] for k in ("q_chunk", "k", "v", "tables", "row_of", "slots", "p_end",
                               "s_start")]
        for target in (1, 2, 4, 8):
            ka._CHUNK_BLOCKS_PER_SM = target
            out[f"{name}/blocks_per_sm={target}"] = [
                _device_ms(lambda: ka.paged_chunk_attention(*args)) for _ in range(2)]
    return out


def _segment_sweep(g) -> dict:
    """The scans' prefill device times with the segment rule replaced by a
    fixed count (``wkv_segments`` / ``ssm_segments``), twice each."""
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    out = {}
    rules = {"wkv": (kw, "wkv_segments"), "ssm": (ks, "ssm_segments")}
    for name, kern, _ in _scan_calls(g):
        if "prefill" not in name:
            continue
        mod, rule = rules[name[:3]]
        keep = getattr(mod, rule)
        for n in SEGMENTS:
            setattr(mod, rule, lambda *shape, n=n: kw.even_segments(shape[-1], n))
            out[f"{name}/n_seg={n}"] = [_device_ms(kern) for _ in range(2)]
        setattr(mod, rule, keep)
    return out


def _topk_sweep(g) -> dict:
    """The top-k cases' device times at each ring depth of ``STAGES`` (the
    plan's ``_MAX_STAGES``; the stages actually run are those that fit) and
    each slice count a SM of ``SLICES_PER_SM`` (``_SLICES_PER_SM``: more
    than one is more than one wave), twice each."""
    from repro_torch.kernels import topk_retrieval as tk

    out = {}
    keep = tk._MAX_STAGES, tk._SLICES_PER_SM
    for name, kern, _, q, docs, k in _topk_calls(g):
        for n in STAGES:
            tk._MAX_STAGES = n
            ran = tk.topk_plan(tk._sm_count(0), q.shape[0], *docs.shape, k,
                               docs.element_size()).stages
            out[f"{name}/stages={ran}"] = [_device_ms(kern) for _ in range(2)]
        tk._MAX_STAGES = keep[0]
        for n in SLICES_PER_SM:
            tk._SLICES_PER_SM = n
            out[f"{name}/slices_per_sm={n}"] = [_device_ms(kern) for _ in range(2)]
        tk._SLICES_PER_SM = keep[1]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="directories holding repro_torch, in run order")
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    help="diagnostic variants of this tree's kernels, in run order")
    ap.add_argument("--sweep", action="store_true",
                    help="this tree's split targets of the dense decode and chunk kernels, "
                         "and the scans' segment counts")
    ap.add_argument("--cases", nargs="+", choices=("attention", "scans", "retrieval", "backward"),
                    default=["attention", "scans"], help="which kernels --trees, "
                    "--variants and --sweep time")
    ap.add_argument("--child", nargs=3, metavar=("TREE", "LABEL", "CASES"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:                 # one tree, in a process that imports only its package
        tree, label, cases = args.child
        sys.path.insert(0, tree)
        import torch

        if not torch.cuda.is_available():
            print("kernel_ab: no CUDA device is visible", file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        print(json.dumps({"run": label, "card": card,
                          **(sweep if label == "sweep" else measure)(cases.split(","))}),
              flush=True)
        return 0
    if sum(map(bool, (args.trees, args.variants, args.sweep))) != 1:
        ap.error("give one of --trees, --variants, --sweep")
    if args.sweep:
        runs = [(PKG.parent, "sweep")]
    elif args.trees:
        runs = [(Path(t).resolve(), f"tree:{t}") for t in args.trees]
    else:
        made = {v: _variant_tree(v) for v in dict.fromkeys(args.variants)}
        runs = [(made[v], f"variant:{v}") for v in args.variants]
    rc = 0
    for tree, label in runs:
        # the file, not the module: the child must not import this tree's package first
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree), label,
                               ",".join(args.cases)])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
