"""Device times of the bf16 flash and paged decode kernels, one source tree
against another, or this tree's flash kernel against diagnostic variants of
it, on one GPU.

    python -m repro_torch.launch.kernel_ab --trees build/parent/src src src build/parent/src
    python -m repro_torch.launch.kernel_ab --variants base exp2f p_once no_softmax no_loads

Each tree (a directory holding ``repro_torch``) or variant runs in a process
of its own, in the order given, so that its kernels are built from its own
sources; a variant is this tree's ``repro_torch`` copied under
``build/kernel_ab/<name>/`` with the edits of ``VARIANTS`` applied to its
``csrc/dense_attention.cu``. The edits after ``exp2f`` change what the
kernel computes: they only show what a part of the kernel costs. Shapes are
``chip_smoke.py``'s: flash bf16 causal at S 2048 (H 16 / KVH 2, hd 128) and
windowed at S 1664 (window 1024, H 25 / KVH 5, hd 64); for trees also paged
decode bf16 at B 8 over contexts 33-2048 (H 16 / KVH 2, hd 128, 128 blocks
of 16 a row). Each process prints one JSON line: per case the device time
three times (calls queued behind a spin kernel, L2 warm), the largest error
against the plain version in f32 and how many elements miss the bf16 check
(atol 1e-3, rtol 8e-3), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
PKG = Path(__file__).resolve().parents[1]

_TILE_LOADS = ('''    bf16* Ks = stage0 + (it & 1) * 2 * kTile * RS;
    bf16* Vs = Ks + kTile * RS;
    if (kt + 1 < kt_end) {''', '''    bf16* Ks = stage0;
    bf16* Vs = Ks + kTile * RS;
    if (false) {''')
_SOFTMAX = "    // scale, mask where this tile can hold a masked key, online softmax\n"
_PV = "    // O += P V over 16-key steps."

# name -> edits (old, new) of csrc/dense_attention.cu, or a callable on its text
VARIANTS = {
    "base": [],
    # the CUDA math library's exp2f in place of ex2.approx (every call site)
    "exp2f": [(": ex2(", ": exp2f(")],
    # P rounded to bf16 once: one value product instead of two
    "p_once": [("        mma_bf16(o[n], pl, vf[0], vf[1]);\n", ""),
               ("        mma_bf16(o[n + 1], pl, vf[2], vf[3]);\n", "")],
    # no online softmax: the raw scores go to the value product
    "no_softmax": lambda s: (s[:s.index(_SOFTMAX)] + "    l_a += 1.f;\n    l_b += 1.f;\n\n"
                             + s[s.index(_PV):]),
    # the first K/V tile only: no loads after the prologue
    "no_loads": [_TILE_LOADS],
}


def _variant_tree(name: str) -> Path:
    dst = ROOT / "build" / "kernel_ab" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(PKG, dst / "repro_torch", ignore=shutil.ignore_patterns("__pycache__"))
    src = dst / "repro_torch" / "csrc" / "dense_attention.cu"
    text = src.read_text()
    edits = VARIANTS[name]
    if callable(edits):
        text = edits(text)
    else:
        for old, new in edits:
            if old not in text:
                raise ValueError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
    src.write_text(text)
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


def _off(got, want):
    err = (got.float() - want).abs()
    return float(err.max()), int((err > 1e-3 + 8e-3 * want.abs()).sum())


def measure(paged: bool) -> dict:
    """Run in the child process, with the tree's ``repro_torch`` importable."""
    import torch
    from repro_torch.kernels import decode_attention as ka
    from repro_torch.kernels import flash_attention as kf

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, S, H, KVH, hd, window in (("flash_causal_S2048", 2048, 16, 2, 128, 0),
                                        ("flash_window_S1664", 1664, 25, 5, 64, 1024)):
        q, k, v = (torch.randn((1, S, n, hd), generator=g, device="cuda").bfloat16()
                   for n in (H, KVH, KVH))
        err, off = _off(kf.flash_attention(q, k, v, window=window),
                        kf.ref_flash_attention(q.float(), k.float(), v.float(), window=window))
        out[name] = {"device_ms": [_device_ms(lambda: kf.flash_attention(q, k, v, window=window))
                                   for _ in range(3)], "max_abs_err": err, "n_off": off}
    if paged:
        lengths = [2048, 1536, 1024, 777, 512, 300, 129, 33]
        B, H, KVH, hd, bs, mb = 8, 16, 2, 128, 16, 128
        n_blocks = B * mb + 1
        perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(0)) + 1
        tables = torch.full((B, mb), -1, dtype=torch.int32)
        cur = 0
        for b, ln in enumerate(lengths):
            need = -(-ln // bs)
            tables[b, :need] = perm[cur:cur + need].int()
            cur += need
        tables = tables.cuda()
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        kp, vp = (torch.randn((n_blocks, bs, KVH, hd), generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        q = torch.randn((B, H, hd), generator=g, device="cuda").bfloat16()
        err, off = _off(ka.paged_decode_attention(q, kp, vp, tables, lens),
                        ka.ref_paged_decode_attention(q.float(), kp.float(), vp.float(),
                                                      tables, lens))
        out["paged_decode"] = {
            "device_ms": [_device_ms(lambda: ka.paged_decode_attention(q, kp, vp, tables, lens))
                          for _ in range(3)], "max_abs_err": err, "n_off": off}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="directories holding repro_torch, in run order")
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    help="diagnostic variants of this tree's flash kernel, in run order")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:                 # one tree, in a process that imports only its package
        tree, label = args.child
        sys.path.insert(0, tree)
        import torch

        if not torch.cuda.is_available():
            print("kernel_ab: no CUDA device is visible", file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        print(json.dumps({"run": label, "card": card,
                          **measure(paged=label.startswith("tree:"))}), flush=True)
        return 0
    if bool(args.trees) == bool(args.variants):
        ap.error("give --trees or --variants")
    if args.trees:
        runs = [(Path(t).resolve(), f"tree:{t}") for t in args.trees]
    else:
        made = {v: _variant_tree(v) for v in dict.fromkeys(args.variants)}
        runs = [(made[v], f"variant:{v}") for v in args.variants]
    rc = 0
    for tree, label in runs:
        # the file, not the module: the child must not import this tree's package first
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree), label])
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
