"""The work each kernel's contract asks for, the H100's rates that turn it
into a bound, and the counter that the kernel wrappers feed on the meta
device.

**Contract work.** Each ``*_work`` function gives what the function a
kernel computes must do, whatever implements it: the bytes it must move
(each input read once, each output written once) and the operations it
must do on its inputs; the least time the card could take is the larger
of the bytes over ``HBM_BYTES_S`` and the operations over their type's
rate in ``PEAK_OPS_S``. ``chip_smoke.py`` prints these bounds beside each
kernel's measured time, and the dry run
(``launch.dryrun``) adds the same counts to a step's FLOPs, so a kernel's
work is counted one way wherever it is read.

**The meta rule.** A kernel wrapper handed ``meta`` tensors (the dry run's
shapes-only trees) returns outputs of its contract's shapes and dtypes,
adds its contract work to ``META_WORK`` under its own name, and launches
nothing and runs no plain loop. Its ``cuda`` and ``cpu`` branches do not
change, and no wrapper falls back from one branch to another. Where the
work depends on the data (a row's valid length, a packed token's span),
the meta branch, which has no data, counts every slot its tensors hold.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

# NVIDIA H100 SXM5 80GB (the card the port targets; NVIDIA's H100 datasheet,
# SXM5 column, dense rates without sparsity)
HBM_BYTES_S = 3.35e12                    # HBM3 bandwidth
PEAK_OPS_S = {"float32": 67e12,          # CUDA cores, no tensor cores
              "tf32": 495e12,            # dense tensor-core rate
              "bfloat16": 989e12,        # dense tensor-core rate
              "int8": 1979e12}
# the memory a process can address on the card: torch.cuda.get_device_properties(0)
# .total_memory on an NVIDIA H100 80GB HBM3 (79.18 GiB: nvidia-smi's 81559 MiB
# less 480 MiB the card keeps); chip_smoke.py 19a prints the card's own
# figure beside it and fails if the two differ by more than 1 %
CARD_BYTES = 85_017_493_504


# ---------------------------------------------------------------------------
# the (query, key) pairs a mask leaves visible, in closed form
# ---------------------------------------------------------------------------


def visible_pairs(S, S_kv, causal=True, window=0, chunk=0) -> int:
    """The (query, key) pairs of one head the form's mask leaves visible:
    the count of ``~kernels.flash_attention.hidden_mask`` without building
    the (S, S_kv) mask (causal: keys at or before the row; ``window`` > 0:
    keys after row - window; ``chunk`` > 0: keys of the row's chunk)."""
    row = np.arange(S, dtype=np.int64)
    lo = np.zeros(S, dtype=np.int64)
    hi = np.full(S, S_kv - 1, dtype=np.int64)
    if causal:
        hi = np.minimum(hi, row)
    if window > 0:
        lo = np.maximum(lo, row - window + 1)
    if chunk > 0:
        lo = np.maximum(lo, row // chunk * chunk)
        hi = np.minimum(hi, (row // chunk + 1) * chunk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


# ---------------------------------------------------------------------------
# contract work of each kernel
# ---------------------------------------------------------------------------


def flash_work(q, k, v, causal=True, window=0, chunk=0):
    """(bytes, flops) of a flash call in the form (causal, window, chunk)
    the wrapper takes: q, K and V read once, the output written once; per
    query head and (query, key) pair the form leaves visible
    (``visible_pairs``, each batch row), 2 * hd flops for the score and
    2 * hd_v for the value product."""
    B, S, Hq, hd = q.shape
    hd_v = v.shape[3]
    pairs = B * visible_pairs(S, k.shape[1], causal, window, chunk)
    out = q.numel() // hd * hd_v
    nbytes = (q.numel() + k.numel() + v.numel() + out) * q.element_size()
    return nbytes, 2 * (hd + hd_v) * Hq * pairs


def decode_work(q, k, lengths):
    """(bytes, flops) of a dense decode call: q, and the K/V slots below
    each row's length, read once, the output written once; 4*hd flops per
    query head per (query, valid key) pair."""
    item = q.element_size()
    B, Hq, hd = q.shape
    pairs = sum(lengths)
    nbytes = 2 * q.numel() * item + 2 * pairs * k.shape[2] * hd * item + 4 * B
    return nbytes, 4 * hd * Hq * pairs


def backward_work(B, S, H, KVH, hd, item, S_kv=None, hd_v=None, **form):
    """(bytes, flop) the backward must move and do: q, k, v, out and dout
    read once, dq, dk and dv written once; five products over each (query
    head, visible key) pair, three hd deep (q.k, ds^T q, ds k) and two hd_v
    deep (do.v, p^T do)."""
    S_kv, hd_v = S_kv or S, hd_v or hd
    nbytes = item * B * (2 * S * H * (hd + hd_v) + 2 * S_kv * KVH * (hd + hd_v))
    return nbytes, 2 * (3 * hd + 2 * hd_v) * B * H * visible_pairs(S, S_kv, **form)


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


def ssm_work(dt, bm, h0):
    """(bytes, f32 flops, exponentials) of one call: dt, x, B and C (their
    dtype) read once, a_log and h0 read once, y and the final h (f32)
    written once; 6 flops per state element per step (dt * A, (dt x) * B,
    the FMA of h, C * h and its sum) and one exponential."""
    B, S, Di = dt.shape
    N = h0.shape[-1]
    item = dt.element_size()
    nbytes = (2 * dt.numel() + 2 * bm.numel()) * item + dt.numel() * 4 + Di * N * 4 \
        + 2 * h0.numel() * 4
    elems = B * S * Di * N
    return nbytes, 6 * elems, elems


def scan_backward_work(name, case):
    """(bytes, f32 flops, exponentials) of one backward call. Bytes: every
    input read once (r, k, v or dt, x, B, C in their dtype; w, dy, the
    initial state and its cotangent, a_log or u in f32), every gradient
    written once. WKV: 12 flops an element of the (hd x hd) state and step
    (the state's and the adjoint's updates, and the sums of dr, dk, dv and
    dw over the state, 2 each), no exponential. Scan: 18 flops an element
    of the (Di x N) state and step, an FMA counted as 2: the state
    recomputed (dt A, (dt x) B, the FMA: 4), the adjoint g = G + C dy (2),
    dC and dB (2 each), the lane sum of g B (2), G = a g (1), G h (1), its
    FMAs with A and with dt (2 each); and its one exponential exp(dt A).
    ``case``: the eight inputs in the wrapper's order."""
    size = lambda t: t.numel() * t.element_size()
    # the eight inputs; the six gradients have the shapes and dtypes of the first six
    nbytes = sum(size(t) for t in case) + sum(size(t) for t in case[:6])
    if name == "rwkv6_chunked_backward":
        B, S, H, hd = case[0].shape
        return nbytes, 12 * B * S * H * hd * hd, 0
    B, S, Di = case[0].shape
    elems = B * S * Di * case[2].shape[-1]
    return nbytes, 18 * elems, elems


def topk_work(q, docs, k):
    """(bytes, flops, products) of the kernel's route: docs and queries
    read once, (B, k) scores and ids written once; the products the split
    needs on the tensor cores, 2*B*N*d flops each at the dense tf32 rate:
    3 with float32 docs (hi*hi, hi*lo, lo*hi) and 2 with bfloat16 docs
    (exact in tf32: the query alone is split; the kernel takes it as three
    bf16 parts at twice the rate, the same time)."""
    import torch

    B, d = q.shape
    nbytes = docs.numel() * docs.element_size() + q.numel() * 4 + B * k * 8
    products = 3 if docs.dtype == torch.float32 else 2
    return nbytes, products * 2 * B * docs.shape[0] * d, products


def paged_work(q, k_pool, block_tables):
    """(bytes, flops) of a paged attention call on shapes alone (the meta
    branch): every table entry's block read once (K and V, all KV heads)
    for every row, q and the table read once, the output written once; 4*hd
    flops per query head per (query, slot) pair, each query (q: (n, H, hd),
    one a row at decode, a packed step's T tokens) over a whole chain."""
    B, mb = block_tables.shape
    bs, KVH, hd = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    slots = mb * bs
    kv_bytes = 2 * B * slots * KVH * hd * k_pool.element_size()
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + block_tables.numel() * 4
    return nbytes, 4 * hd * q.shape[1] * q.shape[0] * slots


# ---------------------------------------------------------------------------
# the meta counter
# ---------------------------------------------------------------------------


@dataclass
class Work:
    """What the meta branches of one wrapper counted: its calls, and the
    contract bytes, flops (f32 or tensor-core, by the call's dtype) and
    exponentials of those calls."""
    calls: int = 0
    nbytes: float = 0.0
    flops: float = 0.0
    exps: float = 0.0


META_WORK: Dict[str, Work] = {}


def count_meta(name: str, nbytes, flops, exps=0) -> None:
    """Add one meta call's contract work under the wrapper's ``name``."""
    w = META_WORK.setdefault(name, Work())
    w.calls += 1
    w.nbytes += float(nbytes)
    w.flops += float(flops)
    w.exps += float(exps)


def reset_meta_work() -> None:
    META_WORK.clear()


def meta_work_snapshot() -> Dict[str, Work]:
    """A copy of the counter, by wrapper name."""
    return {k: Work(v.calls, v.nbytes, v.flops, v.exps) for k, v in META_WORK.items()}
