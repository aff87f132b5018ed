"""Paged GQA attention: CUDA kernels for the serving hot loop, and their
plain PyTorch versions.

``paged_decode_attention`` (one query token per row over its block chain)
and ``paged_chunk_attention`` (T packed query tokens, each over its own
row's chain under the segmented-prompt span mask) port the Pallas kernels of
``repro.kernels.decode_attention``. On CUDA tensors each wrapper launches
the hand-written kernel in ``csrc/paged_attention.cu`` (built on first use,
see ``kernels._build``) on the current stream and counts the launch in its
``launches`` attribute; on CPU tensors it runs the plain version. There is
no fallback from one to the other: a CUDA input the kernel does not take
raises.

``ref_paged_decode_attention`` / ``ref_paged_chunk_attention`` are PyTorch
ports of the JAX gather oracles: they materialise each query's contiguous
view from its block table and run masked softmax attention, with the
scores accumulated in float32 and the probabilities cast to the value dtype
before the value product, as the oracles do. They are the numerics
contract the kernels are held against.

Both kernels and both plain versions take RAW block tables (-1 entries are
masked) and float32, bfloat16 or int8 pools; int8 pools come with
per-(block, KV head) float32 scales ``k_scale``/``v_scale`` of shape
(n_blocks, KVH). The kernels take q in float32 or bfloat16: a float pool in
q's dtype, an int8 pool with either. A packed pad token (``row_of < 0``)
gets zeros.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# what the kernels are compiled for (kBS and the head_dim instantiations in
# csrc/paged_attention.cu)
_BLOCK_SIZE = 16
_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gather(pool, safe_tables, sc):
    """(R, mb) block ids -> (R, mb*bs, KVH, hd) view, dequantised to float32
    by the per-(block, KV head) scales when ``sc`` is given."""
    R, mb = safe_tables.shape
    g = pool[safe_tables]                                  # (R, mb, bs, KVH, hd)
    if sc is not None:
        g = g.float() * sc[safe_tables][:, :, None, :, None]
    return g.reshape(R, mb * pool.shape[1], *pool.shape[2:])


def _masked_attention(q, K, V, valid, scale):
    """q: (R, H, hd); K/V: (R, S, KVH, hd); valid: (R, S) -> (R, H, hd).
    Scores in float32, probabilities cast to V's dtype for the value
    product (accumulated in float32), output in q's dtype."""
    R, H, hd = q.shape
    KVH = K.shape[2]
    G = H // KVH
    qg = q.reshape(R, KVH, G, hd).float()
    scores = torch.einsum("rkgh,rskh->rkgs", qg, K.float()) * scale
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("rkgs,rskh->rkgh", probs.to(V.dtype).float(), V.float())
    return out.reshape(R, H, hd).to(q.dtype)


def ref_paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                               scale=None, k_scale=None, v_scale=None):
    """Plain version of ``paged_decode_attention``. q: (B, H, hd);
    k/v_pool: (n_blocks, bs, KVH, hd); block_tables: (B, mb) RAW; lengths:
    (B,) valid tokens per row (>= 1). Returns (B, H, hd)."""
    hd = q.shape[-1]
    bs = k_pool.shape[1]
    mb = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    safe = tables.clamp(min=0)
    slots = torch.arange(mb * bs, device=q.device)
    valid = (tables[:, slots // bs] >= 0) & (slots[None] < lengths.long()[:, None])
    K = _gather(k_pool, safe, k_scale)
    V = _gather(v_pool, safe, v_scale)
    return _masked_attention(q, K, V, valid, scale)


def ref_paged_chunk_attention(q, k_pool, v_pool, block_tables, row_of, slots,
                              p_end, s_start, scale=None, k_scale=None,
                              v_scale=None):
    """Plain version of ``paged_chunk_attention``. q: (T, H, hd); tables
    (B, mb) RAW; row_of/slots/p_end/s_start: (T,). Each token attends its
    own row's view under ``slot < p_end OR s_start <= slot <= slots[t]``.
    Returns (T, H, hd); pad tokens (row_of < 0) get zeros."""
    hd = q.shape[-1]
    bs = k_pool.shape[1]
    mb = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    row_of = row_of.long()
    rows = row_of.clamp(min=0)
    per_tok = block_tables.long()[rows]                   # (T, mb) table ints
    safe = per_tok.clamp(min=0)
    s_idx = torch.arange(mb * bs, device=q.device)
    backed = (row_of[:, None] >= 0) & (per_tok[:, s_idx // bs] >= 0)
    span = (s_idx[None] < p_end.long()[:, None]) | (
        (s_idx[None] >= s_start.long()[:, None])
        & (s_idx[None] <= slots.long()[:, None])
    )
    K = _gather(k_pool, safe, k_scale)
    V = _gather(v_pool, safe, v_scale)
    out = _masked_attention(q, K, V, backed & span, scale)
    return torch.where((row_of >= 0)[:, None, None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check(name, cond, what):
    if not cond:
        raise ValueError(f"{name}: {what}")


def _check_common(name, q, k_pool, v_pool, block_tables, k_scale, v_scale):
    """Validate what both kernels take; returns (dtype codes, scale ptrs)."""
    dev = q.device
    _check(name, q.dim() == 3 and k_pool.dim() == 4, "q must be 3-D, pools 4-D")
    _check(name, k_pool.shape == v_pool.shape, "k/v pools differ in shape")
    H, hd = q.shape[1], q.shape[2]
    KVH = k_pool.shape[2]
    _check(name, k_pool.shape[3] == hd, "pool head_dim differs from q")
    _check(name, KVH > 0 and H % KVH == 0, "H must be a multiple of KVH")
    _check(name, q.dtype in (torch.float32, torch.bfloat16),
           f"q must be float32 or bfloat16, got {q.dtype}")
    _check(name, k_pool.dtype == v_pool.dtype and k_pool.dtype in _DTYPE_CODES,
           f"pools must share one of float32/bfloat16/int8, got "
           f"{k_pool.dtype}/{v_pool.dtype}")
    quantized = k_pool.dtype == torch.int8
    _check(name, quantized or k_pool.dtype == q.dtype,
           f"a float pool must have q's dtype, got q {q.dtype}, pools {k_pool.dtype}")
    _check(name, block_tables.dtype == torch.int32 and block_tables.dim() == 2,
           "block_tables must be (B, mb) int32")
    _check(name, (k_scale is not None) == quantized
           and (v_scale is not None) == quantized,
           "int8 pools need k_scale and v_scale; float pools take none")
    tensors = [q, k_pool, v_pool, block_tables]
    if quantized:
        for sc in (k_scale, v_scale):
            _check(name, sc.dtype == torch.float32
                   and tuple(sc.shape) == (k_pool.shape[0], KVH),
                   "scales must be (n_blocks, KVH) float32")
        tensors += [k_scale, v_scale]
    for t in tensors:
        _check(name, t.device == dev, "all tensors must be on q's device")
        _check(name, t.is_contiguous(), "all tensors must be contiguous")
    ptrs = ((k_scale.data_ptr(), v_scale.data_ptr()) if quantized else (None, None))
    return _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], ptrs


def _launch_args(lib, q, k_pool):
    H, hd = q.shape[1], q.shape[2]
    bs, KVH = k_pool.shape[1], k_pool.shape[2]
    if bs != _BLOCK_SIZE or hd not in _HEAD_DIMS:
        raise ValueError(f"the kernels take block_size {_BLOCK_SIZE} and head_dim in "
                         f"{_HEAD_DIMS}; got block_size={bs}, head_dim={hd}")
    if k_pool.data_ptr() % 16:
        raise ValueError("the kernels read K in 16-byte loads: the pool must be "
                         "16-byte aligned")
    smem = lib.pa_smem_bytes(H // KVH, hd)
    if smem > 227 * 1024:
        raise ValueError(f"shared memory per block {smem} B exceeds the H100's 227 KB")
    return H, KVH, hd, bs


def _raise_on_error(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None):
    """Block-table decode attention over one layer's paged pool.

    q: (B, H, hd) float32/bfloat16; k/v_pool: (n_blocks, bs, KVH, hd);
    block_tables: (B, mb) int32 RAW (-1 = unallocated, masked); lengths:
    (B,) int32 valid tokens per row (>= 1). Returns (B, H, hd) in q's dtype.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref_paged_decode_attention(q, k_pool, v_pool, block_tables,
                                          lengths, scale, k_scale, v_scale)
    name = "paged_decode_attention"
    _check(name, q.is_cuda, f"unsupported device {q.device}")
    qc, kc, (ks, vs) = _check_common(name, q, k_pool, v_pool, block_tables,
                                     k_scale, v_scale)
    B, mb = block_tables.shape
    _check(name, q.shape[0] == B, "q and block_tables disagree on B")
    _check(name, lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
           and lengths.device == q.device and lengths.is_contiguous(),
           "lengths must be (B,) int32 on q's device")
    from repro_torch.kernels._build import load_library

    lib = load_library("paged_attention").lib
    H, KVH, hd, bs = _launch_args(lib, q, k_pool)
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pa_paged_decode_attention(
            qc, kc, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KVH, hd, bs, mb, float(scale), stream,
        )
    _raise_on_error(name, err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_chunk_attention(q, k_pool, v_pool, block_tables, row_of, slots,
                          p_end, s_start, *, scale: Optional[float] = None,
                          k_scale=None, v_scale=None):
    """Ragged fused-step attention: T packed query tokens over one layer's
    paged pool, which already holds the packed tokens' own K/V.

    q: (T, H, hd); k/v_pool: (n_blocks, bs, KVH, hd); block_tables: (B, mb)
    int32 RAW; row_of: (T,) int32 owning row (-1 = pad token, zeros out);
    slots: (T,) absolute cache slot; p_end/s_start: (T,) segmented-prompt
    spans (zeros = plain causal). Returns (T, H, hd) in q's dtype. CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref_paged_chunk_attention(q, k_pool, v_pool, block_tables,
                                         row_of, slots, p_end, s_start, scale,
                                         k_scale, v_scale)
    name = "paged_chunk_attention"
    _check(name, q.is_cuda, f"unsupported device {q.device}")
    qc, kc, (ks, vs) = _check_common(name, q, k_pool, v_pool, block_tables,
                                     k_scale, v_scale)
    T = q.shape[0]
    mb = block_tables.shape[1]
    for t in (row_of, slots, p_end, s_start):
        _check(name, t.dtype == torch.int32 and tuple(t.shape) == (T,)
               and t.device == q.device and t.is_contiguous(),
               "row_of/slots/p_end/s_start must be (T,) int32 on q's device")
    from repro_torch.kernels._build import load_library

    lib = load_library("paged_attention").lib
    H, KVH, hd, bs = _launch_args(lib, q, k_pool)
    out = torch.empty_like(q)
    if T == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pa_paged_chunk_attention(
            qc, kc, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
            block_tables.data_ptr(), row_of.data_ptr(), slots.data_ptr(),
            p_end.data_ptr(), s_start.data_ptr(), out.data_ptr(),
            T, H, KVH, hd, bs, mb, float(scale), stream,
        )
    _raise_on_error(name, err)
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero both wrappers' launch counters."""
    paged_decode_attention.launches = 0
    paged_chunk_attention.launches = 0
