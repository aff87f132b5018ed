"""Flash (prefill) attention: a CUDA kernel for the dense backend's prefill,
and its plain PyTorch version.

``flash_attention`` ports the Pallas kernel of
``repro.kernels.flash_attention``: GQA attention of q (B, S, H, hd) over
k (B, S_kv, KVH, hd) and v (B, S_kv, KVH, hd_v), causal or not, with an optional
sliding window (the mask of ``repro.models.attention.blockwise_attention(
attn_type=ATTN_SWA)``) or an optional chunk (the mask of
``blockwise_attention(attn_type=ATTN_CHUNKED_LOCAL)``: a query sees only
keys of its own chunk); the Pallas kernel has neither. Keys of another
length than the queries (S_kv != S: cross attention, the form of
``repro.models.attention.blockwise_attention`` that whisper's decoder
runs; the Pallas kernel takes S_kv = S only) go with ``causal=False`` and
no window or chunk: every query sees every key. On CUDA tensors the
wrapper launches the hand-written kernel in ``csrc/dense_attention.cu``
(built on first use, see ``kernels._build``) on the current stream and
counts the launch in its ``launches`` attribute; on CPU tensors it runs
``ref_flash_attention``. There is no fallback from one to the other: a CUDA
input the kernel does not take raises. The kernel takes float32 or bfloat16
(q, k and v in one dtype), the head dims (hd, hd_v) of ``HEAD_DIMS`` (MLA's
96 query/key dims against 64 value dims among them) and any S >= 1, and
keeps f32 scores and sums, as the Pallas kernel does. bfloat16 inputs run
on the tensor cores: the scores are exact bf16 products summed in f32, and
the probabilities reach the value product in two bf16 parts (P_hi =
bf16(P), P_lo = bf16(P - P_hi), about 16 bits), so the output stays within
the bf16 output rounding of the f32 contract. float32 inputs stay on the
CUDA cores, since TF32 tensor cores would keep only about 10 bits of each
input.

``ref_flash_attention`` is the contract of ``repro.kernels.ref.
flash_attention_ref``: scores in float32, a -1e30 causal (and window or
chunk) mask, and the probabilities cast to the value dtype before the value
product.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import NEG_INF, _check, _raise_on_error

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the (query/key, value) head-dim instantiations in csrc/dense_attention.cu
HEAD_DIMS = ((64, 64), (128, 128), (96, 64))
# the head dims of the cross form (S_kv != S): whisper's
CROSS_HEAD_DIMS = (64, 64)


def ref_flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                        window: int = 0, chunk: int = 0):
    """Plain version of ``flash_attention``. q: (B, S, H, hd); k: (B, S_kv,
    KVH, hd); v: (B, S_kv, KVH, hd_v); ``window`` > 0 masks keys at or
    before query - window, ``chunk`` > 0 keys of another chunk than the
    query's; S_kv != S only with neither and ``causal=False``. Returns (B,
    S, H, hd_v) in q's dtype."""
    B, S, H, hd = q.shape
    KVH, hd_v = k.shape[2], v.shape[-1]
    _check_cross("ref_flash_attention", S, k.shape[1], causal, window, chunk)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KVH, H // KVH, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        future = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(future, NEG_INF)
    if window > 0:
        past = torch.ones((S, S), dtype=torch.bool, device=q.device).tril(-window)
        s = s.masked_fill(past, NEG_INF)
    if chunk > 0:
        c = torch.arange(S, device=q.device) // chunk
        s = s.masked_fill(c[:, None] != c[None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    return o.reshape(B, S, H, hd_v).to(q.dtype)


def _check_cross(name, S, S_kv, causal, window, chunk):
    if S_kv != S and (causal or window > 0 or chunk > 0):
        raise ValueError(f"{name}: keys of another length than the queries (S={S}, "
                         f"S_kv={S_kv}) take causal=False and no window or chunk")


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                    window: int = 0, chunk: int = 0):
    """GQA attention of every query over the keys of its row (causal: those
    at or before it; ``window`` > 0: only those after query - window;
    ``chunk`` > 0: only those of the query's chunk of ``chunk`` positions;
    not both). q: (B, S, H, hd); k: (B, S_kv, KVH, hd); v: (B, S_kv, KVH,
    hd_v), all float32 or all bfloat16; S_kv != S (cross attention) with
    ``causal=False`` and no window or chunk only. Returns (B, S, H, hd_v)
    in q's dtype. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if window > 0 and chunk > 0:
        raise ValueError("flash_attention: a window and a chunk together are not supported")
    _check_cross("flash_attention", q.shape[1], k.shape[1], causal, window, chunk)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref_flash_attention(q, k, v, causal, scale, window, chunk)
    name = "flash_attention"
    _check(name, q.is_cuda, f"unsupported device {q.device}")
    _check(name, q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k and v must be 4-D")
    B, S, H, hd = q.shape
    S_kv, KVH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    _check(name, tuple(k.shape) == (B, S_kv, KVH, hd) and tuple(v.shape) == (B, S_kv, KVH, hd_v),
           "k must be (B, S_kv, KVH, hd) and v (B, S_kv, KVH, hd_v) with q's B and hd")
    _check(name, S_kv == S or (hd, hd_v) == CROSS_HEAD_DIMS,
           f"keys of another length than the queries take head dims {CROSS_HEAD_DIMS}, got "
           f"{(hd, hd_v)}")
    _check(name, KVH > 0 and H % KVH == 0, "H must be a multiple of KVH")
    _check(name, q.dtype in _DTYPE_CODES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k and v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    _check(name, (hd, hd_v) in HEAD_DIMS,
           f"(head_dim, value head_dim) must be one of {HEAD_DIMS}, got {(hd, hd_v)}")
    for t in (k, v):
        _check(name, t.device == q.device, "all tensors must be on q's device")
    for t in (q, k, v):
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
    from repro_torch.kernels._build import load_library

    lib = load_library("dense_attention").lib
    smem = lib.da_flash_smem_bytes(_DTYPE_CODES[q.dtype], hd, hd_v)
    _check(name, smem <= 227 * 1024, f"shared memory per block {smem} B exceeds 227 KB")
    out = q.new_empty((B, S, H, hd_v))
    if B == 0 or S == 0:
        return out
    _check(name, S_kv > 0, "k and v must hold at least one key")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.da_flash_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, S_kv, H, KVH, hd, hd_v, int(causal), max(int(window), 0), max(int(chunk), 0),
            float(scale), stream,
        )
    _raise_on_error(name, err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero the wrapper's launch counter."""
    flash_attention.launches = 0
