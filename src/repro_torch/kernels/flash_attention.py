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

The backward. ``flash_attention`` is forward-only: its output is filled
through ctypes and has no ``grad_fn``, so on CUDA it refuses an input that
requires grad under grad mode. ``trainable_flash_attention`` runs it inside
the autograd Function ``FlashAttention``, whose backward is
``flash_attention_backward``: the port of ``repro.models.attention.
_flash_backward`` (the ``custom_vjp`` rule of ``blockwise_attention``). On
CUDA tensors it launches the hand-written kernels of
``csrc/flash_backward.cu`` (causal, head dims ``BACKWARD_HEAD_DIMS``,
float32 or bfloat16, any S and G; any other form raises
``NotImplementedError`` when the forward runs); on CPU tensors it runs
``ref_flash_attention_backward``, the plain version, which takes every
form of the forward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import NEG_INF, _check, _raise_on_error, refuse_grad

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the (query/key, value) head-dim instantiations in csrc/dense_attention.cu
HEAD_DIMS = ((64, 64), (128, 128), (96, 64))
# the head dims of the cross form (S_kv != S): whisper's
CROSS_HEAD_DIMS = (64, 64)
# the (query/key, value) head-dim instantiations in csrc/flash_backward.cu:
# smollm-135m's and qwen2.5-3b's
BACKWARD_HEAD_DIMS = ((64, 64), (128, 128))


def _masked_scores(qg, k, scale, causal, window, chunk):
    """f32 scores (B, KVH, G, S, S_kv) of the grouped queries qg (B, S, KVH,
    G, hd) over k, scaled, with -1e30 at the keys the mask hides."""
    S = qg.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        future = torch.ones((S, S), dtype=torch.bool, device=qg.device).triu(1)
        s = s.masked_fill(future, NEG_INF)
    if window > 0:
        past = torch.ones((S, S), dtype=torch.bool, device=qg.device).tril(-window)
        s = s.masked_fill(past, NEG_INF)
    if chunk > 0:
        c = torch.arange(S, device=qg.device) // chunk
        s = s.masked_fill(c[:, None] != c[None, :], NEG_INF)
    return s


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
    p = torch.softmax(_masked_scores(qg, k, scale, causal, window, chunk), dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    return o.reshape(B, S, H, hd_v).to(q.dtype)


def ref_flash_attention_backward(q, k, v, out, dout, causal: bool = True,
                                 scale: Optional[float] = None, window: int = 0, chunk: int = 0):
    """Plain version of ``flash_attention_backward``, the recompute
    backward of ``repro.models.attention._flash_backward``: the rows'
    log-sum-exp recomputed in f32 from the masked f32 scores, ``delta = sum
    dout * out`` in f32, the probabilities ``exp(s - lse)``, ``dp = dout .
    v`` and ``ds = p (dp - delta) scale``, all f32; dq = ds k, dk = ds^T q
    (summed over each KV head's group), dv = p^T dout. Every form of
    ``ref_flash_attention`` (causal or not, window, chunk, S_kv != S).
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, S, H, hd = q.shape
    KVH, hd_v = k.shape[2], v.shape[-1]
    G = H // KVH
    _check_cross("ref_flash_attention_backward", S, k.shape[1], causal, window, chunk)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KVH, G, hd).float()
    s = _masked_scores(qg, k, scale, causal, window, chunk)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    do_g = dout.reshape(B, S, KVH, G, hd_v).float()
    delta = (dout.float() * out.float()).sum(-1)                       # (B, S, H)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do_g, v.float())
    ds = p * (dp - delta.reshape(B, S, KVH, G).permute(0, 2, 3, 1)[..., None]) * scale
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()).reshape(B, S, H, hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do_g)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    refuse_grad(name, q, k, v)
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


def _check_backward_form(S, S_kv, causal, window, chunk, head_dims):
    """Raise ``NotImplementedError`` for a form the backward kernels do not
    take on the card: only causal self-attention without a window or chunk,
    at ``BACKWARD_HEAD_DIMS``."""
    if not causal or window > 0 or chunk > 0 or S_kv != S or head_dims not in BACKWARD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash attention's backward on the card takes causal self-attention without a "
            f"window or chunk at head dims {BACKWARD_HEAD_DIMS}; got causal={causal}, "
            f"window={window}, chunk={chunk}, S={S}, S_kv={S_kv}, head dims {head_dims}")


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             scale: Optional[float] = None, window: int = 0, chunk: int = 0):
    """dq, dk, dv of ``flash_attention(q, k, v)`` = ``out`` for the output
    gradient ``dout`` (B, S, H, hd_v), in the dtypes of q, k and v. CUDA
    tensors launch the three kernels of ``csrc/flash_backward.cu`` (one
    count in ``launches`` a call; causal only, at ``BACKWARD_HEAD_DIMS``);
    CPU tensors run the plain version (every form)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref_flash_attention_backward(q, k, v, out, dout, causal, scale, window, chunk)
    name = "flash_attention_backward"
    _check(name, q.is_cuda, f"unsupported device {q.device}")
    _check(name, q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k and v must be 4-D")
    B, S, H, hd = q.shape
    S_kv, KVH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    _check_backward_form(S, S_kv, causal, window, chunk, (hd, hd_v))
    _check(name, tuple(k.shape) == (B, S, KVH, hd) and tuple(v.shape) == (B, S, KVH, hd_v),
           "k must be (B, S, KVH, hd) and v (B, S, KVH, hd_v) with q's B, S and hd")
    _check(name, tuple(out.shape) == tuple(dout.shape) == (B, S, H, hd_v),
           "out and dout must be (B, S, H, hd_v)")
    _check(name, KVH > 0 and H % KVH == 0, "H must be a multiple of KVH")
    _check(name, q.dtype in _DTYPE_CODES and all(t.dtype == q.dtype for t in (k, v, out, dout)),
           f"q, k, v, out and dout must share float32 or bfloat16, got "
           f"{[t.dtype for t in (q, k, v, out, dout)]}")
    for t in (q, k, v, out, dout):
        _check(name, t.device == q.device, "all tensors must be on q's device")
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
    from repro_torch.kernels._build import load_library

    lib = load_library("flash_backward").lib
    smem = lib.fb_smem_bytes(hd, hd_v)
    _check(name, smem <= 227 * 1024, f"shared memory per block {smem} B exceeds 227 KB")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0:
        return dq, dk, dv
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fb_flash_backward(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, S, H, KVH, hd, hd_v, float(scale), stream,
        )
    _raise_on_error(name, err)
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward (``flash_attention_backward``):
    the counterpart of the JAX ``custom_vjp`` around ``_flash``. The forward
    saves q, k, v and the output; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, chunk):
        out = flash_attention(q, k, v, causal=causal, scale=scale, window=window, chunk=chunk)
        ctx.save_for_backward(q, k, v, out)
        ctx.form = (causal, scale, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, scale, window, chunk = ctx.form
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout.contiguous(), causal=causal,
                                              scale=scale, window=window, chunk=chunk)
        return dq, dk, dv, None, None, None, None


def trainable_flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                              window: int = 0, chunk: int = 0):
    """``flash_attention`` under autograd (the ``FlashAttention`` Function).
    On CUDA a form without a backward kernel (``_check_backward_form``)
    raises ``NotImplementedError`` here, before the forward runs: it never
    returns an output whose gradient would be lost."""
    if q.is_cuda:
        _check_backward_form(q.shape[1], k.shape[1], causal, window, chunk,
                             (q.shape[-1], v.shape[-1]))
    return FlashAttention.apply(q, k, v, causal, scale, window, chunk)


def reset_launch_counts() -> None:
    """Zero the wrappers' launch counters."""
    flash_attention.launches = 0
    flash_attention_backward.launches = 0
