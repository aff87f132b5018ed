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
``csrc/flash_backward.cu``, which take every form the forward kernel takes
(causal or not, a window or a chunk, cross attention at
``CROSS_HEAD_DIMS``, the head dims of ``HEAD_DIMS``; float32 or bfloat16,
any S and G): bfloat16 on the tensor cores, with P and dS in two bf16 parts
as the forward's P. A form the forward does not take either raises
``NotImplementedError`` before the forward runs. On CPU tensors it runs
``ref_flash_attention_backward``, the plain version. The kernels' tile
ranges follow one rule per direction, mirrored here by ``kv_tiles`` (the
key tiles a query tile sees) and ``q_tiles`` (the query tiles that see a
key tile), which the CPU tests hold to the plain mask.

On ``meta`` tensors (the dry run) both wrappers return outputs of their
contract's shapes and dtypes and count their contract work in
``kernels.work.META_WORK`` (the pairs the mask leaves visible, in closed
form); they launch nothing and run no plain version, and a form the card
refuses raises on meta too (``kernels.work``'s meta rule).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import NEG_INF, _check, _raise_on_error, refuse_grad
from repro_torch.kernels.work import backward_work, count_meta, flash_work

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the (query/key, value) head-dim instantiations in csrc/dense_attention.cu
HEAD_DIMS = ((64, 64), (128, 128), (96, 64))
# the head dims of the cross form (S_kv != S): whisper's
CROSS_HEAD_DIMS = (64, 64)
# rows of a query tile and of a key tile in csrc/flash_backward.cu
TILE = 64


def hidden_mask(S, S_kv, causal, window, chunk, device="cpu"):
    """(S, S_kv) bool, True where the mask hides key col from query row:
    causal, the keys after the row; ``window`` > 0, those at or before row -
    window; ``chunk`` > 0, those of another chunk than the row's."""
    row = torch.arange(S, device=device)[:, None]
    col = torch.arange(S_kv, device=device)[None, :]
    hidden = torch.zeros((S, S_kv), dtype=torch.bool, device=device)
    if causal:
        hidden |= col > row
    if window > 0:
        hidden |= col <= row - window
    if chunk > 0:
        hidden |= col // chunk != row // chunk
    return hidden


def kv_tiles(qt, S, S_kv, causal, window, chunk):
    """The key tiles [begin, end) that query tile ``qt`` (rows qt * TILE ..
    +TILE - 1) sees: the rule of ``KvTiles`` in csrc/flash_backward.cu (the
    forward's ``KvRange``). Causal stops at the diagonal tile, a window starts
    at the tile of the first row's first key, a chunk starts at the first
    row's chunk and ends after the last row's."""
    q0, n_kv = qt * TILE, -(-S_kv // TILE)
    end = min(qt + 1, n_kv) if causal else n_kv
    begin = max(q0 - window + 1, 0) // TILE if window > 0 else 0
    if chunk > 0:
        begin = q0 // chunk * chunk // TILE
        last_row = min(q0 + TILE, S) - 1
        end = min(end, -(-((last_row // chunk + 1) * chunk) // TILE))
    return begin, end


def q_tiles(kt, S, S_kv, causal, window, chunk):
    """The query tiles [begin, end) that see key tile ``kt``: the rule of
    ``QTiles`` in csrc/flash_backward.cu, the transpose of ``kv_tiles``.
    Causal starts at the diagonal tile, a window ends at the tile of the last
    key's last row (key + window - 1), a chunk starts at the first key's
    chunk and ends after the last key's."""
    k0, n_q = kt * TILE, -(-S // TILE)
    k_last = min(k0 + TILE, S_kv) - 1
    begin = kt if causal else 0
    end = min((k_last + window - 1) // TILE + 1, n_q) if window > 0 else n_q
    if chunk > 0:
        begin = max(begin, k0 // chunk * chunk // TILE)
        end = min(end, -(-((k_last // chunk + 1) * chunk) // TILE))
    return begin, end


def _masked_scores(qg, k, scale, causal, window, chunk):
    """f32 scores (B, KVH, G, S, S_kv) of the grouped queries qg (B, S, KVH,
    G, hd) over k, scaled, with -1e30 at the keys the mask hides."""
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal or window > 0 or chunk > 0:
        s = s.masked_fill(hidden_mask(qg.shape[1], k.shape[1], causal, window, chunk,
                                      qg.device), NEG_INF)
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
    _check(name, q.is_cuda or q.is_meta, f"unsupported device {q.device}")
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
    if q.is_meta:
        count_meta(name, *flash_work(q, k, v, causal, window, chunk))
        return q.new_empty((B, S, H, hd_v))
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
    take on the card, which are those the forward kernel does not take
    either: a window together with a chunk, head dims outside
    ``HEAD_DIMS``, and keys of another length than the queries that are
    causal, windowed or chunked or at head dims other than
    ``CROSS_HEAD_DIMS``."""
    cross = S_kv != S and (causal or window > 0 or chunk > 0 or head_dims != CROSS_HEAD_DIMS)
    if (window > 0 and chunk > 0) or head_dims not in HEAD_DIMS or cross:
        raise NotImplementedError(
            f"flash attention's backward on the card takes the forms of the forward kernel: "
            f"a window or a chunk (not both) at head dims {HEAD_DIMS}, keys of another length "
            f"non-causal at {CROSS_HEAD_DIMS}; got causal={causal}, window={window}, "
            f"chunk={chunk}, S={S}, S_kv={S_kv}, head dims {head_dims}")


def flash_attention_backward(q, k, v, out, dout, *, causal: bool = True,
                             scale: Optional[float] = None, window: int = 0, chunk: int = 0):
    """dq, dk, dv of ``flash_attention(q, k, v)`` = ``out`` for the output
    gradient ``dout`` (B, S, H, hd_v), in the dtypes of q, k and v. CUDA
    tensors launch the kernels of ``csrc/flash_backward.cu`` (one count in
    ``launches`` a call; every form of the forward kernel, see
    ``_check_backward_form``); CPU tensors run the plain version."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref_flash_attention_backward(q, k, v, out, dout, causal, scale, window, chunk)
    name = "flash_attention_backward"
    _check(name, q.is_cuda or q.is_meta, f"unsupported device {q.device}")
    _check(name, q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k and v must be 4-D")
    B, S, H, hd = q.shape
    S_kv, KVH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    _check_backward_form(S, S_kv, causal, window, chunk, (hd, hd_v))
    _check(name, tuple(k.shape) == (B, S_kv, KVH, hd) and tuple(v.shape) == (B, S_kv, KVH, hd_v),
           "k must be (B, S_kv, KVH, hd) and v (B, S_kv, KVH, hd_v) with q's B and hd")
    _check(name, tuple(out.shape) == tuple(dout.shape) == (B, S, H, hd_v),
           "out and dout must be (B, S, H, hd_v)")
    _check(name, KVH > 0 and H % KVH == 0, "H must be a multiple of KVH")
    _check(name, q.dtype in _DTYPE_CODES and all(t.dtype == q.dtype for t in (k, v, out, dout)),
           f"q, k, v, out and dout must share float32 or bfloat16, got "
           f"{[t.dtype for t in (q, k, v, out, dout)]}")
    for t in (q, k, v, out, dout):
        _check(name, t.device == q.device, "all tensors must be on q's device")
    if q.is_meta:
        count_meta(name, *backward_work(B, S, H, KVH, hd, q.element_size(), S_kv=S_kv,
                                        hd_v=hd_v, causal=causal, window=window, chunk=chunk))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for t in (q, k, v, out, dout):
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
    from repro_torch.kernels._build import load_library

    lib = load_library("flash_backward").lib
    smem = lib.fb_smem_bytes(_DTYPE_CODES[q.dtype], hd, hd_v)
    _check(name, smem <= 227 * 1024, f"shared memory per block {smem} B exceeds 227 KB")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0:
        return dq, dk, dv
    _check(name, S_kv > 0, "k and v must hold at least one key")
    # L and delta padded to whole query tiles; with G > 1 the dK/dV kernel
    # writes each query head's f32 partials, (B, S_kv, H, hd) then (B, S_kv,
    # H, hd_v), and a pass sums each group's in head order
    n_pad = -(-S // TILE) * TILE
    lse = torch.empty((B, H, n_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    ws = (torch.empty(B * S_kv * H * (hd + hd_v), dtype=torch.float32, device=q.device)
          if H > KVH else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fb_flash_backward(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if ws is None else ws.data_ptr(), B, S, S_kv, H, KVH, hd, hd_v,
            int(causal), max(int(window), 0), max(int(chunk), 0), float(scale), stream,
        )
    _raise_on_error(name, err)
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


def kernel_tile_ranges(S, S_kv, causal, window, chunk):
    """The kernels' own tile ranges (``fb_tile_ranges`` of the built
    library: [(begin, end)] of each query tile's key tiles, then of each key
    tile's query tiles), for the card test that holds ``kv_tiles`` and
    ``q_tiles`` to them."""
    from repro_torch.kernels._build import load_library

    kv = torch.zeros(2 * -(-S // TILE), dtype=torch.int32)
    qs = torch.zeros(2 * -(-S_kv // TILE), dtype=torch.int32)
    load_library("flash_backward").lib.fb_tile_ranges(
        S, S_kv, int(causal), int(window), int(chunk), kv.data_ptr(), qs.data_ptr())
    pairs = lambda t: [tuple(x) for x in t.view(-1, 2).tolist()]
    return pairs(kv), pairs(qs)


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
    On CUDA a form without a backward kernel (``_check_backward_form``: one
    the forward kernel does not take either) raises ``NotImplementedError``
    here, before the forward runs: it never returns an output whose
    gradient would be lost."""
    if q.is_cuda or q.is_meta:
        _check_backward_form(q.shape[1], k.shape[1], causal, window, chunk,
                             (q.shape[-1], v.shape[-1]))
    return FlashAttention.apply(q, k, v, causal, scale, window, chunk)


def reset_launch_counts() -> None:
    """Zero the wrappers' launch counters."""
    flash_attention.launches = 0
    flash_attention_backward.launches = 0
