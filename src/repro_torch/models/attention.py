"""GQA attention, ported from ``repro.models.attention``: ``qkv_project``,
and for the dense backend ``blockwise_attention`` (prefill, full or
sliding-window, through the ``flash_attention`` kernel), ``decode_attention``
(through the dense ``decode_attention`` kernel) and ``cache_validity`` (a
full-attention cache or a sliding-window ring). The
paged path reads attention through ``kernels.decode_attention`` directly;
its oracle steps (the padded fused step and the sequential prefill) run
``chunk_decode_attention``, a plain masked softmax as in JAX, where the
reference is a plain ``jnp`` function too."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ATTN_FULL, ATTN_SWA
from repro_torch.kernels.decode_attention import NEG_INF
from repro_torch.kernels.decode_attention import decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import flash_attention


def qkv_project(params, x, num_heads, num_kv_heads, head_dim):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, KVH, hd); adds the QKV
    bias where the params carry one (qwen)."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, num_heads, head_dim)
    k = k.reshape(B, S, num_kv_heads, head_dim)
    v = v.reshape(B, S, num_kv_heads, head_dim)
    return q, k, v


def blockwise_attention(q, k, v, *, attn_type: str = ATTN_FULL, window: int = 0,
                        causal: bool = True):
    """q: (B, S, H, hd); k/v: (B, S, KVH, hd) -> (B, S, H, hd). Attention,
    causal or not, over keys of the queries' own length (the
    ``flash_attention`` kernel). ``attn_type=ATTN_SWA`` with ``window`` w >
    0 keeps only the keys after query - w (JAX's mask ``kpos > qpos -
    window``); ``ATTN_FULL``, or a window of 0, keeps every key, as in JAX.
    Chunked masks and cross attention (S_kv != S) are not ported yet."""
    if attn_type not in (ATTN_FULL, ATTN_SWA) or k.shape[1] != q.shape[1]:
        raise NotImplementedError(
            f"blockwise_attention ports full and sliding-window attention with S_kv == S; "
            f"got attn_type={attn_type!r}, S={q.shape[1]}, S_kv={k.shape[1]}")
    return flash_attention(q, k, v, causal=causal, window=window if attn_type == ATTN_SWA else 0)


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B, 1, H, hd); k/v_cache: (B, Sc, KVH, hd); lengths: (B,) int32
    valid slots per row -> (B, 1, H, hd). The JAX function takes the (B, Sc)
    mask of ``cache_validity``; on a full-attention linear cache, and on an
    SWA ring of Sc <= window slots, that mask is ``slot < min(pos + 1,
    Sc)``, so the port passes ``lengths = min(pos + 1, Sc)`` to the
    kernel (``cache_validity`` is that mask)."""
    return decode_kernel(q[:, 0].contiguous(), k_cache, v_cache, lengths)[:, None]


def chunk_decode_attention(q, k_cache, v_cache, valid_mask, scale=None):
    """Chunked-prefill attention: C query tokens against a cache that
    already holds the cached prefix and the chunk's own entries.

    q: (B, C, H, hd); k/v_cache: (B, Sc, KVH, hd); valid_mask: (B, C, Sc)
    bool (per query, over absolute cache slots) -> (B, C, H, hd) in q's
    dtype. The JAX function's numerics: scores accumulated in float32 (the
    products of bf16 inputs are exact there), masked to -1e30, a float32
    softmax, the probabilities cast to the value dtype for the value
    product, accumulated in float32."""
    B, C, H, hd = q.shape
    KVH = k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, C, KVH, H // KVH, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache.float()) * scale
    scores = torch.where(valid_mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, C, H, hd).to(q.dtype)


def cache_validity(attn_type: str, cache_len: int, pos, chunk: int = 0):
    """Which cache slots a decode query at absolute position ``pos`` may
    attend: (B, Sc) bool for pos (B,), (1, Sc) for a 0-d pos. A
    full-attention cache: the slots filled so far; an SWA ring: those too,
    and once wrapped (pos + 1 >= Sc) every slot. Both are ``slot < min(pos +
    1, Sc)``, the ``lengths`` the decode stacks hand their kernel. The
    chunked-local ring is not ported yet."""
    if attn_type not in (ATTN_FULL, ATTN_SWA):
        raise NotImplementedError(
            f"cache_validity ports full-attention caches and SWA rings; "
            f"got attn_type={attn_type!r}")
    slots = torch.arange(cache_len, device=pos.device)
    return slots < torch.clamp(pos.long().reshape(-1, 1) + 1, max=cache_len)
