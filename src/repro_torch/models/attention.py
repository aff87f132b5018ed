"""Attention, ported from ``repro.models.attention``: GQA's
``qkv_project``, and for the dense backend ``blockwise_attention``
(prefill, full, sliding-window or chunked-local, through the
``flash_attention`` kernel; whisper's cross attention at S_kv != S too),
``decode_attention`` (through the dense
``decode_attention`` kernel) and ``cache_validity`` (a full-attention
cache, a sliding-window ring or a chunked-local ring); and multi-head
latent attention (MLA, minicpm3): ``mla_latents``, ``mla_queries``,
``mla_prefill`` (expanded heads through the ``flash_attention`` kernel at
its split head dims) and ``mla_decode`` (the absorbed form, plain torch
products, as the JAX function is plain ``jnp``; MLA's params come from
``transformer.init_mla``). The paged path reads attention through
``kernels.decode_attention`` directly; its oracle steps (the padded fused
step and the sequential prefill) run ``chunk_decode_attention``, a plain
masked softmax as in JAX, where the reference is a plain ``jnp`` function
too."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ATTN_CHUNKED_LOCAL, ATTN_FULL, ATTN_SWA
from repro_torch.kernels.decode_attention import NEG_INF
from repro_torch.kernels.decode_attention import decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import flash_attention, trainable_flash_attention
from repro_torch.models.layers import apply_rope_tables, rms_norm


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
                        chunk: int = 0, causal: bool = True):
    """q: (B, S, H, hd); k: (B, S_kv, KVH, hd); v: (B, S_kv, KVH, hd_v) ->
    (B, S, H, hd_v). Attention through the ``flash_attention`` kernel,
    scaled by 1/sqrt(hd). Over keys of the queries' own length (S_kv = S),
    causal or not: ``attn_type=ATTN_SWA`` with ``window`` w > 0 keeps only
    the keys after query - w (JAX's mask ``kpos > qpos - window``);
    ``ATTN_CHUNKED_LOCAL`` with ``chunk`` c > 0 only the keys of the query's
    chunk (``kpos // c == qpos // c``), the model's definition at every S
    (JAX's function gets it wrong where S > c and S % c != 0: ROADMAP §3);
    ``ATTN_FULL``, or a window or chunk of 0, keeps every key, as in JAX.
    Cross attention (S_kv != S, whisper's decoder over the encoder's
    output) is full and non-causal: every query sees every key, the form
    JAX asks for; a causal, windowed or chunked one raises.

    Under grad mode with an input that requires grad (training), the call
    goes through the autograd Function ``trainable_flash_attention``, whose
    backward is the recompute backward of the JAX ``custom_vjp``; on the
    card its kernels take every form the forward kernel takes (causal or
    not, a window, a chunk, cross attention at head dims (64, 64), the head
    dims (64, 64), (128, 128) and MLA's (96, 64)), so every attention stack
    of the zoo trains there. Every other call (serving) launches the
    forward kernel directly."""
    if attn_type not in (ATTN_FULL, ATTN_SWA, ATTN_CHUNKED_LOCAL):
        raise NotImplementedError(f"blockwise_attention: unknown attn_type {attn_type!r}")
    window = window if attn_type == ATTN_SWA else 0
    chunk = chunk if attn_type == ATTN_CHUNKED_LOCAL else 0
    if k.shape[1] != q.shape[1] and (causal or window or chunk):
        raise NotImplementedError(
            f"blockwise_attention: cross attention (S={q.shape[1]}, S_kv={k.shape[1]}) is "
            f"full and non-causal only; got causal={causal}, window={window}, chunk={chunk}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return trainable_flash_attention(q, k, v, causal=causal, window=window, chunk=chunk)
    return flash_attention(q, k, v, causal=causal, window=window, chunk=chunk)


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
    attend: (B, Sc) bool for pos (B,), (1, Sc) for a 0-d pos, as the JAX
    function gives it. A full-attention cache: the slots filled so far; an
    SWA ring: those too, and once wrapped (pos + 1 >= Sc) every slot. Both
    are ``slot < min(pos + 1, Sc)``. A chunked-local ring (``chunk`` > 0):
    the pos % chunk + 1 newest slots, ring order, the query's own among
    them; on a ring of Sc = chunk slots (position p at slot p % Sc) that is
    ``slot < pos % chunk + 1``, and on a shorter one (Sc = S < chunk, so pos
    < Sc) ``slot < pos + 1``. These are the ``lengths`` the decode stacks
    hand their kernel (``transformer.decode_lengths``)."""
    if attn_type not in (ATTN_FULL, ATTN_SWA, ATTN_CHUNKED_LOCAL):
        raise NotImplementedError(
            f"cache_validity ports full-attention caches, SWA and chunked-local rings; "
            f"got attn_type={attn_type!r}")
    p = pos.long().reshape(-1, 1)
    slots = torch.arange(cache_len, device=pos.device)
    if attn_type == ATTN_CHUNKED_LOCAL and chunk:
        return (p % cache_len - slots) % cache_len < p % chunk + 1
    return slots < torch.clamp(p + 1, max=cache_len)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention): minicpm3
# ---------------------------------------------------------------------------


def mla_latents(params, x, cfg, rope):
    """The compressed cache entries of x (B, S, D): c_kv (B, S, kv_lora),
    the normed latent, and k_rope (B, S, 1, rope), the shared rope key
    rotated by ``rope`` (the rope tables of the tokens' positions)."""
    kv_a = x @ params["wkv_a"]                                   # (B, S, kv_lora + rope)
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope_tables(kv_a[..., cfg.kv_lora_rank:][:, :, None, :], *rope)
    return c_kv, k_rope


def mla_queries(params, x, cfg, rope):
    """The queries of x (B, S, D) through the low-rank ``wq_a`` -> norm ->
    ``wq_b``: q_nope (B, S, H, nope) and q_rope (B, S, H, rope), rotated."""
    B, S, _ = x.shape
    nope = cfg.qk_nope_head_dim
    cq = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = (cq @ params["wq_b"]).reshape(B, S, cfg.num_heads, nope + cfg.qk_rope_head_dim)
    return q[..., :nope], apply_rope_tables(q[..., nope:], *rope)


def mla_prefill(params, x, cfg, rope):
    """Expanded MLA attention over a sequence x (B, S, D): the latents
    expanded through ``wkv_b`` to H heads of nope key and v value dims, the
    shared k_rope broadcast to every head, causal attention at query/key
    head dim nope + rope and value head dim v (``blockwise_attention``,
    whose scale, 1/sqrt of q's head dim, is 1/sqrt(nope + rope)), then
    ``wo``. Returns (out (B, S, D),
    (c_kv, k_rope)), the compressed cache entries."""
    B, S, _ = x.shape
    H, nope, v_dim = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope = mla_queries(params, x, cfg, rope)
    c_kv, k_rope = mla_latents(params, x, cfg, rope)
    kv = (c_kv @ params["wkv_b"]).reshape(B, S, H, nope + v_dim)
    k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, cfg.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = blockwise_attention(q, k, kv[..., nope:].contiguous(), attn_type=ATTN_FULL)
    return out.reshape(B, S, H * v_dim) @ params["wo"], (c_kv, k_rope)


def mla_decode(params, x, cfg, c_kv_cache, k_rope_cache, pos, rope):
    """Absorbed MLA decode: the queries move into the latent space (q_nope
    through ``wkv_b``'s key half), so the cache is read once with no
    per-step expansion. x: (B, 1, D); c_kv_cache: (B, Sc, kv_lora);
    k_rope_cache: (B, Sc, rope); pos: (B,) (slots <= pos are valid);
    ``rope``: the rope tables of pos. Scores in float32 (JAX's
    ``preferred_element_type``), the probabilities cast to the cache dtype
    for the latent value product. Returns (B, 1, D)."""
    B, Sc = x.shape[0], c_kv_cache.shape[1]
    H, nope, v_dim = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope = mla_queries(params, x, cfg, rope)           # (B, 1, H, nope / rope)
    w_b = params["wkv_b"].reshape(cfg.kv_lora_rank, H, nope + v_dim)
    q_lat = torch.einsum("bqhn,khn->bqhk", q_nope, w_b[..., :nope])   # (B, 1, H, kv_lora)
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
    scores = (torch.einsum("bqhk,bsk->bhqs", q_lat.float(), c_kv_cache.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), k_rope_cache.float())) * scale
    valid = torch.arange(Sc, device=x.device)[None] <= pos.long()[:, None]
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(c_kv_cache.dtype)
    out_lat = torch.einsum("bhqs,bsk->bqhk", probs, c_kv_cache)
    out = torch.einsum("bqhk,khv->bqhv", out_lat, w_b[..., nope:])
    return out.reshape(B, 1, H * v_dim) @ params["wo"]
