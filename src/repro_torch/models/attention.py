"""GQA projections, ported from ``repro.models.attention`` (``qkv_project``
only: the paged path reads attention through ``kernels.decode_attention``)."""
from __future__ import annotations


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
