"""The card's peaks and the FLOPs of a served token: the benchmark's frozen
yardstick.

The rates are a frozen copy of ``src/repro_torch/kernels/work.py``'s
``HBM_BYTES_S`` and ``PEAK_OPS_S`` (NVIDIA's H100 datasheet, SXM5 column,
dense rates without sparsity, at the 700 W limit); ``causal_keys`` is the
closed form of ``visible_pairs`` there for a causal row range. The FLOPs of
one token follow the same count as its ``flash_work`` / ``decode_work``:
4 * hd a query head and visible key (the score and the value product), plus
2 * each weight matrix's parameters for the projections and the MLP; the
head's 2 * D * V only where the token's logits are sampled.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12}


def causal_keys(lo: int, hi: int) -> int:
    """Keys the causal rows [lo, hi) attend in all: sum of (t + 1)."""
    if hi <= lo:
        return 0
    return (hi * (hi + 1) - lo * (lo + 1)) // 2


def layer_matmul_params(m: dict) -> int:
    D, F = m["hidden_size"], m["intermediate_size"]
    q = m["num_attention_heads"] * m["head_dim"]
    kv = m["num_key_value_heads"] * m["head_dim"]
    return D * (q + 2 * kv) + q * D + 3 * D * F


def token_flops(m: dict, tokens: int, keys: int, sampled: int) -> float:
    """FLOPs of ``tokens`` tokens through every layer that attend ``keys``
    keys in all (a layer each), plus the head for ``sampled`` of them."""
    L = m["num_hidden_layers"]
    attn = 4 * m["num_attention_heads"] * m["head_dim"] * keys
    return (2.0 * layer_matmul_params(m) * tokens * L + float(attn) * L
            + 2.0 * m["hidden_size"] * m["vocab_size"] * sampled)
