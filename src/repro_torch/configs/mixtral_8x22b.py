"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088] 56L, d_model=6144, 48 heads (GQA kv=8), expert d_ff=16384,
vocab=32768. Sliding-window attention (window 4096) in every layer, as the
JAX package configures it.
"""
from repro_torch.configs.base import ATTN_SWA, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attn_type=ATTN_SWA,
    window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    source="Mixtral [arXiv:2401.04088]",
)
