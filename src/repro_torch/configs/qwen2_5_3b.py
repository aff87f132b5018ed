"""qwen2.5-3b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-3B] 36L, d_model=2048, 16 heads (GQA kv=2), d_ff=11008,
vocab=151936. Full attention.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    attn_type=ATTN_FULL,
    qkv_bias=True,
    rope_theta=1000000.0,
    source="Qwen2.5 [hf:Qwen/Qwen2.5-3B]",
)
