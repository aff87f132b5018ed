"""qwen2.5-3b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-3B] 36L, d_model=2048, 16 heads (GQA kv=2), d_ff=11008,
vocab=151936. Full attention; ``CONFIG_SWA`` is the sliding-window serving
variant (window 4096) of the JAX package.
"""
from repro_torch.configs.base import ATTN_FULL, ATTN_SWA, ModelConfig

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

# Sliding-window serving variant (Qwen2 supports SWA in its config)
CONFIG_SWA = CONFIG.replace(name="qwen2.5-3b-swa", attn_type=ATTN_SWA, window=4096)
