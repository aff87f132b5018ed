"""internvl2-1b — VLM: InternViT vision encoder (stub) + Qwen2-0.5B backbone.

[arXiv:2404.16821] 24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864,
vocab=151655, QKV bias (Qwen2-style), tied embeddings. The vision encoder is
a stub: the model takes ``num_patch_tokens`` precomputed patch embeddings
(B, 256, d_model) through ``patch_proj`` as a prefix of the text, as the
JAX package does.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    attn_type=ATTN_FULL,
    qkv_bias=True,
    rope_theta=1000000.0,
    num_patch_tokens=256,
    tie_embeddings=True,
    source="InternVL2 [arXiv:2404.16821]",
)
