"""hymba-1.5b — hybrid heads: parallel attention and Mamba heads per layer.

[arXiv:2411.13676] 32L, d_model=1600, 25 heads (GQA kv=5), d_ff=5504,
vocab=32001, ssm_state=16, 128 meta tokens. The attention side uses a
1024-token sliding window in every layer (Hymba keeps global attention in 3
layers; the JAX package models the SWA majority, and the port copies that
simplification).
"""
from repro_torch.configs.base import MIXER_HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_type=MIXER_HYBRID,
    window=1024,
    ssm_state=16,
    num_meta_tokens=128,
    source="Hymba [arXiv:2411.13676]",
)
