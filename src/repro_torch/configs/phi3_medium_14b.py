"""phi3-medium-14b — dense RoPE + SwiGLU + GQA.

[arXiv:2404.14219] 40L, d_model=5120, 40 heads (GQA kv=10), d_ff=17920,
vocab=100352. Full attention => long_500k skipped.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    attn_type=ATTN_FULL,
    source="Phi-3 [arXiv:2404.14219]",
)
