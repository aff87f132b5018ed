"""llama4-scout-17b-a16e — MoE, 16 experts top-1 plus a shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L, d_model=5120, 40 heads (GQA kv=8),
expert d_ff=8192, vocab=202048. iRoPE: 3 of 4 layers use chunked local
attention (chunk 8192), every 4th layer is global, so the stack has period
4. The text backbone only, as the JAX package configures it; its RoPE runs
in every layer, global ones included, as in the JAX package.
"""
from repro_torch.configs.base import ATTN_CHUNKED_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attn_type=ATTN_CHUNKED_LOCAL,
    chunk_size=8192,
    global_layer_every=4,
    num_experts=16,
    num_experts_per_tok=1,
    n_shared_experts=1,
    source="Llama-4 Scout [hf:meta-llama/Llama-4-Scout-17B-16E]",
)
