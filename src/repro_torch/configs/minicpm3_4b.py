"""minicpm3-4b — dense, with multi-head latent attention (MLA).

[hf:openbmb/MiniCPM3-4B] 62L, d_model=2560, 40 heads, d_ff=6400, vocab=73448.
MLA dims follow the model card: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64. The serve cache
holds the compressed latent (kv_lora_rank + rope dims) per token.
"""
from repro_torch.configs.base import ATTN_MLA, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,              # qk head dim = nope (64) + rope (32)
    d_ff=6400,
    vocab_size=73448,
    attn_type=ATTN_MLA,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    source="MiniCPM3 [hf:openbmb/MiniCPM3-4B]",
)
