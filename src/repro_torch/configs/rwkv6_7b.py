"""rwkv6-7b — Finch: attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 32L, d_model=4096, d_ff=14336, vocab=65536. Head dim 64
(=> 64 wkv heads), no rope. The serve state is a (64 x 64) f32 matrix per
head plus two token-shift vectors per layer, whatever the context length.
"""
from repro_torch.configs.base import MIXER_RWKV6, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attn_type=MIXER_RWKV6,
    use_rope=False,
    rwkv_head_dim=64,
    source="Finch: RWKV-6 [arXiv:2404.05892]",
)
