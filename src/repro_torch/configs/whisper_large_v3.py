"""whisper-large-v3 — encoder-decoder audio backbone (conv frontend stubbed).

[arXiv:2212.04356] 32L decoder (+32L encoder), d_model=1280, 20 heads
(kv=20, i.e. MHA), d_ff=5120 (GELU MLP), vocab=51866, sinusoidal positions
(no rope), layer norms with bias. The model takes precomputed frame
embeddings (B, 1500, d_model) through ``frame_proj``, as the JAX package
does; each decoder layer cross-attends the encoder's output.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    attn_type=ATTN_FULL,
    use_rope=False,
    act="gelu",
    is_encoder_decoder=True,
    encoder_layers=32,
    encoder_seq=1500,
    source="Whisper [arXiv:2212.04356]",
)
