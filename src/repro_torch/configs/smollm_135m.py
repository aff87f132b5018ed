"""smollm-135m — llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-135M] 30L, d_model=576, 9 heads (GQA kv=3),
d_ff=1536, vocab=49152. This is also the end-to-end training-demo arch
(examples/train_smollm.py). Full attention => long_500k skipped.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    attn_type=ATTN_FULL,
    tie_embeddings=True,
    source="SmolLM [hf:HuggingFaceTB/SmolLM-135M]",
)
