"""Model configuration for the PyTorch port.

A copy of ``repro.configs.base`` (the port imports nothing of ``repro``):
``ModelConfig`` with the same fields and derived quantities, the attention
kind constants and ``smoke_variant``. Configs are plain frozen dataclasses,
so constructing one has no framework side effects.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Attention / mixer kinds
# ---------------------------------------------------------------------------
ATTN_FULL = "full"              # causal full attention
ATTN_SWA = "swa"                # sliding-window attention
ATTN_CHUNKED_LOCAL = "chunked"  # llama4-style chunked local attention
ATTN_MLA = "mla"                # DeepSeek/MiniCPM3 multi-head latent attention
MIXER_RWKV6 = "rwkv6"           # attention-free, data-dependent decay (Finch)
MIXER_HYBRID = "hybrid"         # parallel attention + SSM heads (Hymba)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (field names as in ``repro``)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0               # 0 for attention-free archs
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention flavour ---------------------------------------------------
    attn_type: str = ATTN_FULL
    window: int = 4096               # SWA window
    chunk_size: int = 8192           # chunked-local attention chunk
    global_layer_every: int = 0      # >0: every k-th layer uses full attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True

    # --- MLA (minicpm3 / deepseek-style) -------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ------------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0        # llama4 shared expert
    moe_layer_every: int = 1         # 1 = every layer is MoE

    # --- SSM / RWKV ------------------------------------------------------------
    ssm_state: int = 0               # mamba state size (hymba)
    ssm_conv: int = 4                # depthwise conv width for mamba branch
    rwkv_head_dim: int = 64

    # --- encoder-decoder (whisper) ---------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- vlm --------------------------------------------------------------------
    num_patch_tokens: int = 0

    # --- hybrid (hymba) ----------------------------------------------------------
    num_meta_tokens: int = 0

    # --- activation / numerics ----------------------------------------------------
    kv_cache_quant: bool = False     # int8 KV cache
    kv_quant_scale: float = 0.05
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"                # silu (swiglu) | gelu (whisper-style mlp)
    dtype: str = "float32"           # compute dtype: float32 or bfloat16

    # --- citation --------------------------------------------------------------
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding/unembedding tables pad the vocab to a multiple of 128;
        pad logits are masked to -1e30. The logical vocab stays exact."""
        return (self.vocab_size + 127) // 128 * 128

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return self.attn_type == MIXER_RWKV6

    @property
    def subquadratic(self) -> bool:
        """True if the arch can serve a 500k-token context (bounded attention
        reach or recurrent state)."""
        return self.attn_type in (MIXER_RWKV6, MIXER_HYBRID, ATTN_SWA, ATTN_CHUNKED_LOCAL)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_is_moe(self, layer: int) -> bool:
        return self.is_moe and (layer % max(self.moe_layer_every, 1) == 0)

    def layer_attn_type(self, layer: int) -> str:
        """Per-layer attention flavour (llama4 iRoPE: every Nth layer global)."""
        if (
            self.attn_type == ATTN_CHUNKED_LOCAL
            and self.global_layer_every
            and (layer + 1) % self.global_layer_every == 0
        ):
            return ATTN_FULL
        return self.attn_type

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# input shapes (the JAX package's assigned four)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model 256, 4 heads."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=256,
        d_ff=512,
        vocab_size=512,
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = max(1, min(cfg.num_kv_heads, 2))
        kw["head_dim"] = 64
    if cfg.attn_type == ATTN_MLA:
        kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                  qk_rope_head_dim=16, v_head_dim=32)
    if cfg.is_moe:
        kw["num_experts"] = min(cfg.num_experts, 4)
        kw["num_experts_per_tok"] = min(cfg.num_experts_per_tok, 2)
    if cfg.attn_type == MIXER_RWKV6:
        kw["rwkv_head_dim"] = 32
    if cfg.attn_type == MIXER_HYBRID:
        kw["ssm_state"] = min(cfg.ssm_state, 8)
        kw["num_meta_tokens"] = min(cfg.num_meta_tokens, 8)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 64
    if cfg.num_patch_tokens:
        kw["num_patch_tokens"] = 16
    if cfg.global_layer_every:
        kw["global_layer_every"] = 2
    kw["chunk_size"] = min(cfg.chunk_size, 64)
    kw["window"] = min(cfg.window, 64)
    return cfg.replace(**kw)
