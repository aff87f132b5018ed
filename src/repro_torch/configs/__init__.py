"""Config registry of the port: every arch of the JAX package's zoo. The
paged serving path takes smollm-135m, qwen2.5-3b and phi3-medium-14b; the
dense backend serves rwkv6-7b, hymba-1.5b, mixtral-8x22b,
llama4-scout-17b-a16e, minicpm3-4b and internvl2-1b (text only); whisper-
large-v3 runs through the model API (``forward``, ``prefill``,
``decode_step``), as in the JAX package, whose engine has no frames input.
``VARIANTS`` holds qwen2.5-3b's sliding-window serving variant; ``SHAPES``
the four input shapes the dry run takes each arch through
(``arch_runs_shape``: long_500k for the sub-quadratic archs only)."""
from repro_torch.configs import (
    hymba_1_5b,
    internvl2_1b,
    llama4_scout_17b_a16e,
    minicpm3_4b,
    mixtral_8x22b,
    phi3_medium_14b,
    qwen2_5_3b,
    rwkv6_7b,
    smollm_135m,
    whisper_large_v3,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, smoke_variant

ARCHS = {
    "smollm-135m": smollm_135m.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "phi3-medium-14b": phi3_medium_14b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
    "minicpm3-4b": minicpm3_4b.CONFIG,
    "internvl2-1b": internvl2_1b.CONFIG,
    "whisper-large-v3": whisper_large_v3.CONFIG,
}

# variants used only in beyond-paper experiments
VARIANTS = {
    "qwen2.5-3b-swa": qwen2_5_3b.CONFIG_SWA,
}


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in VARIANTS:
        return VARIANTS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def arch_runs_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rules: long_500k only for sub-quadratic archs; decode shapes
    skip encoder-only archs (none assigned here)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True


def card_smoke_variant(name: str) -> ModelConfig:
    """The smoke variant of arch ``name`` as the card runs it: minicpm3's at
    MLA's real head dims (64 nope + 32 rope query/key dims, 64 value dims),
    since the smoke variant's 48 / 32 has no instantiation of the flash
    kernel; every other arch's unchanged."""
    cfg = smoke_variant(get_arch(name))
    if name == "minicpm3-4b":
        cfg = cfg.replace(qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64, head_dim=96)
    return cfg


__all__ = ["ARCHS", "SHAPES", "VARIANTS", "ModelConfig", "ShapeConfig", "arch_runs_shape",
           "card_smoke_variant", "get_arch", "get_shape", "smoke_variant"]
