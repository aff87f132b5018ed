"""Config registry of the port: the three archs the paged serving path takes,
and rwkv6-7b, hymba-1.5b and mixtral-8x22b, which the dense backend serves;
``VARIANTS`` holds qwen2.5-3b's sliding-window serving variant."""
from repro_torch.configs import (
    hymba_1_5b,
    mixtral_8x22b,
    phi3_medium_14b,
    qwen2_5_3b,
    rwkv6_7b,
    smollm_135m,
)
from repro_torch.configs.base import ModelConfig, smoke_variant

ARCHS = {
    "smollm-135m": smollm_135m.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "phi3-medium-14b": phi3_medium_14b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
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


__all__ = ["ARCHS", "VARIANTS", "ModelConfig", "get_arch", "smoke_variant"]
