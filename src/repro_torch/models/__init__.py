"""Model API of the port (paged serving path)."""
from repro_torch.models.model import (
    decode_step_paged,
    init_params,
    paged_cache_supported,
    prefill_packed,
)

__all__ = ["decode_step_paged", "init_params", "paged_cache_supported",
           "prefill_packed"]
