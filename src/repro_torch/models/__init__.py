"""Model API of the port (paged and dense serving paths, training)."""
from repro_torch.models.model import (
    decode_step,
    decode_step_paged,
    dense_cache_supported,
    forward,
    has_recurrent_state,
    init_cache,
    init_params,
    loss_fn,
    make_train_step,
    paged_cache_supported,
    prefill,
    prefill_chunk,
    prefill_packed,
    prefills_unpadded,
)

__all__ = ["decode_step", "decode_step_paged", "dense_cache_supported", "forward",
           "has_recurrent_state", "init_cache", "init_params", "loss_fn", "make_train_step",
           "paged_cache_supported", "prefill",
           "prefill_chunk", "prefill_packed", "prefills_unpadded"]
