"""Top-level model API of the paged serving path, ported from
``repro.models.model``: ``init_params``, ``prefill_packed``,
``decode_step_paged`` and ``paged_cache_supported``.

Both step functions update the KV pools in place and return the logits.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ATTN_FULL, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init, embed_tokens, unembed
from repro_torch.params import torch_dtype


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random weights with the JAX ``init_params`` tree, shapes and scales
    (embedding and lm_head N(0, 0.02), projections N(0, 1/d_in), zero QKV
    biases, unit norms), drawn from ``generator`` on its own device and
    placed on ``device``. Dense GQA stacks only."""
    dtype = torch_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": {"table": dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                      dtype, device, scale=0.02)},
        "blocks": tfm._stack_layers(generator, cfg, dtype, device),
        "final_norm": tfm.init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                             dtype, device, scale=0.02)}
    return params


def _pad_vocab_bias(cfg, logits):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = torch.arange(cfg.padded_vocab, device=logits.device)
    bias = torch.where(ids < cfg.vocab_size, 0.0, -1e30).to(logits.dtype)
    return logits + bias


def prefill_packed(cfg, params, k_pool, v_pool, tables, tokens, row_of, slots,
                   positions, p_end, s_start, *, block_size, null_block):
    """Ragged fused step: T packed tokens (decode rows + prefill chunks from
    different sequences) run against the paged pools directly, writing their
    K/V in place before attending. tokens/row_of/slots/positions/p_end/
    s_start: (T,) int32; tables: (B, mb) int32 RAW. Returns logits (T, V),
    pad-vocab entries masked to -1e30. Requires ``paged_cache_supported``."""
    x = embed_tokens(params["embed"], tokens[None])          # (1, T, D)
    x = tfm.run_stack_paged(
        cfg, params["blocks"], x, k_pool, v_pool, tables, row_of, slots,
        positions, p_end, s_start, block_size=block_size, null_block=null_block,
    )
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg.tie_embeddings)
    return _pad_vocab_bias(cfg, logits)[0]


def decode_step_paged(cfg, params, k_pool, v_pool, tables, tokens, pos, *,
                      block_size, null_block):
    """Paged decode: one new token per row attends its block chain in place.
    tokens: (B, 1); pos: (B,) int32. Returns logits (B, V). Like the JAX
    function, it applies no pad-vocab bias (the archs the paged path takes
    have vocabularies that are multiples of 128)."""
    x = embed_tokens(params["embed"], tokens)
    x = tfm.run_stack_decode_paged(
        cfg, params["blocks"], x, k_pool, v_pool, tables, pos,
        block_size=block_size, null_block=null_block,
    )
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg.tie_embeddings)
    return logits[:, 0]


def paged_cache_supported(cfg: ModelConfig) -> bool:
    """Whether the paged serving path supports this architecture: a
    homogeneous full-attention GQA decoder with rope positions and a plain
    token frontend."""
    return (
        tfm.period(cfg) == 1
        and cfg.attn_type == ATTN_FULL
        and cfg.use_rope
        and not cfg.is_encoder_decoder
        and not cfg.num_meta_tokens
        and not cfg.num_patch_tokens
    )
