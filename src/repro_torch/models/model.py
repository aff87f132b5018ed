"""Top-level model API of the serving paths, ported from
``repro.models.model``: ``init_params``; for the paged backend
``prefill_packed``, ``decode_step_paged`` and ``paged_cache_supported``;
for the dense backend ``forward``, ``prefill``, ``decode_step`` and
``init_cache``.

The paged step functions update the KV pools in place and return the
logits; ``decode_step`` updates the dense cache in place and returns it
with the logits. The dense functions take full-attention GQA stacks and
RWKV-6 stacks (``dense_cache_supported``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ATTN_FULL, MIXER_RWKV6, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init, embed_tokens, unembed
from repro_torch.params import torch_dtype


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random weights with the JAX ``init_params`` tree, shapes and scales
    (embedding and lm_head N(0, 0.02), projections N(0, 1/d_in), zero QKV
    biases, unit norms; RWKV-6 layers as ``rwkv6.init_rwkv6``), drawn from
    ``generator`` on its own device and placed on ``device``. Dense GQA
    and RWKV-6 stacks only."""
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


def _token_frontend(cfg) -> bool:
    """The frontends the port has: token embeddings, with rope positions in
    the layers or (attention-free stacks) no positions at all. Patch and
    meta-token prefixes, encoder frames and sinusoidal positions are not
    ported yet."""
    return not (cfg.num_patch_tokens or cfg.num_meta_tokens or cfg.is_encoder_decoder) \
        and (cfg.use_rope or cfg.attention_free)


def _embed_inputs(cfg, params, batch):
    """(B, S, D) token embeddings; an attention-free stack adds no
    positions, as the JAX function."""
    if not _token_frontend(cfg):
        raise NotImplementedError(f"{cfg.name}: only the token frontend is ported")
    return embed_tokens(params["embed"], batch["tokens"])


def dense_cache_supported(cfg: ModelConfig) -> bool:
    """Whether the port's dense backend serves this architecture: a
    period-1 stack of full-attention GQA layers or of RWKV-6 layers, with
    the token frontend."""
    return tfm.dense_stack_supported(cfg) and _token_frontend(cfg)


def forward(cfg, params, batch, want_cache: bool = False, logits_mode: str = "all"):
    """batch {"tokens": (B, S) int} -> (logits (B, S, V), aux) or, with
    ``want_cache``, (logits, aux, caches): the serve cache of the whole
    sequence, a tuple of one entry ({k, v} of (G, B, S, KVH, hd), or an
    RWKV-6 stack's state and token shifts, see ``transformer.run_stack_seq``).
    ``logits_mode="last"`` unembeds the last position only. Pad-vocab
    logits are masked to -1e30."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, caches, aux = tfm.run_stack_seq(cfg, params["blocks"], x, positions)
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    if logits_mode == "last":
        x = x[:, -1:]
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg.tie_embeddings)
    logits = _pad_vocab_bias(cfg, logits)
    if want_cache:
        return logits, aux, caches
    return logits, aux


def prefill(cfg, params, batch):
    """Run the prompt through the model: (last-position logits (B, V), the
    serve cache)."""
    logits, _, caches = forward(cfg, params, batch, want_cache=True, logits_mode="last")
    return logits[:, -1], caches


def decode_step(cfg, params, caches, tokens, pos):
    """One dense decode step. tokens: (B, 1) int; pos: (B,) int32 absolute
    position of each row's new token (<= Sc - 1; unused by RWKV-6). Writes
    the new K/V (or state) into ``caches`` in place; returns (logits (B, V),
    caches). Like the JAX function, it applies no pad-vocab bias."""
    x = embed_tokens(params["embed"], tokens)
    x, caches = tfm.run_stack_decode(cfg, params["blocks"], x, caches, pos)
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg.tie_embeddings)
    return logits[:, 0], caches


def init_cache(cfg: ModelConfig, B: int, S: int, device):
    """Zero-initialised dense serve cache for B rows of S tokens on
    ``device``: a tuple of one {k, v} entry of (G, B, S, KVH, hd) in the
    config's dtype (full attention: Sc = S), or for RWKV-6 {state (G, B, H,
    hd, hd) float32, x_prev_att, x_prev_ffn (G, B, D) in the config's dtype},
    whatever S. The int8 cache (``kv_cache_quant``) is not ported yet."""
    tfm._check_dense_stack(cfg)
    if cfg.kv_cache_quant:
        raise NotImplementedError("the int8 dense cache is not ported yet")
    dtype = torch_dtype(cfg)
    G = cfg.num_layers
    if cfg.attn_type == MIXER_RWKV6:
        hd = cfg.rwkv_head_dim
        H = cfg.d_model // hd
        return ({"state": torch.zeros((G, B, H, hd, hd), dtype=torch.float32, device=device),
                 "x_prev_att": torch.zeros((G, B, cfg.d_model), dtype=dtype, device=device),
                 "x_prev_ffn": torch.zeros((G, B, cfg.d_model), dtype=dtype, device=device)},)
    shape = (G, B, S, cfg.num_kv_heads, cfg.head_dim)
    return ({"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)},)


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
