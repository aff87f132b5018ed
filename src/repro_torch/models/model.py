"""Top-level model API of the serving paths, ported from
``repro.models.model``: ``init_params``; for the paged backend
``prefill_packed``, ``decode_step_paged``, ``paged_cache_supported`` and,
for its oracle steps over a gathered contiguous view, ``prefill_chunk``;
for the dense backend ``forward``, ``prefill``, ``decode_step`` and
``init_cache``, which take every arch of the zoo; and for training
``loss_fn`` and ``make_train_step``.

The paged step functions update the KV pools in place and return the
logits; ``decode_step`` updates the dense cache in place and returns it
with the logits. The dense functions take full-attention, sliding-window
and chunked-local GQA stacks (with SwiGLU or MoE feed-forwards; llama4's
period-4 stack of chunked-local and global layers), MLA stacks (minicpm3),
RWKV-6 stacks, Hymba's hybrid stacks with their meta-token prefix,
internvl2's patch prefix and whisper's encoder-decoder stack with its
sinusoidal positions (``dense_cache_supported``), and the int8 dense cache
(``kv_cache_quant``). ``abstract_params``, ``abstract_cache`` and
``input_specs`` give the same trees on the meta device (shapes and dtypes
only), for the dry run (``launch.dryrun``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import (
    ATTN_CHUNKED_LOCAL,
    ATTN_FULL,
    ATTN_MLA,
    ATTN_SWA,
    MIXER_HYBRID,
    MIXER_RWKV6,
    ModelConfig,
    ShapeConfig,
)
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    dense_init,
    embed_tokens,
    sinusoidal_at,
    sinusoidal_positions,
    unembed,
)
from repro_torch.optim.adamw import global_norm
from repro_torch.params import torch_dtype, tree_leaves, tree_map


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random weights with the JAX ``init_params`` tree, shapes and scales
    (embedding and lm_head N(0, 0.02), projections N(0, 1/d_in), zero QKV
    and MLP biases, unit norms; MoE layers as ``moe.init_moe``, MLA layers
    as ``transformer.init_mla``, RWKV-6 layers as ``rwkv6.init_rwkv6``,
    hybrid layers' SSM as ``ssm.init_ssm``, meta tokens N(0, 0.02); a patch
    prefix's ``patch_proj`` and an encoder-decoder's ``frame_proj`` (D, D)
    at 1/sqrt(D), with the encoder's ``enc_blocks`` and ``enc_final_norm``),
    drawn from ``generator`` on its own device and placed on ``device``;
    ``blocks`` a list of one tree per position in the period (``transformer.
    _stack_layers``). The stacks of ``dense_cache_supported`` only."""
    dtype = torch_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": {"table": dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                      dtype, device, scale=0.02)},
        "blocks": tfm._stack_layers(generator, cfg, dtype, device),
        "final_norm": tfm.init_norm(cfg, dtype, device),
    }
    square = lambda: {"w": dense_init(generator, (cfg.d_model, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                             dtype, device, scale=0.02)}
    if cfg.num_meta_tokens:
        params["meta_tokens"] = dense_init(generator, (cfg.num_meta_tokens, cfg.d_model),
                                           dtype, device, scale=0.02)
    if cfg.num_patch_tokens:
        params["patch_proj"] = square()
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = tfm._stack_layers(generator, cfg, dtype, device, encoder=True)
        params["enc_final_norm"] = tfm.init_norm(cfg, dtype, device)
        params["frame_proj"] = square()
    return params


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The ``init_params`` tree on the meta device: every leaf's shape and
    dtype, nothing drawn or allocated (the JAX package's ``jax.eval_shape``
    of ``init_params``)."""
    return init_params(cfg, None, "meta")


def _pad_vocab_bias(cfg, logits):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = torch.arange(cfg.padded_vocab, device=logits.device)
    bias = torch.where(ids < cfg.vocab_size, 0.0, -1e30).to(logits.dtype)
    return logits + bias


def _sinusoidal(cfg) -> bool:
    """Whether the stack takes sinusoidal positions at its input (whisper:
    an encoder-decoder, or any stack without rope that has attention), as
    the JAX frontend adds them."""
    return (cfg.is_encoder_decoder or not cfg.use_rope) and not cfg.attention_free


def _embed_inputs(cfg, params, batch):
    """Returns (x (B, S_total, D), n_prefix): the token embeddings behind a
    prefix of n_prefix non-text positions, as the JAX function builds it:
    the batch's ``patch_embeds`` (B, P, D) through ``patch_proj`` where the
    config has a patch prefix and the batch carries them (a batch without
    them gets no prefix), then the ``num_meta_tokens`` meta tokens in front
    of everything where the config has them; sinusoidal positions added
    where the stack takes them (``_sinusoidal``). An attention-free stack
    adds no positions."""
    x = embed_tokens(params["embed"], batch["tokens"])
    n_prefix = 0
    if cfg.num_patch_tokens and "patch_embeds" in batch:
        patches = batch["patch_embeds"].to(x.dtype) @ params["patch_proj"]["w"]
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    if cfg.num_meta_tokens:
        meta = params["meta_tokens"].to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
        n_prefix += cfg.num_meta_tokens
    if _sinusoidal(cfg):
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    return x, n_prefix


def _encode(cfg, params, frames):
    """The encoder of an encoder-decoder stack: frames (B, S_enc, D) through
    ``frame_proj``, sinusoidal positions, the encoder's layers (causal, as
    in the JAX package: ROADMAP §3) and ``enc_final_norm``. Returns (B,
    S_enc, D) in the model dtype."""
    x = frames.to(torch_dtype(cfg)) @ params["frame_proj"]["w"]
    B, Se, _ = x.shape
    x = x + sinusoidal_positions(Se, cfg.d_model, x.device)[None].to(x.dtype)
    positions = torch.arange(Se, dtype=torch.int32, device=x.device)[None].expand(B, Se)
    x, _, _ = tfm.run_stack_seq(cfg, params["enc_blocks"], x, positions, encoder=True,
                                want_cache=False)
    return tfm.apply_norm(cfg, params["enc_final_norm"], x)


def dense_cache_supported(cfg: ModelConfig) -> bool:
    """Whether the port's dense stacks take this architecture: the stacks
    of ``transformer.dense_stack_supported`` (full-attention,
    sliding-window, chunked-local or MLA layers with SwiGLU or MoE, RWKV-6
    layers, hybrid layers, or an encoder-decoder stack), with any frontend
    of the zoo (meta tokens, a patch prefix, encoder frames)."""
    return tfm.dense_stack_supported(cfg)


def has_recurrent_state(cfg: ModelConfig) -> bool:
    """Whether the stack carries a recurrent state through its cache (RWKV-6,
    or the SSM of a hybrid stack): a prompt padded to a bucket would carry
    its pad tokens into that state."""
    return cfg.attention_free or cfg.attn_type == MIXER_HYBRID


def prefills_unpadded(cfg: ModelConfig) -> bool:
    """Whether a prompt must be prefilled at its own length, not padded to
    a bucket: a recurrent state would carry the pad tokens
    (``has_recurrent_state``), and a sliding-window ring as long as the
    window, or a chunked-local ring as long as the chunk, would keep pads in
    place of the prompt's last keys (the JAX engine pads: ROADMAP §3)."""
    return has_recurrent_state(cfg) or cfg.attn_type in (ATTN_SWA, ATTN_CHUNKED_LOCAL)


def forward(cfg, params, batch, want_cache: bool = False, logits_mode: str = "all"):
    """batch {"tokens": (B, S) int} (with "patch_embeds" (B, P, D) for a
    patch-prefix stack, "frames" (B, S_enc, D) for an encoder-decoder) ->
    (logits (B, S, V), aux) or, with ``want_cache``, (logits, aux, caches):
    the serve cache of the whole sequence, prefix included (a tuple of one
    entry per position in the period: {k, v} of (G, B, S, KVH, hd), int8
    with scales for ``kv_cache_quant``, a sliding-window or chunked-local
    layer's K/V ring, an MLA layer's latents, an RWKV-6 stack's state and
    token shifts, a hybrid stack's K/V ring and SSM state, or an
    encoder-decoder's self-attention K/V with the cross keys and values
    {ck, cv} of the encoder's output, see ``transformer.run_stack_seq``);
    aux is the sum of the MoE layers' load-balance losses (zero without
    MoE). The logits are those of the text positions (the meta or patch
    prefix is stripped); ``logits_mode="last"`` unembeds the last position
    only. Pad-vocab logits are masked to -1e30."""
    x, n_prefix = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    enc_out = _encode(cfg, params, batch["frames"]) if cfg.is_encoder_decoder else None
    x, caches, aux = tfm.run_stack_seq(cfg, params["blocks"], x, positions, enc_out,
                                       want_cache=want_cache)
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    if logits_mode == "last":
        x = x[:, -1:]
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg.tie_embeddings)
    logits = _pad_vocab_bias(cfg, logits)
    if want_cache:
        return logits, aux, caches
    return logits, aux


def loss_fn(cfg, params, batch):
    """Mean next-token negative log-likelihood of ``batch["tokens"]`` from a
    float32 log-softmax of the logits, plus 0.01 x the MoE load-balance
    loss: (total, {loss, aux_loss, total})."""
    logits, aux = forward(cfg, params, batch)
    logits = logits[:, :-1].float()
    targets = batch["tokens"][:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "total": total}


def make_train_step(cfg, optimizer, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), as the JAX function does. The parameters become leaves that
    require grad; the gradients of ``loss_fn`` come from
    ``torch.autograd.grad`` (the stack recomputes each layer group in the
    backward, see ``transformer.run_stack_seq``). ``microbatches > 1``
    splits the batch along its first axis and accumulates the gradients in
    float32, divided by their count; the metrics are the microbatches'
    means. ``grad_norm`` is the global norm of those gradients, before the
    optimizer clips them. The optimizer updates the parameters in place
    (``optim.adamw``), so the returned params are the tensors passed in."""
    def grads_of(leaves, params, batch):
        total, metrics = loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches <= 1:
            metrics, grads = grads_of(leaves, params, batch)
        else:
            ub = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                  for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            ms = []
            for i in range(microbatches):
                m, g = grads_of(leaves, params, {k: v[i] for k, v in ub.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                ms.append(m)
            for acc in grads:
                acc.div_(microbatches)
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state = optimizer.update(params, grads, opt_state)
        metrics["grad_norm"] = global_norm(grads)
        return params, opt_state, metrics

    return train_step


def prefill(cfg, params, batch):
    """Run the prompt through the model: (last-position logits (B, V), the
    serve cache)."""
    logits, _, caches = forward(cfg, params, batch, want_cache=True, logits_mode="last")
    return logits[:, -1], caches


def decode_embed(cfg, params, tokens, pos):
    """The input of a decode step: the embeddings of ``tokens`` (B, 1), plus
    each row's sinusoidal position at ``pos`` (B,) where the stack takes
    them (``_sinusoidal``). (B, 1, D)."""
    x = embed_tokens(params["embed"], tokens)
    if _sinusoidal(cfg):
        x = x + sinusoidal_at(pos, cfg.d_model)[:, None].to(x.dtype)
    return x


def decode_step(cfg, params, caches, tokens, pos, tp_group=None):
    """One dense decode step. tokens: (B, 1) int; pos: (B,) int32 absolute
    position of each row's new token, a meta or patch prefix included (<=
    Sc - 1 on a full-attention cache; unused by RWKV-6). Writes the new K/V
    (or state) into ``caches`` in place; returns (logits (B, V), caches).
    Pad-vocab logits are masked to -1e30, as ``forward`` masks them:
    hymba's vocab (32001) is the first the dense backend serves that is not
    a multiple of 128, internvl2's (151655) and whisper's (51866) are not
    either. The JAX function omits the mask (ROADMAP §3); for every other
    arch served the mask is a no-op, so the port still agrees with it
    there. ``tp_group``: the tensor-parallel group whose rank's shard
    ``params`` hold (None: unsharded; ``transformer.run_stack_decode``)."""
    x = decode_embed(cfg, params, tokens, pos)
    x, caches = tfm.run_stack_decode(cfg, params["blocks"], x, caches, pos, tp_group)
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg.tie_embeddings)
    return _pad_vocab_bias(cfg, logits)[:, 0], caches


def init_cache(cfg: ModelConfig, B: int, S: int, device):
    """Zero-initialised dense serve cache for B rows of S tokens (a meta or
    patch prefix included) on ``device``: a tuple of one entry per position
    in the period, each with a leading axis of G = L / p layer groups. A GQA
    layer's {k, v} of (G, B, Sc, KVH, hd) in the config's dtype (full
    attention: Sc = S; sliding window: a ring of Sc = min(S, window);
    chunked-local: a ring of Sc = min(S, chunk); hybrid: the window's ring,
    plus the SSM's conv (G, B, K-1, D) in the config's dtype and h (G, B, D,
    N) float32), for ``kv_cache_quant`` int8 with float32 scales {k_scale,
    v_scale} (G, B, Sc, KVH); an encoder-decoder's decoder entry adds the
    cross keys and values {ck, cv} (G, B, encoder_seq, KVH, hd) in the
    config's dtype; an MLA layer's {c_kv (G, B, S, kv_lora), k_rope (G, B,
    S, rope)}; or for RWKV-6 {state (G, B, H, hd, hd) float32, x_prev_att,
    x_prev_ffn (G, B, D) in the config's dtype}, whatever S. MLA, RWKV-6
    and the cross entries stay in float with ``kv_cache_quant``, as in
    JAX."""
    tfm._check_dense_stack(cfg)
    dtype = torch_dtype(cfg)
    G = cfg.num_layers // tfm.period(cfg)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if cfg.attn_type == MIXER_RWKV6:
        hd = cfg.rwkv_head_dim
        H = cfg.d_model // hd
        return ({"state": zeros(G, B, H, hd, hd, dt=torch.float32),
                 "x_prev_att": zeros(G, B, cfg.d_model),
                 "x_prev_ffn": zeros(G, B, cfg.d_model)},)
    KVH, hd = cfg.num_kv_heads, cfg.head_dim

    def entry(kind):
        Sc = tfm.cache_len_for(cfg, kind, S)
        if kind["attn_type"] == ATTN_MLA:
            return {"c_kv": zeros(G, B, Sc, cfg.kv_lora_rank),
                    "k_rope": zeros(G, B, Sc, cfg.qk_rope_head_dim)}
        kv_dt = torch.int8 if cfg.kv_cache_quant else dtype
        e = {"k": zeros(G, B, Sc, KVH, hd, dt=kv_dt), "v": zeros(G, B, Sc, KVH, hd, dt=kv_dt)}
        if cfg.kv_cache_quant:
            e["k_scale"] = zeros(G, B, Sc, KVH, dt=torch.float32)
            e["v_scale"] = zeros(G, B, Sc, KVH, dt=torch.float32)
        if kind["attn_type"] == MIXER_HYBRID:
            e["conv"] = zeros(G, B, cfg.ssm_conv - 1, cfg.d_model)
            e["h"] = zeros(G, B, cfg.d_model, cfg.ssm_state, dt=torch.float32)
        if cfg.is_encoder_decoder:
            e["ck"] = zeros(G, B, cfg.encoder_seq, KVH, hd)
            e["cv"] = zeros(G, B, cfg.encoder_seq, KVH, hd)
        return e

    return tuple(entry(kind) for kind in tfm._kinds(cfg))


def abstract_cache(cfg: ModelConfig, B: int, S: int):
    """``init_cache`` on the meta device: shapes and dtypes only."""
    return init_cache(cfg, B, S, "meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The model inputs of an assigned shape as meta tensors (the JAX
    function's ``ShapeDtypeStruct`` stand-ins): decode one token a row;
    otherwise the tokens, a VLM's patch embeddings taking
    ``num_patch_tokens`` of the sequence, and an encoder-decoder's frames."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *shp, dt=torch.int32: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind == "decode":
        return {"tokens": meta(B, 1)}
    dtype = torch_dtype(cfg)
    batch: Dict[str, Any] = {}
    if cfg.num_patch_tokens:
        batch["tokens"] = meta(B, S - cfg.num_patch_tokens)
        batch["patch_embeds"] = meta(B, cfg.num_patch_tokens, cfg.d_model, dt=dtype)
    else:
        batch["tokens"] = meta(B, S)
    if cfg.is_encoder_decoder:
        batch["frames"] = meta(B, cfg.encoder_seq, cfg.d_model, dt=dtype)
    return batch


def prefill_chunk(cfg, params, caches, tokens, pos, positions=None,
                  seg_prefix_end=None, seg_start=None, tp_group=None):
    """Chunked prefill: C tokens (B, C) per row at cache slots ``pos ..
    pos+C-1`` (``pos`` an int, a 0-d tensor or (B,) per-row starts) run
    against the contiguous serve cache ({k, v} of (G, B, Sc, KVH, hd)),
    writing their K/V into it IN PLACE. ``positions``/``seg_prefix_end``/
    ``seg_start`` (B, C) carry a segmented prompt's rope positions and
    attention spans (``transformer._prefix_mask``). Returns (logits (B, C,
    V), caches), pad-vocab logits masked to -1e30. Full-attention GQA stacks
    with rope positions (``paged_cache_supported``); an int8 cache
    (``kv_cache_quant``: {k_scale, v_scale} in the entry) takes the chunk's
    codes and is read dequantized, as in JAX. ``tp_group`` as for
    ``decode_step``."""
    if not paged_cache_supported(cfg):
        raise NotImplementedError(f"{cfg.name}: chunked prefill takes the paged path's stacks only")
    x = embed_tokens(params["embed"], tokens)
    x, caches = tfm.run_stack_prefix(cfg, params["blocks"], x, caches, pos, positions,
                                     seg_prefix_end, seg_start, tp_group)
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg.tie_embeddings)
    return _pad_vocab_bias(cfg, logits), caches


def prefill_packed(cfg, params, k_pool, v_pool, tables, tokens, row_of, slots,
                   positions, p_end, s_start, *, block_size, null_block,
                   k_scales=None, v_scales=None, impl="pallas", tp_group=None):
    """Ragged fused step: T packed tokens (decode rows + prefill chunks from
    different sequences) run against the paged pools directly, writing their
    K/V in place before attending. tokens/row_of/slots/positions/p_end/
    s_start: (T,) int32; tables: (B, mb) int32 RAW. An int8 pool passes its
    (G, n_blocks, KVH) running-max scale pools ``k_scales``/``v_scales``,
    updated in place with the pools. ``impl="pallas"`` reads attention
    through ``kernels.paged_chunk_attention`` (the kernel on the card),
    ``"reference"`` through its gather oracle; ``tp_group`` as for
    ``decode_step``. Returns logits (T, V), pad-vocab entries masked to
    -1e30. Requires ``paged_cache_supported``."""
    x = embed_tokens(params["embed"], tokens[None])          # (1, T, D)
    x = tfm.run_stack_paged(
        cfg, params["blocks"], x, k_pool, v_pool, tables, row_of, slots,
        positions, p_end, s_start, block_size=block_size, null_block=null_block,
        k_scales=k_scales, v_scales=v_scales, impl=impl, tp_group=tp_group,
    )
    x = tfm.apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], params.get("lm_head"), x, cfg.tie_embeddings)
    return _pad_vocab_bias(cfg, logits)[0]


def decode_step_paged(cfg, params, k_pool, v_pool, tables, tokens, pos, *,
                      block_size, null_block, k_scales=None, v_scales=None, tp_group=None):
    """Paged decode: one new token per row attends its block chain in place.
    tokens: (B, 1); pos: (B,) int32; ``k_scales``/``v_scales`` and
    ``tp_group`` as for ``prefill_packed``. Returns logits (B, V). Like the JAX
    function, it applies no pad-vocab bias, unlike the dense ``decode_step``:
    the archs the paged path takes have vocabularies that are multiples of
    128, so there is nothing to mask, and parity with JAX holds as is."""
    x = embed_tokens(params["embed"], tokens)
    x = tfm.run_stack_decode_paged(
        cfg, params["blocks"], x, k_pool, v_pool, tables, pos,
        block_size=block_size, null_block=null_block,
        k_scales=k_scales, v_scales=v_scales, tp_group=tp_group,
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
