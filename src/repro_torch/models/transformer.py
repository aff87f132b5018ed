"""Layer stacks of the serving paths, ported from
``repro.models.transformer``: the paged stacks (ragged fused step, paged
decode) and the dense backend's stacks (whole-prompt prefill, contiguous
per-slot decode cache) of full-attention, sliding-window or chunked-local
GQA layers (llama4: three chunked layers, then a global one), of MLA layers
(minicpm3), of RWKV-6 layers and of Hymba's hybrid layers (sliding-window
attention and an SSM side by side). A GQA or hybrid layer's feed-forward is
a SwiGLU MLP or an MoE layer (``models.moe``).

A stack of period p (``period``: 4 for llama4, 1 for every other arch) holds
its parameters as ``transformer._stack_layers`` does in the JAX package: a
list of p trees, one per position in the period, every leaf of which
carries a leading axis of G = L / p layer groups; layer g * p + i is
position i of group g. Where JAX scans the groups with ``lax.scan``, the
port loops over g in Python and, inside, over the p positions, handing each
layer the ``g``-th slice of its position's leaves. The dense caches are a
tuple of p entries in the same way.

The KV pools are (G, n_blocks, bs, KVH, hd) tensors, the dense caches
(G, B, Sc, KVH, hd); an RWKV-6 stack's cache is its recurrent state (G, B,
H, hd, hd) float32 and two token-shift vectors (G, B, D); a sliding-window
layer's is a ring of Sc = min(S, window) K/V slots (position p at slot p %
Sc), a chunked-local layer's a ring of Sc = min(S, chunk) slots laid out the
same way, an MLA layer's the compressed latents c_kv (G, B, Sc, kv_lora)
and the roped k_rope (G, B, Sc, rope), and a hybrid layer's the ring, the
SSM's convolution tail (G, B, K-1, D) and its state (G, B, D, N) float32.
Each decoding layer writes its new K/V entries (or its new state) into its
slice ``pool[g]`` or ``cache[g]`` IN PLACE; JAX instead returns new pools
and caches from the scan. What is the same for every layer of a step —
the rope tables, the pool slots the new entries go to, the attention
lengths — the stack computes once and hands to each layer (XLA hoists the
same values out of the JAX scan).

Training (``run_stack_seq`` without a cache, under grad mode, with
parameters or input that require grad) recomputes each layer group in the
backward (``torch.utils.checkpoint``, the counterpart of the JAX
``jax.checkpoint(nothing_saveable)`` around the scan body), and takes each
group's parameters from one ``unbind`` of every stacked leaf.

Given a ``tp_group`` (the sharded paged engine passes its tensor-parallel
process group to the paged and oracle steps) a layer holds one rank's
heads and MLP columns, and its attention output projection and MLP down
projection each end in one all-reduce over the group. Only dense
full-attention GQA stacks take a group (``_check_tp``): any other
projection would return a rank's partial sum.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (
    ATTN_CHUNKED_LOCAL,
    ATTN_FULL,
    ATTN_MLA,
    ATTN_SWA,
    MIXER_HYBRID,
    MIXER_RWKV6,
    ModelConfig,
)
from repro_torch.kernels.decode_attention import (
    paged_chunk_attention,
    paged_decode_attention,
    ref_paged_chunk_attention,
)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp,
    apply_rope_tables,
    dense_init,
    init_mlp,
    layer_norm,
    rms_norm,
    rope_tables,
)
from repro_torch.params import tree_leaves
from repro_torch.serving.paged_cache import (
    _quantized_scatter,
    decode_slots,
    packed_slots,
    scatter_slots,
)

# ---------------------------------------------------------------------------
# layer-kind resolution
# ---------------------------------------------------------------------------


def period(cfg: ModelConfig) -> int:
    return cfg.global_layer_every if cfg.global_layer_every else 1


def layer_kind(cfg: ModelConfig, layer: int) -> Dict[str, Any]:
    return {
        "attn_type": cfg.layer_attn_type(layer),
        "moe": cfg.layer_is_moe(layer),
        "cross": cfg.is_encoder_decoder,
    }


def cache_len_for(cfg: ModelConfig, kind: Dict[str, Any], S: int) -> int:
    """Cache slots a layer of kind ``kind`` holds for a context of S tokens:
    a ring of ``min(S, window)`` slots for a sliding-window or hybrid layer
    (JAX sizes a hybrid layer's cache S, linear: ROADMAP §3), a ring of
    ``min(S, chunk)`` for a chunked-local layer, S otherwise (full
    attention, MLA)."""
    at = kind["attn_type"]
    if at in (ATTN_SWA, MIXER_HYBRID):
        return min(S, cfg.window)
    if at == ATTN_CHUNKED_LOCAL:
        return min(S, cfg.chunk_size)
    return S


def _kinds(cfg: ModelConfig):
    """The layer kind of each position in the period."""
    return [layer_kind(cfg, i) for i in range(period(cfg))]


def _uses_layernorm(cfg: ModelConfig) -> bool:
    return cfg.attn_type == MIXER_RWKV6 or cfg.is_encoder_decoder


def init_norm(cfg, dtype, device, lead=()):
    """Norm params; ``lead`` prepends the stacked layer-group axis."""
    shape = (*lead, cfg.d_model)
    if _uses_layernorm(cfg):
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def apply_norm(cfg, p, x):
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# init (dense GQA, RWKV-6 and hybrid stacks)
# ---------------------------------------------------------------------------


# the attention kinds a period-1 stack may have, and those a longer period
# may mix (llama4: chunked-local layers, every p-th one global)
_PERIOD1_KINDS = (ATTN_FULL, ATTN_SWA, ATTN_CHUNKED_LOCAL, ATTN_MLA, MIXER_HYBRID)
_PERIOD_P_KINDS = (ATTN_FULL, ATTN_CHUNKED_LOCAL)


def dense_stack_supported(cfg: ModelConfig) -> bool:
    """Whether the port has this layer stack: a period-1 stack of RWKV-6
    layers without MoE; an encoder-decoder stack (whisper) of full-attention
    layers with GELU MLPs, each decoder layer cross-attending the encoder;
    or SwiGLU layers (whose feed-forward may be MoE) of one period:
    full-attention, sliding-window, chunked-local, MLA or hybrid (SWA
    attention beside an SSM) layers at period 1, full-attention and
    chunked-local GQA layers at a longer one (llama4)."""
    p = period(cfg)
    if cfg.num_layers % p:
        return False
    kinds = [k["attn_type"] for k in _kinds(cfg)]
    if cfg.is_encoder_decoder:
        return (p == 1 and kinds == [ATTN_FULL] and cfg.act == "gelu"
                and not layer_kind(cfg, 0)["moe"] and cfg.encoder_layers > 0)
    if MIXER_RWKV6 in kinds:
        return p == 1 and not layer_kind(cfg, 0)["moe"]
    allowed = _PERIOD1_KINDS if p == 1 else _PERIOD_P_KINDS
    return cfg.act == "silu" and all(at in allowed for at in kinds)


def _check_dense_stack(cfg: ModelConfig) -> None:
    if not dense_stack_supported(cfg):
        raise NotImplementedError(
            "the port covers stacks of full-attention, sliding-window, chunked-local, MLA "
            "or hybrid layers with SwiGLU or MoE (a period > 1 of full and chunked-local "
            "GQA layers only), encoder-decoder stacks of full-attention layers with GELU "
            "MLPs, or stacks of RWKV-6 layers, only")


def init_mla(generator, cfg: ModelConfig, dtype, device, lead=()):
    """MLA params with the JAX tree and init scales (``attention.init_mla``):
    the low-rank query ``wq_a`` (D, q_lora) -> ``q_norm`` -> ``wq_b`` (q_lora,
    H (nope + rope)), the compressed K/V ``wkv_a`` (D, kv_lora + rope) ->
    ``kv_norm`` -> ``wkv_b`` (kv_lora, H (nope + v)), and ``wo`` (H v, D),
    each at 1/sqrt(d_in), unit norm scales."""
    H, D = cfg.num_heads, cfg.d_model
    nope, rope, v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    mk = lambda d_in, d_out: dense_init(generator, (*lead, d_in, d_out), dtype, device)
    ones = lambda n: torch.ones((*lead, n), dtype=dtype, device=device)
    return {"wq_a": mk(D, cfg.q_lora_rank), "q_norm": ones(cfg.q_lora_rank),
            "wq_b": mk(cfg.q_lora_rank, H * (nope + rope)),
            "wkv_a": mk(D, cfg.kv_lora_rank + rope), "kv_norm": ones(cfg.kv_lora_rank),
            "wkv_b": mk(cfg.kv_lora_rank, H * (nope + v)), "wo": mk(H * v, D)}


def _init_gqa(generator, cfg: ModelConfig, dtype, device, lead, bias: bool):
    """GQA projections ``wq`` (D, H hd), ``wk``/``wv`` (D, KVH hd), ``wo``
    (H hd, D), each at 1/sqrt(d_in), and zero QKV biases with ``bias``."""
    D, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    mk = lambda d_in, d_out: dense_init(generator, (*lead, d_in, d_out), dtype, device)
    a = {"wq": mk(D, q_dim), "wk": mk(D, kv_dim), "wv": mk(D, kv_dim), "wo": mk(q_dim, D)}
    if bias:
        for name, n in (("bq", q_dim), ("bk", kv_dim), ("bv", kv_dim)):
            a[name] = torch.zeros((*lead, n), dtype=dtype, device=device)
    return a


def init_layer(generator, cfg: ModelConfig, kind, dtype, device, lead=(), encoder=False):
    """One layer's params of kind ``kind`` (``lead`` = stacked group axis),
    with the init scales of the JAX package. GQA:
    1/sqrt(d_in) for every projection, zero QKV biases, unit norm scales,
    and in an MoE layer ``moe`` (see ``moe.init_moe``) in place of ``mlp``.
    MLA: ``init_mla`` in place of the GQA projections. RWKV-6: layer norms
    with bias, time and channel mixing (``rwkv6.init_rwkv6``/
    ``init_rwkv6_ffn``). Hybrid: the GQA layer plus the SSM
    (``ssm.init_ssm``) and unit gate scales of the two branches' norms.
    Encoder-decoder (whisper): layer norms with bias, GELU MLPs, and in a
    decoder layer (not ``encoder``) ``cross_norm`` and ``cross_attn`` (GQA
    projections without bias) after the self-attention; an ``encoder``
    layer is a full-attention one."""
    _check_dense_stack(cfg)
    if cfg.attn_type == MIXER_RWKV6:
        return {"norm1": init_norm(cfg, dtype, device, lead),
                "rwkv": rwkv_mod.init_rwkv6(generator, cfg, dtype, device, lead),
                "norm2": init_norm(cfg, dtype, device, lead),
                "rwkv_ffn": rwkv_mod.init_rwkv6_ffn(generator, cfg, dtype, device, lead)}
    D = cfg.d_model
    at = ATTN_FULL if encoder else kind["attn_type"]
    if at == ATTN_MLA:
        a = init_mla(generator, cfg, dtype, device, lead)
    else:
        a = _init_gqa(generator, cfg, dtype, device, lead, cfg.qkv_bias)
    p = {"norm1": init_norm(cfg, dtype, device, lead), "attn": a}
    if at == MIXER_HYBRID:
        p["ssm"] = ssm_mod.init_ssm(generator, cfg, dtype, device, lead)
        p["gate_attn"] = torch.ones((*lead, D), dtype=dtype, device=device)
        p["gate_ssm"] = torch.ones((*lead, D), dtype=dtype, device=device)
    if kind["cross"] and not encoder:
        p["cross_norm"] = init_norm(cfg, dtype, device, lead)
        p["cross_attn"] = _init_gqa(generator, cfg, dtype, device, lead, False)
    p["norm2"] = init_norm(cfg, dtype, device, lead)
    if kind["moe"] and not encoder:
        p["moe"] = moe_mod.init_moe(generator, cfg, dtype, device, lead)
    else:
        p["mlp"] = init_mlp(generator, D, cfg.d_ff, dtype, device, lead, cfg.act)
    return p


# the kind of every encoder layer (whisper): full attention, no cross
# attention, no MoE
ENCODER_KIND = {"attn_type": ATTN_FULL, "moe": False, "cross": False}


def _stack_layers(generator, cfg: ModelConfig, dtype, device, encoder=False):
    """Decoder layers stacked into period groups: a list of p trees (one per
    position in the period, of that position's kind) whose leaves carry a
    leading axis of G = num_layers / p; with ``encoder`` the encoder's
    ``encoder_layers`` layers as one tree (period 1)."""
    if encoder:
        return [init_layer(generator, cfg, ENCODER_KIND, dtype, device,
                           lead=(cfg.encoder_layers,), encoder=True)]
    G = cfg.num_layers // period(cfg)
    return [init_layer(generator, cfg, kind, dtype, device, lead=(G,)) for kind in _kinds(cfg)]


def layer_slice(tree, g: int):
    """Layer ``g``'s params: the ``g``-th slice (a view) of every leaf."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, g) for k, v in tree.items()}
    return tree[g]


def unbind_groups(tree, n: int):
    """The n layer groups' params of a stacked tree, every leaf unbound once
    along its leading axis: in the backward one ``stack`` a leaf, where
    ``layer_slice`` per group would give each group a ``select`` whose
    backward writes a zero tensor as large as the whole stacked leaf."""
    if isinstance(tree, dict):
        parts = {k: unbind_groups(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# paged serving layers
# ---------------------------------------------------------------------------


# tensor parallelism (the sharded paged engine, serving.sharded_pool): with
# a ``tp_group`` the layers hold a rank's heads and MLP columns, and the two
# row-parallel projections sum their partial outputs over the group, one
# all-reduce each (the Megatron pair); without one, none


def _check_tp(cfg: ModelConfig, tp_group) -> None:
    """A tensor-parallel group is taken by the stacks whose every
    projection the Megatron pair covers: full-attention GQA decoders of
    period 1 with a dense MLP. Anything else (MoE, MLA, hybrid, RWKV-6,
    cross attention) raises rather than return a rank's partial sum."""
    if tp_group is not None and (period(cfg) != 1 or cfg.attn_type != ATTN_FULL
                                 or cfg.is_encoder_decoder or cfg.is_moe):
        raise NotImplementedError(f"{cfg.name}: tensor-parallel layers cover dense "
                                  f"full-attention GQA stacks only")


def _tp_sum(y, tp_group):
    """The partial output of a row-parallel projection summed over the
    tensor-parallel group (in place), or ``y`` unsharded."""
    if tp_group is None:
        return y
    from repro_torch.models.shardmap_tp import all_reduce

    return all_reduce(y, tp_group)


def _out_proj(cfg, lp, x, a_out, tp_group=None):
    """The attention output of x's (B, S) tokens through ``wo``: (B, S, D)
    (the paged layers hand it (T, H, hd) for x (1, T, D)); with a
    ``tp_group`` the rank's heads' share, summed over the group."""
    B, S = x.shape[:2]
    return _tp_sum(a_out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ lp["attn"]["wo"],
                   tp_group)


def _ffn_residual(cfg, lp, x, tp_group=None):
    """norm2, the MLP or the MoE layer, and its residual: (x, aux), aux the
    MoE's load-balance loss (float32 zero for an MLP); with a ``tp_group``
    the MLP's down projection summed over the group."""
    xn = apply_norm(cfg, lp["norm2"], x)
    if "moe" in lp:
        out, aux = moe_mod.apply_moe(lp["moe"], xn, cfg)
        return x + out, aux
    return (x + _tp_sum(apply_mlp(lp["mlp"], xn, cfg.act), tp_group),
            x.new_zeros((), dtype=torch.float32))


def _mlp_residual(cfg, lp, x, tp_group=None):
    """norm2, the MLP or the MoE layer, and its residual (the serving
    steps drop the MoE's aux loss, as JAX's decode, prefix and paged
    layers do)."""
    return _ffn_residual(cfg, lp, x, tp_group)[0]


def _finish_layer(cfg, lp, x, a_out, tp_group=None):
    """Output projection, residual, norm2 and the MLP."""
    return _mlp_residual(cfg, lp, x + _out_proj(cfg, lp, x, a_out, tp_group), tp_group)


def _qkv(cfg, lp, xn, rope):
    """QKV (with bias) of the normed input -> rope; returns q, k, v (B, S,
    heads, hd)."""
    q, k, v = attn.qkv_project(lp["attn"], xn, cfg.num_heads,
                               cfg.num_kv_heads, cfg.head_dim)
    if rope is not None:
        q = apply_rope_tables(q, *rope)
        k = apply_rope_tables(k, *rope)
    return q, k, v


def _attn_inputs(cfg, lp, x, rope):
    """norm1 -> QKV (with bias) -> rope; returns q, k, v (B, S, heads, hd)."""
    return _qkv(cfg, lp, apply_norm(cfg, lp["norm1"], x), rope)


def _hybrid_mix(cfg, lp, x, a_out, s_out):
    """The residual of Hymba's two branches, each normed by its gate."""
    return x + 0.5 * (rms_norm(a_out, lp["gate_attn"], cfg.norm_eps)
                      + rms_norm(s_out, lp["gate_ssm"], cfg.norm_eps))


def _rope(cfg, positions):
    """The rope tables of ``positions``, over the head dim (an MLA stack's:
    its rope dims), or None without rope."""
    if not cfg.use_rope:
        return None
    dim = cfg.qk_rope_head_dim if cfg.attn_type == ATTN_MLA else cfg.head_dim
    return rope_tables(positions, dim, cfg.rope_theta)


def _write_slots(pool_slice, sc_slice, dest, new_kv):
    """Write new K/V entries (N, KVH, hd) at flat slots ``dest`` of one
    layer's pool slice, in place: a plain scatter into a float pool, the
    quantized scatter (running-max scales ``sc_slice`` (n_blocks, KVH),
    updated in place too) into an int8 pool."""
    if sc_slice is None:
        scatter_slots(pool_slice, dest, new_kv)
    else:
        _quantized_scatter(pool_slice[None], sc_slice[None], dest, new_kv[None])


def apply_layer_paged(cfg, lp, x, k_slice, v_slice, tables, row_of, slots,
                      p_end, s_start, *, rope, dest, k_sc=None, v_sc=None,
                      impl="pallas", tp_group=None):
    """Ragged fused-step layer: T packed tokens (decode rows and prefill
    chunks back to back) read and write one layer's pool slice directly.

    x: (1, T, D); k/v_slice: (n_blocks, bs, KVH, hd), updated in place;
    tables: (B, mb) int32 RAW; row_of/slots/p_end/s_start: (T,) int32 owning
    row (-1 = pad), cache slot and span; ``rope``: the step's rope tables of
    the tokens' positions; ``dest``: the step's ``packed_slots``. The
    tokens' K/V are written before attention, so each token sees its own
    entry and every earlier packed token of its row. ``k_sc``/``v_sc``
    ((n_blocks, KVH) float32, both or neither) mark an int8 pool slice: the
    writes quantize at scatter time and the kernel dequantizes. ``impl``
    picks the attention read: "pallas" the chunk kernel's wrapper (the
    hand-written kernel on the card), "reference" its gather oracle
    ``ref_paged_chunk_attention`` on any device; ``tp_group`` as for the
    stack (``_finish_layer``). Returns the new x."""
    q, k, v = _attn_inputs(cfg, lp, x, rope)
    _write_slots(k_slice, k_sc, dest, k[0])
    _write_slots(v_slice, v_sc, dest, v[0])
    read = paged_chunk_attention if impl == "pallas" else ref_paged_chunk_attention
    a_out = read(q[0], k_slice, v_slice, tables, row_of, slots, p_end, s_start,
                 k_scale=k_sc, v_scale=v_sc)
    return _finish_layer(cfg, lp, x, a_out, tp_group)


def _scale_slice(scales, g):
    return None if scales is None else scales[g]


def run_stack_paged(cfg, blocks, x, k_pool, v_pool, tables, row_of, slots,
                    positions, p_end, s_start, *, block_size, null_block,
                    k_scales=None, v_scales=None, impl="pallas", tp_group=None):
    """Run the stack in ragged fused-step mode: x (1, T, D) packed tokens
    against the full pools (G, n_blocks, bs, KVH, hd), which are updated in
    place layer by layer (with their (G, n_blocks, KVH) scale pools
    ``k_scales``/``v_scales`` for an int8 pool); ``impl`` as for
    ``apply_layer_paged``; ``tp_group``: this rank's tensor-parallel group
    (None: unsharded). Returns x."""
    if period(cfg) != 1:
        raise NotImplementedError("ragged paged path requires period-1 stacks")
    _check_tp(cfg, tp_group)
    rope = _rope(cfg, positions[None])
    dest = packed_slots(tables, row_of, slots, block_size, null_block)
    for g in range(k_pool.shape[0]):
        x = apply_layer_paged(
            cfg, layer_slice(blocks[0], g), x, k_pool[g], v_pool[g], tables,
            row_of, slots, p_end, s_start, rope=rope, dest=dest,
            k_sc=_scale_slice(k_scales, g), v_sc=_scale_slice(v_scales, g), impl=impl,
            tp_group=tp_group,
        )
    return x


def apply_layer_decode_paged(cfg, lp, x, k_slice, v_slice, tables, lengths,
                             *, rope, dest, k_sc=None, v_sc=None, tp_group=None):
    """Paged decode layer: write each row's new K/V at its ``dest`` slot of
    the pool slice (in place; quantized into an int8 slice with scales
    ``k_sc``/``v_sc``), then attend the row's chain with
    ``paged_decode_attention``. x: (B, 1, D); tables: (B, mb); lengths:
    (B,) int32 = pos + 1; ``rope``/``dest``: the step's rope tables and
    ``decode_slots``. Returns the new x."""
    q, k, v = _attn_inputs(cfg, lp, x, rope)
    _write_slots(k_slice, k_sc, dest, k[:, 0])
    _write_slots(v_slice, v_sc, dest, v[:, 0])
    a_out = paged_decode_attention(q[:, 0].contiguous(), k_slice, v_slice,
                                   tables, lengths, k_scale=k_sc, v_scale=v_sc)
    return _finish_layer(cfg, lp, x, a_out, tp_group)


def run_stack_decode_paged(cfg, blocks, x, k_pool, v_pool, tables, pos, *,
                           block_size, null_block, k_scales=None, v_scales=None,
                           tp_group=None):
    """Run the stack in paged-decode mode: x (B, 1, D), pools (and an int8
    pool's scale pools) updated in place layer by layer, per-row positions
    (B,) int32, table-backed (the plan allocates before it decodes);
    ``tp_group`` as for ``run_stack_paged``. Returns x."""
    if period(cfg) != 1:
        raise NotImplementedError("paged decode requires period-1 stacks")
    _check_tp(cfg, tp_group)
    rope = _rope(cfg, pos[:, None])
    dest = decode_slots(tables, pos, block_size, null_block)
    lengths = pos + 1
    for g in range(k_pool.shape[0]):
        x = apply_layer_decode_paged(
            cfg, layer_slice(blocks[0], g), x, k_pool[g], v_pool[g], tables,
            lengths, rope=rope, dest=dest,
            k_sc=_scale_slice(k_scales, g), v_sc=_scale_slice(v_scales, g), tp_group=tp_group,
        )
    return x


# ---------------------------------------------------------------------------
# chunked prefill over a contiguous view (the paged backend's oracle steps)
# ---------------------------------------------------------------------------


def _prefix_mask(Sc: int, slots, seg_prefix_end=None, seg_start=None):
    """(B, C, Sc) bool: which cache slots each chunk query attends — plain
    causal over slots (``s <= slots``), or with segment spans ``s <
    seg_prefix_end | seg_start <= s <= slots`` (document tokens attend the
    prelude and their own segment)."""
    s = torch.arange(Sc, device=slots.device)[None, None, :]
    own = slots[:, :, None]
    if seg_prefix_end is None:
        return s <= own
    return (s < seg_prefix_end[:, :, None]) | ((s >= seg_start[:, :, None]) & (s <= own))


def apply_layer_prefix(cfg, lp, x, cache, slots, *, rope, valid, tp_group=None):
    """Chunked prefill layer: x (B, C, D) of prompt tokens at cache slots
    ``slots`` (B, C) attends the cached prefix plus itself. The chunk's K/V
    are written into the layer's contiguous cache entry ``cache`` ({k, v} of
    (B, Sc, KVH, hd), with {k_scale, v_scale} (B, Sc, KVH) for the int8
    cache; ``_write_kv``) IN PLACE before attention
    (``chunk_decode_attention`` under ``valid``, the step's
    ``_prefix_mask``); ``rope``: the step's rope tables of the tokens'
    positions. Full-attention GQA only. Returns the new x."""
    q, k, v = _attn_inputs(cfg, lp, x, rope)
    k_read, v_read = _write_kv(cache, k, v, slots, q.dtype)
    return _finish_layer(cfg, lp, x, attn.chunk_decode_attention(q, k_read, v_read, valid),
                         tp_group)


def run_stack_prefix(cfg, blocks, x, caches, pos, positions=None,
                     seg_prefix_end=None, seg_start=None, tp_group=None):
    """Run the stack in chunked-prefill mode: x (B, C, D) written into (and
    attending) the contiguous caches ({k, v} of (G, B, Sc, KVH, hd), and the
    int8 cache's scales, updated in place layer by layer) at start slot
    ``pos`` — an int, a 0-d tensor or (B,) per-row starts (the padded fused
    step runs every row at its own cursor). ``positions`` (B, C) are the
    rope positions (default: the slots); ``seg_prefix_end``/``seg_start``
    (B, C) the segment spans (see ``_prefix_mask``); ``tp_group`` as for
    ``run_stack_paged``. Full-attention GQA stacks of period 1. Returns
    (x, caches)."""
    if period(cfg) != 1 or cfg.attn_type != ATTN_FULL or cfg.is_encoder_decoder:
        raise NotImplementedError("chunked prefix prefill supports full-attention GQA stacks only")
    _check_tp(cfg, tp_group)
    B, C = x.shape[:2]
    entry = caches[0]
    Sc = entry["k"].shape[2]
    start = torch.as_tensor(pos, device=x.device).long()
    slots = (start.reshape(-1, 1) + torch.arange(C, device=x.device)).expand(B, C)
    if positions is None:
        positions = slots
    rope = _rope(cfg, positions)
    valid = _prefix_mask(Sc, slots, seg_prefix_end, seg_start)
    for g in range(entry["k"].shape[0]):
        x = apply_layer_prefix(cfg, layer_slice(blocks[0], g), x, layer_slice(entry, g), slots,
                               rope=rope, valid=valid, tp_group=tp_group)
    return x, caches


# ---------------------------------------------------------------------------
# the int8 dense cache (kv_cache_quant)
# ---------------------------------------------------------------------------


def quantize_kv(x):
    """Symmetric int8 quantization with per-slot, per-KV-head absmax scales,
    ``_quantize_kv`` of the JAX package: x (B, C, KVH, hd) -> (int8 codes
    (B, C, KVH, hd), float32 scales (B, C, KVH)). The scale is absmax / 127
    and each code round(x / max(scale, 1e-30)) (half to even), clipped to
    +-127; both divisions are true divisions by a tensor (CUDA divides by a
    Python scalar as a multiply by its reciprocal, one ulp off the quotient
    JAX and the CPU take), so the card, the CPU and JAX agree bit for bit on
    the same x. Each slot is written once, so no running max is kept."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    s = absmax / torch.full_like(absmax, 127.0)
    q = torch.round(xf / s.clamp(min=1e-30)[..., None]).clamp(-127, 127)
    return q.to(torch.int8), s


def dequantize_kv(codes, scales, dtype):
    """codes (..., KVH, hd) int8 and scales (..., KVH) float32 -> codes x
    scales in float32, cast to ``dtype`` (``_dequantize_kv``)."""
    return (codes.float() * scales[..., None]).to(dtype)


def _quantized_entry(entry):
    """The int8 form of a K/V cache entry {k, v}: int8 k/v and their
    float32 scales k_scale/v_scale."""
    out = {}
    for name in ("k", "v"):
        out[name], out[name + "_scale"] = quantize_kv(entry[name])
    return out


def _write_kv(cache, k, v, slots, dtype):
    """Write new K/V k/v (B, C, KVH, hd) at slots ``slots % Sc`` (B, C) of
    a layer's cache entry, in place; returns the cache to read, k/v (B, Sc,
    KVH, hd). An int8 entry (``k_scale`` in it) takes the quantized codes
    and scales (``quantize_kv``) and is read dequantized to ``dtype``,
    whole, as the JAX function reads it."""
    if "k_scale" not in cache:
        _cache_update(cache["k"], k, slots)
        _cache_update(cache["v"], v, slots)
        return cache["k"], cache["v"]
    for name, new in (("k", k), ("v", v)):
        codes, scales = quantize_kv(new)
        _cache_update(cache[name], codes, slots)
        _cache_update(cache[name + "_scale"], scales, slots)
    return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
            dequantize_kv(cache["v"], cache["v_scale"], dtype))


# ---------------------------------------------------------------------------
# dense serving layers
# ---------------------------------------------------------------------------


def _ring(t, Sc):
    """The last Sc entries of t (B, S, ...) with position p at slot p % Sc:
    JAX keeps them in order (``t[:, S - Sc:]``), a ring cache needs them
    rolled by S % Sc. t itself where Sc == S."""
    S = t.shape[1]
    if Sc == S:
        return t
    return torch.roll(t[:, S - Sc:], S % Sc, dims=1)


def _kv_entry(cfg, attn_type, k, v):
    """A layer's K/V cache entry of a whole sequence k/v (B, S, KVH, hd):
    the sequence (full attention) or its ring of ``cache_len_for`` slots
    (sliding-window, hybrid and chunked-local layers); quantized to int8
    with its scales (``_quantized_entry``) for ``kv_cache_quant``, after the
    roll (the scales are per slot, so rolling and quantizing commute)."""
    Sc = cache_len_for(cfg, {"attn_type": attn_type}, k.shape[1])
    entry = {"k": _ring(k, Sc), "v": _ring(v, Sc)}
    return _quantized_entry(entry) if cfg.kv_cache_quant else entry


def _attn_branch_seq(cfg, lp, x, rope, attn_type, want_cache=True):
    """norm1 -> QKV -> rope -> causal attention over the sequence, full,
    sliding-window or chunked-local (``blockwise_attention``); returns the
    attention output and the layer's cache entry {k, v} (``_kv_entry``;
    None without ``want_cache``)."""
    q, k, v = _attn_inputs(cfg, lp, x, rope)
    out = attn.blockwise_attention(q, k, v, attn_type=attn_type, window=cfg.window,
                                   chunk=cfg.chunk_size)
    return out, _kv_entry(cfg, attn_type, k, v) if want_cache else None


def _cross_kv(cfg, lp, enc_out):
    """A decoder layer's cross-attention keys and values of the encoder's
    output enc_out (B, S_enc, D): ck/cv (B, S_enc, KVH, hd) through
    ``cross_attn``'s wk/wv (no bias)."""
    B, Se, _ = enc_out.shape
    p = lp["cross_attn"]
    return ((enc_out @ p["wk"]).reshape(B, Se, cfg.num_kv_heads, cfg.head_dim),
            (enc_out @ p["wv"]).reshape(B, Se, cfg.num_kv_heads, cfg.head_dim))


def _cross_query(cfg, lp, x):
    """cross_norm -> the cross-attention queries of x (B, S, D): (B, S, H,
    hd) through ``cross_attn``'s wq (no bias)."""
    B, S, _ = x.shape
    xn = apply_norm(cfg, lp["cross_norm"], x)
    return (xn @ lp["cross_attn"]["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)


def _cross_out(cfg, lp, x, c_out):
    """The residual of the cross attention's output c_out (B, S, H, hd)
    through ``cross_attn``'s wo."""
    B, S = x.shape[:2]
    return x + c_out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ lp["cross_attn"]["wo"]


def _apply_rwkv_layer(cfg, lp, x, x_prev_att=None, x_prev_ffn=None, state=None,
                      state_out=None):
    """An RWKV-6 layer: norm1 -> time mixing -> residual -> norm2 -> channel
    mixing -> residual. The carried entries default to zeros (a prompt's
    start); ``state_out`` receives the new WKV state (it may be ``state``).
    Returns (x, {state, x_prev_att, x_prev_ffn})."""
    xn = apply_norm(cfg, lp["norm1"], x)
    out, (xprev_a, state) = rwkv_mod.apply_rwkv6(lp["rwkv"], xn, cfg, x_prev_att, state,
                                                 state_out=state_out)
    x = x + out
    xn2 = apply_norm(cfg, lp["norm2"], x)
    ffn_out, xprev_f = rwkv_mod.apply_rwkv6_ffn(lp["rwkv_ffn"], xn2, x_prev_ffn)
    return x + ffn_out, {"state": state, "x_prev_att": xprev_a, "x_prev_ffn": xprev_f}


def _apply_hybrid_layer_seq(cfg, lp, x, rope):
    """A hybrid layer over a sequence: norm1 -> sliding-window attention and
    the SSM side by side (both from the zero state) -> their gated mix ->
    residual -> norm2 -> MLP. Returns (x, {k, v: the (B, min(S, window),
    KVH, hd) ring (int8 with its scales for ``kv_cache_quant``), conv: (B,
    K-1, D), h: (B, D, N) float32}, aux)."""
    xn = apply_norm(cfg, lp["norm1"], x)
    q, k, v = _qkv(cfg, lp, xn, rope)
    a_out = _out_proj(cfg, lp, x, attn.blockwise_attention(q, k, v, attn_type=ATTN_SWA,
                                                           window=cfg.window))
    s_out, (conv_tail, h) = ssm_mod.apply_ssm(lp["ssm"], xn, cfg)
    x, aux = _ffn_residual(cfg, lp, _hybrid_mix(cfg, lp, x, a_out, s_out))
    return x, {**_kv_entry(cfg, MIXER_HYBRID, k, v), "conv": conv_tail, "h": h}, aux


def apply_layer_seq(cfg, lp, x, rope, kind=None, enc_out=None, want_cache=True):
    """Sequence-mode layer of kind ``kind`` (default: position 0's) in
    whole-prompt prefill: x (B, S, D) -> (x, cache entry, aux): the entry
    {k, v} (B, S, KVH, hd) for full attention, a K/V ring of min(S, window)
    slots for sliding-window attention and of min(S, chunk) for
    chunked-local attention (int8 K/V with float32 scales {k_scale,
    v_scale} (B, Sc, KVH) for ``kv_cache_quant``), {c_kv (B, S, kv_lora),
    k_rope (B, S, rope)} for MLA, {state (B, H, hd, hd), x_prev_att (B, D),
    x_prev_ffn (B, D)} for RWKV-6, and for a hybrid layer the ring with the
    SSM's {conv, h}; aux the MoE layer's load-balance loss (float32 zero
    without MoE). A decoder layer of an encoder-decoder stack attends the
    encoder's output ``enc_out`` (B, S_enc, D) after its self-attention,
    non-causally (``blockwise_attention`` at S_kv = S_enc), and its entry
    gains the cross keys and values {ck, cv} (B, S_enc, KVH, hd). Without
    ``want_cache`` (the encoder's layers) a GQA layer returns no entry."""
    at = (kind if kind is not None else layer_kind(cfg, 0))["attn_type"]
    if at == MIXER_RWKV6:
        x, cache = _apply_rwkv_layer(cfg, lp, x)
        return x, cache, x.new_zeros((), dtype=torch.float32)
    if at == MIXER_HYBRID:
        return _apply_hybrid_layer_seq(cfg, lp, x, rope)
    if at == ATTN_MLA:
        out, (c_kv, k_rope) = attn.mla_prefill(lp["attn"], apply_norm(cfg, lp["norm1"], x),
                                               cfg, rope)
        x, aux = _ffn_residual(cfg, lp, x + out)
        return x, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}, aux
    a_out, cache = _attn_branch_seq(cfg, lp, x, rope, at, want_cache)
    x = x + _out_proj(cfg, lp, x, a_out)
    if "cross_attn" in lp and enc_out is not None:
        ck, cv = _cross_kv(cfg, lp, enc_out)
        c_out = attn.blockwise_attention(_cross_query(cfg, lp, x), ck, cv, causal=False)
        x = _cross_out(cfg, lp, x, c_out)
        if want_cache:
            cache.update(ck=ck, cv=cv)
    x, aux = _ffn_residual(cfg, lp, x)
    return x, cache, aux


def run_stack_seq(cfg, blocks, x, positions, enc_out=None, encoder=False, want_cache=True):
    """Run the stack over a sequence (serving and training): x (B, S, D),
    positions (B, S). A Python loop over the layer groups and, in each, the
    period's positions (JAX scans the groups). Without a cache, while
    training (``_training``), each group is recomputed in the backward
    (``_run_stack_train``: JAX's remat; its segmented scan is a device for
    the scan's saved carries, which a Python loop does not need). Returns (x, caches,
    aux): caches a tuple of one entry per position in the period, each
    stacked over the G groups: {k, v} of (G, B, S, KVH, hd) for full
    attention, {k, v} of (G, B, Sc, KVH, hd) for a sliding-window (Sc =
    min(S, window)) or chunked-local (Sc = min(S, chunk)) layer with
    position p at slot p % Sc (JAX's cache rolled by S % Sc), int8 with
    {k_scale, v_scale} (G, B, Sc, KVH) float32 for ``kv_cache_quant``, {c_kv
    (G, B, S, kv_lora), k_rope (G, B, S, rope)} for MLA, for RWKV-6 {state
    (G, B, H, hd, hd) float32, x_prev_att, x_prev_ffn (G, B, D)}, for a
    hybrid stack the ring, conv (G, B, K-1, D) and h (G, B, D, N) float32,
    and for an encoder-decoder's decoder also the cross keys and values {ck,
    cv} (G, B, S_enc, KVH, hd) of ``enc_out``; None without ``want_cache``.
    aux is the sum of the layers' MoE load-balance losses (float32 zero
    without MoE). ``encoder`` runs the encoder's stack (its
    ``encoder_layers`` full-attention layers, causal as in the JAX
    package: ROADMAP §3)."""
    _check_dense_stack(cfg)
    kinds = [ENCODER_KIND] if encoder else _kinds(cfg)
    n_groups = cfg.encoder_layers if encoder else cfg.num_layers // len(kinds)
    rope = _rope(cfg, positions)
    if not want_cache and _training(x, blocks):
        return _run_stack_train(cfg, blocks, x, rope, kinds, n_groups, enc_out)
    entries = [[] for _ in kinds]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        for i, kind in enumerate(kinds):
            x, cache, a = apply_layer_seq(cfg, layer_slice(blocks[i], g), x, rope, kind,
                                          enc_out, want_cache)
            if want_cache:
                entries[i].append(cache)
            aux = aux + a
    if not want_cache:
        return x, None, aux
    caches = tuple({name: torch.stack([e[name] for e in ents]) for name in ents[0]}
                   for ents in entries)
    return x, caches, aux


def _training(x, blocks) -> bool:
    """Whether a forward builds a graph to differentiate: grad mode, and
    the input or a parameter that requires grad."""
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(t.requires_grad for t in tree_leaves(blocks))


def _group_seq(cfg, lps, x, rope, kinds, enc_out):
    """One layer group's p layers over the sequence, no cache: (x, aux)."""
    aux = x.new_zeros((), dtype=torch.float32)
    for lp, kind in zip(lps, kinds):
        x, _, a = apply_layer_seq(cfg, lp, x, rope, kind, enc_out, want_cache=False)
        aux = aux + a
    return x, aux


def _run_stack_train(cfg, blocks, x, rope, kinds, n_groups, enc_out):
    """The training form of ``run_stack_seq``: each layer group recomputed
    in the backward (non-reentrant ``checkpoint``, which saves only the
    group's inputs), its parameters from ``unbind_groups``. The forward
    draws no random numbers, so no RNG state is kept."""
    groups = [unbind_groups(b, n_groups) for b in blocks]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        x, a = checkpoint(_group_seq, cfg, [grp[g] for grp in groups], x, rope, kinds, enc_out,
                          use_reentrant=False, preserve_rng_state=False)
        aux = aux + a
    return x, None, aux


def _cache_update(c, new, slots):
    """Write each row's C new entries ``new`` (B, C, ...) into ``c`` (B, Sc,
    ...) IN PLACE at slots ``slots % Sc`` (B, C)."""
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    c[rows, slots.long() % c.shape[1]] = new.to(c.dtype)


def _decode_attn(cfg, lp, xn, cache, pos, rope, lengths):
    """QKV of the normed input, its K/V written at slot ``pos % Sc`` of the
    layer's cache entry (in place; quantized into an int8 entry, which is
    then read dequantized: ``_write_kv``), attention over the row's valid
    slots; returns (B, 1, H, hd)."""
    q, k, v = _qkv(cfg, lp, xn, rope)
    k_read, v_read = _write_kv(cache, k, v, pos[:, None], q.dtype)
    return attn.decode_attention(q, k_read, v_read, lengths)


def _decode_cross(cfg, lp, x, cache, cross_lengths):
    """A decoder layer's cross attention at decode: the query of x (B, 1,
    D) over every slot of the cross keys and values {ck, cv} (B, S_enc,
    KVH, hd) (``cross_lengths``: S_enc for every row) through the dense
    decode kernel, and its residual. x itself without cross attention."""
    if "cross_attn" not in lp:
        return x
    c_out = attn.decode_attention(_cross_query(cfg, lp, x), cache["ck"], cache["cv"],
                                  cross_lengths)
    return _cross_out(cfg, lp, x, c_out)


def apply_layer_decode(cfg, lp, x, cache, pos, *, rope, lengths, cross_lengths=None,
                       tp_group=None):
    """Dense decode layer: write each row's new K/V at slot ``pos % Sc`` of
    the layer's cache entry ``cache`` ({k, v} (B, Sc, KVH, hd), int8 with
    {k_scale, v_scale} for ``kv_cache_quant``; in place), then attend the
    row's valid slots; an encoder-decoder's decoder layer then attends the
    entry's cross keys and values (``_decode_cross``). x: (B, 1, D); pos:
    (B,) int32; ``rope``: the step's rope tables; ``lengths``
    (``decode_lengths``): min(pos + 1, Sc), which is what
    ``cache_validity`` allows on a full-attention linear cache and on a
    sliding-window ring of Sc <= window slots, or pos % chunk + 1 on a
    chunked-local ring; ``tp_group`` as for ``run_stack_decode``. Returns
    the new x."""
    xn = apply_norm(cfg, lp["norm1"], x)
    a_out = _decode_attn(cfg, lp, xn, cache, pos, rope, lengths)
    x = _decode_cross(cfg, lp, x + _out_proj(cfg, lp, x, a_out, tp_group), cache,
                      cross_lengths)
    return _mlp_residual(cfg, lp, x, tp_group)


def apply_layer_decode_hybrid(cfg, lp, x, cache, pos, *, rope, lengths):
    """Hybrid decode layer: the new K/V go to ring slot ``pos % Sc`` of the
    entry ``cache`` and the row attends its valid slots (``lengths`` =
    min(pos + 1, Sc): on a ring of Sc <= window slots that is the sliding
    window); the SSM steps from the carried convolution tail ``conv`` (B,
    K-1, D) and state ``h`` (B, D, N) of the entry, both updated in place.
    Returns the new x."""
    xn = apply_norm(cfg, lp["norm1"], x)
    a_out = _out_proj(cfg, lp, x, _decode_attn(cfg, lp, xn, cache, pos, rope, lengths))
    conv, h = cache["conv"], cache["h"]
    s_out, (tail, _) = ssm_mod.apply_ssm(lp["ssm"], xn, cfg, conv_tail=conv, h0=h, h_out=h)
    conv.copy_(tail)
    return _mlp_residual(cfg, lp, _hybrid_mix(cfg, lp, x, a_out, s_out))


def apply_layer_decode_rwkv(cfg, lp, x, state, x_prev_att, x_prev_ffn):
    """RWKV-6 decode layer: x (B, 1, D) against the layer's carried state
    (B, H, hd, hd) and token shifts (B, D), all three updated in place.
    Returns the new x."""
    x, new = _apply_rwkv_layer(cfg, lp, x, x_prev_att, x_prev_ffn, state, state_out=state)
    x_prev_att.copy_(new["x_prev_att"])
    x_prev_ffn.copy_(new["x_prev_ffn"])
    return x


def apply_layer_decode_mla(cfg, lp, x, cache, pos, *, rope):
    """MLA decode layer: the new token's latents (``mla_latents``) go to slot
    ``pos`` of the entry's c_kv (B, Sc, kv_lora) and k_rope (B, Sc, rope)
    caches (in place), then the absorbed attention over slots <= pos
    (``mla_decode``). Returns the new x."""
    xn = apply_norm(cfg, lp["norm1"], x)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_new, k_new = attn.mla_latents(lp["attn"], xn, cfg, rope)
    _cache_update(c_kv, c_new, pos[:, None])
    _cache_update(k_rope, k_new[:, :, 0, :], pos[:, None])
    out = attn.mla_decode(lp["attn"], xn, cfg, c_kv, k_rope, pos, rope)
    return _mlp_residual(cfg, lp, x + out)


def decode_lengths(cfg, kind, Sc: int, pos):
    """The valid slots of each row's cache for a decode query at ``pos``
    (B,), as the decode kernel takes them (slots [0, lengths)): pos % chunk
    + 1 on a chunked-local ring (the query's chunk starts at slot 0 of a
    ring of chunk slots; a shorter ring holds pos < Sc <= chunk), min(pos +
    1, Sc) otherwise. Both are ``cache_validity``'s mask."""
    if kind["attn_type"] == ATTN_CHUNKED_LOCAL:
        return (pos % cfg.chunk_size + 1).to(torch.int32)
    return torch.clamp(pos + 1, max=Sc).to(torch.int32)


def decode_inputs(cfg, caches, pos):
    """What every layer group of a decode step at ``pos`` (B,) shares:
    {"rope": the rope tables (None without rope), "lengths": each period
    position's ``decode_lengths`` (None for an MLA entry, whose mask
    ``mla_decode`` builds), "cross_lengths": the cross caches' S_enc for
    every row (the JAX function's all-valid mask; None without cross
    attention)}."""
    lengths = [decode_lengths(cfg, kind, entry["k"].shape[2], pos) if "k" in entry else None
               for kind, entry in zip(_kinds(cfg), caches)]
    cross = None
    if "ck" in caches[0]:
        cross = torch.full_like(pos, caches[0]["ck"].shape[2], dtype=torch.int32)
    return {"rope": _rope(cfg, pos[:, None]), "lengths": lengths, "cross_lengths": cross}


def apply_group_decode(cfg, blocks, caches, g, x, pos, inputs, tp_group=None):
    """Decode layer group g of a GQA, MLA, hybrid or encoder-decoder stack:
    its p layers in turn, each against the g-th slice of its own cache
    entry (updated in place); ``inputs`` from ``decode_inputs``;
    ``tp_group`` as for ``run_stack_decode``. Returns the new x."""
    _check_tp(cfg, tp_group)
    rope = inputs["rope"]
    for i, kind in enumerate(_kinds(cfg)):
        lp, cache = layer_slice(blocks[i], g), layer_slice(caches[i], g)
        at = kind["attn_type"]
        if at == ATTN_MLA:
            x = apply_layer_decode_mla(cfg, lp, x, cache, pos, rope=rope)
        elif at == MIXER_HYBRID:
            x = apply_layer_decode_hybrid(cfg, lp, x, cache, pos, rope=rope,
                                          lengths=inputs["lengths"][i])
        else:
            x = apply_layer_decode(cfg, lp, x, cache, pos, rope=rope,
                                   lengths=inputs["lengths"][i],
                                   cross_lengths=inputs["cross_lengths"], tp_group=tp_group)
    return x


def run_stack_decode(cfg, blocks, x, caches, pos, tp_group=None):
    """Run the stack in dense-decode mode: x (B, 1, D), per-row positions
    pos (B,) int32 (each <= Sc - 1 on a full-attention or MLA cache; a ring
    takes any; an RWKV-6 stack has no positions), caches from
    ``model.init_cache`` updated in place layer by layer, group by group.
    ``tp_group``: this rank's tensor-parallel group (None: unsharded; a
    dense full-attention GQA stack only, ``_check_tp``). Returns (x,
    caches). An MoE layer's capacity is that of B tokens: dropless."""
    _check_dense_stack(cfg)
    _check_tp(cfg, tp_group)
    if cfg.attn_type == MIXER_RWKV6:
        entry = caches[0]
        for g in range(cfg.num_layers):
            x = apply_layer_decode_rwkv(cfg, layer_slice(blocks[0], g), x, entry["state"][g],
                                        entry["x_prev_att"][g], entry["x_prev_ffn"][g])
        return x, caches
    inputs = decode_inputs(cfg, caches, pos)
    for g in range(cfg.num_layers // period(cfg)):
        x = apply_group_decode(cfg, blocks, caches, g, x, pos, inputs, tp_group)
    return x, caches
