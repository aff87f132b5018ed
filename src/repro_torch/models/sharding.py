"""Sharding policy, ported from ``repro.models.sharding``: which mesh axis
each dimension of a parameter, an input, a cache or a pool leaf is split
over.

The port has no partitioner: a policy here is a tree of ``Spec``s (one
entry a dimension: ``None``, an axis name, or a tuple of names), pure
functions of the trees' shapes and the mesh's axis sizes. The dry run
(``launch.dryrun``) turns them into per-device bytes, and the sharded
paged engine (``serving.sharded_pool``) slices each rank's shard of the
weights by ``serve_engine_pspecs``. The rules key off each leaf's path
("blocks/0/attn/wq"), which the port's trees share with the JAX package's
(``params.params_from_numpy`` is a plain tree map).

Baseline policy, as in the JAX package:
  * weights: FSDP over "data" on the d_model-ish dim + tensor parallel over
    "model" on the heads/d_ff/expert-ff dim; replicated over "pod".
  * activations: batch over ("pod", "data"); for batch-1 long-context
    decode the KV/sequence dim shards over ("pod", "data") instead.
  * any dim not divisible by its mesh axis is left unsharded.

JAX's ``activation_mesh`` / ``constrain`` are not ported: they are hints
for GSPMD's propagation inside scans and remat, and the port's layers run
explicit per-rank shards with explicit collectives
(``models.shardmap_tp``), where such a hint has nothing to act on.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


class Spec(tuple):
    """A partition spec: one entry a dimension of its leaf, each ``None``
    (replicated), an axis name, or a tuple of axis names (split over their
    product, the first outermost; a tuple of one name is that name, as in
    JAX's ``PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: Spec, axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one device's shard of a leaf of ``shape`` under
    ``spec``: each dimension divided by the product of its axes' sizes (the
    policy shards only dimensions its axes divide)."""
    out = []
    for dim, entry in zip(shape, spec):
        n = math.prod(axis_sizes.get(a, 1) for a in spec_axes(entry))
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry} ({n})")
        out.append(dim // n)
    return tuple(out) + tuple(shape[len(spec):])


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, path: str = "") -> Any:
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists and
    tuples, ``path`` the "/"-joined keys and indices (JAX's ``_path_str``).
    ``Spec`` leaves are leaves."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                  path=f"{path}/{i}" if path else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(path, tree, *rest)


# rules: regex on the "/"-joined path -> tuple of per-dim axis roles
# roles: "fsdp" (data axis), "tp" (model axis), None (replicated)
_PARAM_RULES = [
    (r"embed/table$", ("tp", "fsdp")),
    (r"lm_head/w$", ("fsdp", "tp")),
    (r"patch_proj/w$", ("fsdp", None)),
    (r"frame_proj/w$", ("fsdp", None)),
    (r"meta_tokens$", (None, "fsdp")),
    # attention
    (r"attn/w[qkv]$", ("fsdp", "tp")),
    (r"attn/wo$", ("tp", "fsdp")),
    (r"attn/b[qkv]$", (None,)),
    # MLA
    (r"attn/wq_a$", ("fsdp", None)),
    (r"attn/wq_b$", (None, "tp")),
    (r"attn/wkv_a$", ("fsdp", None)),
    (r"attn/wkv_b$", (None, "tp")),
    (r"attn/(q_norm|kv_norm)$", (None,)),
    # mlp
    (r"mlp/w_(gate|up)$", ("fsdp", "tp")),
    (r"mlp/w_down$", ("tp", "fsdp")),
    (r"mlp/b_up$", ("tp",)),
    (r"mlp/b_down$", (None,)),
    # moe
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w_(gate|up)$", (None, "fsdp", "tp")),
    (r"moe/w_down$", (None, "tp", "fsdp")),
    (r"moe/shared/w_(gate|up)$", ("fsdp", "tp")),
    (r"moe/shared/w_down$", ("tp", "fsdp")),
    # rwkv6
    (r"rwkv/w[rkvg]$", ("fsdp", "tp")),
    (r"rwkv/wo$", ("tp", "fsdp")),
    (r"rwkv/mix_w1$", ("fsdp", None)),
    (r"rwkv/mix_w2$", (None, None, "fsdp")),
    (r"rwkv/decay_w1$", ("fsdp", None)),
    (r"rwkv/decay_w2$", (None, "fsdp")),
    (r"rwkv/u$", ("tp", None)),
    (r"rwkv/(mu_first|decay_base|ln_x)$", (None,)),
    (r"rwkv/mu_base$", (None, None)),
    (r"rwkv_ffn/wk$", ("fsdp", "tp")),
    (r"rwkv_ffn/wv$", ("tp", "fsdp")),
    (r"rwkv_ffn/wr$", ("fsdp", "tp")),
    (r"rwkv_ffn/(mu_k|mu_r)$", (None,)),
    # ssm branch
    (r"ssm/w_in$", ("fsdp", "tp")),
    (r"ssm/conv_w$", (None, "tp")),
    (r"ssm/conv_b$", ("tp",)),
    (r"ssm/w_x$", ("tp", None)),
    (r"ssm/w_dt$", (None, "tp")),
    (r"ssm/dt_bias$", ("tp",)),
    (r"ssm/A_log$", ("tp", None)),
    (r"ssm/D$", ("tp",)),
    (r"ssm/w_out$", ("tp", "fsdp")),
    (r"gate_(attn|ssm)$", (None,)),
    # norms & everything else: replicated
    (r".*", None),
]


def _role_to_axis(role, dim, axis_sizes, axes_in_use):
    if role is None:
        return None
    if role == "ep":  # expert dim over the model axis
        if "model" in axes_in_use or dim % axis_sizes.get("model", 1) != 0:
            return None
        return "model"
    if role == "fsdp":
        # multi-pod: FSDP over (pod x data)
        if "pod" in axis_sizes:
            nb = axis_sizes["pod"] * axis_sizes["data"]
            if "data" not in axes_in_use and "pod" not in axes_in_use and dim % nb == 0:
                return ("pod", "data")
        axis = "data"
    else:
        axis = "model"
    if axis in axes_in_use:
        return None
    if dim % axis_sizes.get(axis, 1) != 0:
        return None  # explicit: no padding
    return axis


def param_pspecs(cfg: ModelConfig, params_abstract, axis_sizes: Dict[str, int],
                 moe_mode: str = "tp", serve: bool = False):
    """Spec tree matching the params tree.

    ``moe_mode="ep"``: expert weights shard the EXPERT dim over "model"
    (requires num_experts % model == 0) instead of the ffn dim.
    ``serve=True``: drop the FSDP role (serving weights are TP-resident),
    except on the expert-parallel ffn dims, which need no gather."""
    ep = moe_mode == "ep" and cfg.num_experts and (
        cfg.num_experts % axis_sizes.get("model", 1) == 0
    )
    rules = [(pat, roles, False) for pat, roles in _PARAM_RULES]
    if ep:
        rules = [
            (r"moe/w_(gate|up)$", ("ep", None, "fsdp"), True),
            (r"moe/w_down$", ("ep", "fsdp", None), True),
        ] + rules

    def spec_for(path, leaf):
        shape = leaf.shape
        in_stack = path.startswith(("blocks", "enc_blocks"))
        for pat, roles, exempt in rules:
            if re.search(pat, path):
                if roles is None:
                    roles = (None,) * (len(shape) - (1 if in_stack else 0))
                if serve and not exempt:
                    roles = tuple(None if r == "fsdp" else r for r in roles)
                base = len(shape) - len(roles)
                axes = [None] * base
                used: set = set()
                for i, role in enumerate(roles):
                    ax = _role_to_axis(role, shape[base + i], axis_sizes, used)
                    if ax:
                        used.update(ax if isinstance(ax, tuple) else (ax,))
                    axes.append(ax)
                return Spec(*axes)
        return Spec(*([None] * len(shape)))

    return tree_map_with_path(spec_for, params_abstract)


def batch_axes(axis_sizes: Dict[str, int]) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes else ("data",)


def _n_batch(axis_sizes: Dict[str, int]) -> int:
    return math.prod(axis_sizes[a] for a in batch_axes(axis_sizes))


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, specs_abstract, axis_sizes):
    """Specs for the model-input batch: the batch over the batch axes when
    they divide it."""
    B = shape.global_batch
    bspec = batch_axes(axis_sizes) if B % _n_batch(axis_sizes) == 0 else None
    return tree_map_with_path(
        lambda path, leaf: Spec(bspec, *([None] * (len(leaf.shape) - 1))), specs_abstract)


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, cache_abstract, axis_sizes):
    """Specs for the serve cache: batch-sharded when the batch divides the
    (pod x data) axes, else context-parallel (the cache sequence dim over
    them; long_500k, batch 1)."""
    baxes = batch_axes(axis_sizes)
    n_batch = _n_batch(axis_sizes)
    batch_sharded = shape.global_batch % n_batch == 0
    model = axis_sizes.get("model", 1)

    def spec_for(path, leaf):
        name = path.rsplit("/", 1)[-1]
        shp = leaf.shape  # leading dim = layer-group stack G
        axes = [None] * len(shp)
        if batch_sharded:
            axes[1] = baxes
        if name in ("k", "v", "ck", "cv", "c_kv", "k_rope") and len(shp) >= 4:
            if batch_sharded:
                if shp[2] % model == 0 and shp[2] >= model:
                    axes[2] = "model"
                elif name in ("k", "v", "ck", "cv") and len(shp) == 5 and shp[3] % model == 0:
                    axes[3] = "model"
            elif shp[2] % n_batch == 0:
                axes[2] = baxes
                if name in ("k", "v", "ck", "cv") and len(shp) == 5 and shp[3] % model == 0:
                    axes[3] = "model"
        if name == "state" and shp[2] % model == 0:  # rwkv (G,B,H,hd,hd)
            axes[2] = "model"
        if name == "h" and shp[2] % model == 0:  # ssm (G,B,Di,N)
            axes[2] = "model"
        if name in ("conv",) and shp[3] % model == 0:  # (G,B,K-1,Di)
            axes[3] = "model"
        if name in ("x_prev_att", "x_prev_ffn") and shp[2] % model == 0:
            axes[2] = "model"
        return Spec(*axes)

    return tree_map_with_path(spec_for, cache_abstract)


def pool_pspecs(cfg: ModelConfig, axis_sizes: Dict[str, int],
                dp_blocks: bool = False, n_blocks: int = None) -> Spec:
    """Spec of a paged KV block pool ``(G, n_blocks, block_size, KVH,
    hd)``: the KV-head dim over "model" (each model-axis shard holds ``KVH
    / tp`` heads of every block, so the block-table gathers and the chunk
    scatter stay local), and with ``dp_blocks`` the block dim over "data";
    a dim its axis does not divide stays unsharded."""
    model = axis_sizes.get("model", 1)
    data = axis_sizes.get("data", 1)
    kvh_axis = "model" if model > 1 and cfg.num_kv_heads % model == 0 else None
    blocks_div = n_blocks is None or n_blocks % data == 0
    blocks_axis = "data" if dp_blocks and data > 1 and blocks_div else None
    return Spec(None, blocks_axis, None, kvh_axis, None)


def serve_engine_pspecs(cfg: ModelConfig, params_abstract, axis_sizes: Dict[str, int]):
    """Parameter specs of the sharded paged engine: serve-mode TP (no FSDP)
    with the embedding table and lm_head replicated, so that the only
    collectives of a step are the Megatron pair, one all-reduce after the
    attention output projection and one after the MLP down projection a
    layer."""
    base = param_pspecs(cfg, params_abstract, axis_sizes, serve=True)

    def override(path, spec, leaf):
        if path.startswith(("embed", "lm_head")):
            return Spec(*([None] * len(leaf.shape)))
        return spec

    return tree_map_with_path(override, base, params_abstract)


def opt_state_pspecs(param_specs):
    """AdamW state mirrors the param sharding; step is replicated."""
    return {
        "step": Spec(),
        "m": param_specs,
        "v": param_specs,
    }
