"""Partitions of one paged KV pool, ported from ``repro.serving.sharded_pool``.

**TP (model axis, by KV head).** ``ShardedPoolLayout`` maps a paged
engine onto a "model" axis of ``tp`` ranks, one process each, SPMD: every
rank runs the same host logic (control plane, block tables, sampler seed)
and holds ``KVH / tp`` heads of every pool block, its ``H / tp`` query
heads and its slices of the weights (``place_params``, by
``models.sharding.serve_engine_pspecs``: column-parallel QKV and MLP up
projections, row-parallel output and down projections, the embedding and
lm_head replicated). The block ids, refcounts, prefix index and warm LRU
stay replicated host-side metadata, so the block-table gathers and the
chunk scatter stay local to each rank; the only communication of a step is
the Megatron pair, one all-reduce after the attention output projection
and one after the MLP down projection a layer (the step functions'
``tp_group``, ``models.transformer._tp_sum``). The JAX layout places
shards on devices of one process under GSPMD; here each rank is a process
of a ``torch.distributed`` group and the collectives are written out.

**DP (by block range).** Data-parallel replicas own disjoint *block ranges*
of one pool, each replica running fully independent admission (its own
free list, refcounts, prefix index and warm LRU). ``block_range`` computes a
replica's slice. ``serving.engine.DataParallelEngineGroup`` takes three
placements. Without a layout, or with a layout of one "model" axis, every
process builds all the replicas over one shared ``PoolArrays`` box (its
heads of every block on a TP rank). On a ("data", "model") mesh each row of
the mesh is one replica: rank (d, m) runs replica d's engine on its "model"
group and, with ``dp_blocks=True``, holds only blocks ``block_range(total,
dp, d)`` of its ``KVH / tp`` heads (``pool_shape`` divides the block axis
where ``models.sharding.pool_pspecs`` puts it on "data"); the host-side
block ids stay global and are rebased where they meet the device
(``serving.paged_cache``). A replica's gather never leaves its rank, so the
data-axis combine that GSPMD inserts in JAX has no counterpart. A lone
engine on a data-axis mesh (``dp_blocks=False``) is JAX's placement
replicated over "data": every row runs the same engine on its "model"
group. Cross-replica *content* sharing happens one tier down: a
``serving.host_tier.HostBlockStore`` mirrors every replica's published
prefix blocks on the host, so a document prefilled in one replica's range
is a host-tier promotion, not a re-prefill, in another's (on a data-axis
mesh the rows exchange the blocks they wrote through after each group
step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


def block_range(n_blocks: int, dp_degree: int, dp_rank: int) -> Tuple[int, int]:
    """[lo, hi) block ids owned by DP replica ``dp_rank`` of ``dp_degree``.

    Replicas partition the pool by contiguous block range. The remainder
    (when dp doesn't divide n_blocks) goes to the last replica — block
    counts per replica differ by at most one chunk."""
    if not 0 <= dp_rank < dp_degree:
        raise ValueError(f"dp_rank {dp_rank} outside [0, {dp_degree})")
    per = n_blocks // dp_degree
    lo = dp_rank * per
    hi = (dp_rank + 1) * per if dp_rank < dp_degree - 1 else n_blocks
    return lo, hi


@dataclass(frozen=True)
class ShardedPoolLayout:
    """How a paged engine's arrays map onto a mesh (``launch.mesh.
    make_serving_mesh``: a ``DeviceMesh`` over the process group) that
    carries a "model" axis (TP) and may carry a "data" axis (DP).
    ``dp_blocks`` splits the pool's block axis over "data": each data rank
    then holds only its replica's block range (``DataParallelEngineGroup``;
    a lone engine addresses the whole pool and refuses it)."""

    mesh: Any
    dp_blocks: bool = False

    @property
    def axis_sizes(self) -> dict:
        from repro_torch.launch.mesh import mesh_axis_sizes

        return mesh_axis_sizes(self.mesh)

    @property
    def tp_degree(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def dp_degree(self) -> int:
        return self.axis_sizes.get("data", 1)

    @property
    def tp_rank(self) -> int:
        """This process's index along the "model" axis."""
        return self.mesh.get_local_rank("model") if self.tp_degree > 1 else 0

    @property
    def tp_group(self):
        """The process group of this rank's "model" axis (None at tp 1)."""
        return self.mesh.get_group("model") if self.tp_degree > 1 else None

    @property
    def dp_rank(self) -> int:
        """This process's index along the "data" axis: its mesh row."""
        return self.mesh.get_local_rank("data") if self.dp_degree > 1 else 0

    @property
    def dp_group(self):
        """The process group of the ranks with this rank's "model" index,
        one a row (None without a "data" axis)."""
        return self.mesh.get_group("data") if self.dp_degree > 1 else None

    def splits_blocks(self, cfg, n_blocks: int) -> bool:
        """Whether this rank holds only a block range of an ``n_blocks``
        pool (``dp_blocks`` and a "data" axis that divides the count)."""
        return self.pool_shape(cfg, n_blocks, 1)[1] != n_blocks

    # ----------------------------------------------------------- validation
    def validate(self, cfg) -> None:
        """The TP partition is explicit, never padded: reject a config whose
        head counts don't divide the model axis instead of silently falling
        back to replicated pools (the caller asked for sharding)."""
        tp = self.tp_degree
        if tp <= 1:
            return
        if cfg.num_kv_heads % tp:
            raise ValueError(
                f"sharded pool: num_kv_heads={cfg.num_kv_heads} does not "
                f"divide the model axis ({tp}); each shard must own an equal "
                f"slice of every block's KV heads"
            )
        if cfg.num_heads % tp:
            raise ValueError(
                f"sharded pool: num_heads={cfg.num_heads} does not divide "
                f"the model axis ({tp}); query heads must align with the "
                f"KV-head shards for attention to stay shard-local"
            )

    # --------------------------------------------------------------- shapes
    def local_config(self, cfg):
        """The config of this rank's layers: ``H / tp`` query heads over
        ``KVH / tp`` KV heads, ``d_ff / tp`` MLP columns (head_dim kept)."""
        tp = self.tp_degree
        if tp <= 1:
            return cfg
        self.validate(cfg)
        return cfg.replace(num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                           d_ff=cfg.d_ff // tp, head_dim=cfg.head_dim)

    def pool_shape(self, cfg, n_blocks: int, block_size: int) -> Tuple[int, ...]:
        """This rank's shard of a k or v pool (``models.sharding.
        pool_pspecs``): (G, n_blocks, bs, KVH / tp, hd), and with
        ``dp_blocks`` the block axis divided by the "data" axis where it
        divides the count (an indivisible count stays whole, as in JAX)."""
        from repro_torch.models.sharding import pool_pspecs, shard_shape
        from repro_torch.models.transformer import period

        G = cfg.num_layers // period(cfg)
        full = (G, n_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
        sizes = self.axis_sizes
        return shard_shape(full, pool_pspecs(cfg, sizes, dp_blocks=self.dp_blocks,
                                             n_blocks=n_blocks), sizes)

    def entry_shape(self, cfg, B: int, S: int) -> Tuple[int, ...]:
        """This rank's shard of a gathered view or chunk write (G, B, S,
        KVH / tp, hd): the pool's KV-head partition, blocks and batch whole."""
        G, _, _, kvh, hd = self.pool_shape(cfg, 1, 1)
        return (G, B, S, kvh, hd)

    # ----------------------------------------------------------- parameters
    def param_shardings(self, cfg, params):
        """Spec tree of the TP-resident serve params (embed / lm_head
        replicated; ``models.sharding.serve_engine_pspecs``)."""
        from repro_torch.models.sharding import serve_engine_pspecs

        return serve_engine_pspecs(cfg, params, self.axis_sizes)

    def place_params(self, cfg, params):
        """This rank's shard of every leaf: each dimension its spec puts on
        "model" narrowed to the rank's slice, contiguous. The QKV biases are
        replicated in the policy (as in JAX, where the partitioner adds each
        shard's columns); a rank adds them to its own heads' columns only,
        so they are cut to those columns here. A feed-forward the Megatron
        pair does not cover (a MoE layer, a row-parallel bias) raises."""
        from repro_torch.models.sharding import spec_axes, tree_map_with_path

        tp, r = self.tp_degree, self.tp_rank
        if tp <= 1:
            return params

        def shard(path, leaf, spec):
            if path.endswith(("moe/router", "mlp/b_down")):
                raise NotImplementedError(f"tensor-parallel serving of {path}: the engine's "
                                          f"Megatron pair covers dense QKV / SwiGLU layers only")
            dims = [d for d, e in enumerate(spec) if "model" in spec_axes(e)]
            if path.endswith(("attn/bq", "attn/bk", "attn/bv")):
                dims = [leaf.dim() - 1]
            for d in dims:
                n = leaf.shape[d] // tp
                leaf = leaf.narrow(d, r * n, n)
            return leaf.contiguous() if dims else leaf

        return tree_map_with_path(shard, params, self.param_shardings(cfg, params))


def make_pool_layout(mesh=None, tp: Optional[int] = None, dp: int = 1,
                     dp_blocks: bool = False) -> Optional[ShardedPoolLayout]:
    """Build a layout from either an existing mesh or a (tp, dp) request
    (``launch.mesh.make_serving_mesh`` over the initialised process group).
    Returns None for the degenerate no-mesh / tp=1 / dp=1 case, with or
    without ``dp_blocks``, so callers keep the unsharded path."""
    if mesh is not None:
        return ShardedPoolLayout(mesh, dp_blocks=dp_blocks)
    tp = tp or 1
    if tp <= 1 and dp <= 1:
        return None
    from repro_torch.launch.mesh import make_serving_mesh

    return ShardedPoolLayout(make_serving_mesh(tp, dp), dp_blocks=dp_blocks)
