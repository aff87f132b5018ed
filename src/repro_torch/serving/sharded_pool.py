"""Partitions of one paged KV pool, ported from ``repro.serving.sharded_pool``.

**DP (by block range).** Data-parallel replicas own disjoint *block ranges*
of one pool box, each replica running fully independent admission (its own
free list, refcounts, prefix index and warm LRU). ``block_range`` computes a
replica's slice; ``serving.engine.DataParallelEngineGroup`` wires replica
engines to one shared ``PoolArrays`` box. Cross-replica *content* sharing
happens one tier down: a ``serving.host_tier.HostBlockStore`` shared by the
group mirrors every replica's published prefix blocks on the host
(content-hash keys are replica-agnostic), so a document prefilled in one
replica's range is a host-tier promotion, not a re-prefill, in another's.

The port keeps every replica on one device: there is no mesh, so the
block axis is not placed anywhere. ``ShardedPoolLayout`` (pools split by KV
head over a model axis) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple


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
