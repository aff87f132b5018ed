"""Paged KV cache (vLLM-style PagedAttention), ported from
``repro.serving.paged_cache``.

A global pool of fixed-size blocks per layer group and a block table per
sequence. Blocks are reference counted so concurrent RAG requests that embed
the same retrieved documents share prefix blocks instead of recomputing
them; two keying schemes feed one prefix index — whole-prompt chained hashes
(``prefix_block_keys``) for flat prompts and segment-scoped keys
(``serving.segments.build_layout``) for ``SegmentedPrompt`` requests.
Releases keep refcount-0 keyed blocks warm in an LRU eviction queue.

Pool layout (matching the JAX package):
    k/v: (G, n_blocks, block_size, KVH, hd) torch tensors on the engine's
    device. Unlike JAX, which returns new pools from every step, the step
    programs here update the pools IN PLACE, one layer-group slice at a time.
Block tables: (max_seqs, max_blocks_per_seq) int32, -1 = unallocated.

The host tier (``host_store``, demote/promote, write-through), mesh layouts
and block ranges, int8 pools (``kv_dtype``) and the lifecycle sanitizer are
not ported yet; the constructor raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.params import torch_dtype


@dataclass
class PagedPool:
    """Host-side allocator for one cache pool (reference-counted blocks).

    Blocks have three states: *allocated* (refcount >= 1, owned by one or more
    sequences), *cached* (refcount 0 but kept warm because a prefix index
    still points at them — reclaimed lazily, oldest first, when allocation
    needs room), and *free*. ``n_free`` counts free + cached since both are
    allocatable."""

    n_blocks: int
    block_size: int
    free_list: List[int] = field(default_factory=list)
    tables: Dict[int, List[int]] = field(default_factory=dict)  # seq -> blocks
    refcounts: Dict[int, int] = field(default_factory=dict)     # block -> refs
    # warm blocks in LRU order: an insertion-ordered dict keyed by block id
    cached: Dict[int, None] = field(default_factory=dict)
    on_free: Optional[Callable[[int], None]] = None             # block truly freed
    keep_on_release: Optional[Callable[[int], bool]] = None     # warm-cache policy
    n_owned: int = 0     # blocks this allocator may hand out

    def __post_init__(self):
        if not self.free_list:
            self.free_list = list(range(self.n_blocks))
        if not self.n_owned:
            self.n_owned = len(self.free_list)

    @property
    def n_free(self) -> int:
        return len(self.free_list) + len(self.cached)

    def blocks_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.block_size - 1) // self.block_size

    def _pop_block(self) -> int:
        if self.free_list:
            return self.free_list.pop()
        if not self.cached:
            raise MemoryError("paged pool exhausted: no free or warm block")
        b = next(iter(self.cached))  # evict least-recently-used warm block
        del self.cached[b]
        if self.on_free is not None:
            self.on_free(b)
        return b

    def touch(self, block_id: int):
        """LRU heat signal: a prefix-index hit moves a warm block to the back
        of the eviction queue even when the hitting request cannot be admitted
        yet (backpressure). O(1)."""
        if self.refcounts.get(block_id, 0) == 0 and block_id in self.cached:
            del self.cached[block_id]
            self.cached[block_id] = None  # re-insert at the MRU end

    def allocate(self, seq_id: int, n_tokens: int) -> List[int]:
        need = self.blocks_needed(n_tokens)
        if need > self.n_free:
            raise MemoryError(
                f"paged pool exhausted: need {need} blocks, {self.n_free} free"
            )
        blocks = [self._pop_block() for _ in range(need)]
        for b in blocks:
            self.refcounts[b] = 1
        self.tables.setdefault(seq_id, []).extend(blocks)
        return blocks

    def share(self, seq_id: int, block_id: int) -> int:
        """Append an already-written block to ``seq_id``'s table, bumping its
        refcount (only fully written, immutable prompt blocks are shared).
        Reviving a warm cached block removes it from the eviction queue."""
        if self.refcounts.get(block_id, 0) == 0:
            self.cached.pop(block_id, None)
        self.refcounts[block_id] = self.refcounts.get(block_id, 0) + 1
        self.tables.setdefault(seq_id, []).append(block_id)
        return block_id

    def extend_for(self, seq_id: int, new_len: int) -> Optional[int]:
        """Ensure capacity for new_len tokens; returns a newly allocated
        block id if one was needed."""
        have = len(self.tables.get(seq_id, [])) * self.block_size
        if new_len <= have:
            return None
        return self.allocate(seq_id, new_len - have)[0]

    def free(self, seq_id: int):
        # release in reverse chain order: a chain's head blocks (most likely
        # to be re-hit) land at the back of the LRU queue, so tails are
        # evicted before heads
        for b in reversed(self.tables.pop(seq_id, [])):
            self.refcounts[b] = self.refcounts.get(b, 1) - 1
            if self.refcounts[b] <= 0:
                del self.refcounts[b]
                if self.keep_on_release is not None and self.keep_on_release(b):
                    self.cached[b] = None  # stays warm for prefix reuse
                else:
                    self.free_list.append(b)
                    if self.on_free is not None:
                        self.on_free(b)

    def table_array(self, seq_ids: List[int], max_blocks: int) -> np.ndarray:
        """Dense block-table rows for a batch of sequences: ``np.int32``,
        entries past a sequence's chain padded with ``-1`` (never ``0`` —
        block 0 is an ordinary block), so device consumers treat negatives
        as absent."""
        out = np.full((len(seq_ids), max_blocks), -1, dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            blocks = self.tables.get(sid, [])[:max_blocks]
            out[i, : len(blocks)] = blocks
        return out

    def utilization(self) -> float:
        return 1.0 - self.n_free / max(self.n_owned, 1)


# ---------------------------------------------------------------------------
# device-side paged operations (in place on one layer group's pool slice)
# ---------------------------------------------------------------------------


def scatter_slots(pool, dest, new_kv):
    """pool: (n_blocks, bs, KVH, hd), updated in place at flat slots
    ``dest`` (N,) int64 with ``new_kv`` (N, KVH, hd). Duplicate destinations
    only ever hit slot 0 of the scratch block, which nothing reads."""
    nb, bs = pool.shape[0], pool.shape[1]
    flat = pool.view(nb * bs, *pool.shape[2:])
    flat[dest] = new_kv.to(pool.dtype)
    return pool


def packed_slots(block_tables, row_of, slots, block_size: int, null_dest: int = 0):
    """Flat pool slots (T,) int64 of T packed tokens, each through its
    owning row's RAW block table; pad tokens (row_of < 0) and unbacked
    entries go to slot 0 of the ``null_dest`` scratch block. The same for
    every layer of a step, so a step computes it once."""
    bs = block_size
    row_of = row_of.long()
    slots = slots.long()
    blk = block_tables.long()[row_of.clamp(min=0), slots // bs]     # (T,)
    return torch.where((row_of >= 0) & (blk >= 0), blk * bs + slots % bs,
                       torch.full_like(blk, null_dest * bs))


def decode_slots(block_tables, pos, block_size: int, null_dest: int = 0):
    """Flat pool slots (B,) int64 of each row's new token at ``pos[b]``
    (the decode step's scatter, inlined in the JAX package's
    ``apply_layer_decode_paged``); unbacked entries go to the scratch block."""
    bs = block_size
    pos = pos.long()
    blk = block_tables.long()[torch.arange(pos.shape[0], device=pos.device), pos // bs]
    return torch.where(blk >= 0, blk * bs + pos % bs, torch.full_like(blk, null_dest * bs))


def write_paged_packed(pool_kv, block_tables, row_of, slots, new_kv,
                       block_size: int, null_dest: int = 0):
    """Ragged fused-step scatter: write T packed tokens' K/V entries
    (T, KVH, hd) into ONE layer group's pool slice (n_blocks, bs, KVH, hd),
    in place, each through its owning row's RAW block table (see
    ``packed_slots``). Returns ``pool_kv``."""
    dest = packed_slots(block_tables, row_of, slots, block_size, null_dest)
    return scatter_slots(pool_kv, dest, new_kv)


# ---------------------------------------------------------------------------
# prefix hashing (host side)
# ---------------------------------------------------------------------------


def _chunk_hash(prev: bytes, tokens_block: np.ndarray) -> bytes:
    """Rolling block hash: H_i = sha1(H_{i-1} || tokens of block i)."""
    h = hashlib.sha1(prev)
    h.update(np.ascontiguousarray(tokens_block, dtype=np.int64).tobytes())
    return h.digest()


def prefix_block_keys(tokens, block_size: int) -> List[bytes]:
    """Chained hash keys for every FULL block of ``tokens``: exactly
    ``len(tokens) // block_size`` keys, ``keys[i]`` a function of tokens
    ``[0, (i+1)*block_size)``, deterministic across processes."""
    toks = np.asarray(tokens)
    keys: List[bytes] = []
    prev = b""
    for i in range(len(toks) // block_size):
        prev = _chunk_hash(prev, toks[i * block_size : (i + 1) * block_size])
        keys.append(prev)
    return keys


@dataclass
class Admission:
    """Result of admission-controlled allocation for a prompt. (The host
    tier's hit counts join it when that tier is ported.)"""

    n_shared: int                       # prompt tokens served from shared blocks
    shared_spans: List[Tuple[int, int]]  # token ranges prefill may skip
    n_shared_session: int = 0           # session-history subset of n_shared


class PoolArrays:
    """Device-side k/v pool tensors, boxed so they can be shared (DP
    replicas over one pool, and int8 scale pools, are later slices)."""

    __slots__ = ("k", "v")

    def __init__(self, k, v):
        self.k = k
        self.v = v


class PagedKVCache:
    """End-to-end paged cache for one model: one pool per K and V with a
    leading layer-group axis, a host-side allocator, and the prefix index.

    ``admit_tokens``/``register_prefix`` take an optional
    ``serving.segments.SegmentLayout``: segmented prompts key per-document
    blocks independently of document order, so hits can be non-contiguous
    (``Admission.shared_spans`` lists every skippable token range)."""

    def __init__(self, cfg, n_blocks: int = 256, block_size: int = 16,
                 max_blocks_per_seq: int = 64, prefix_sharing: bool = True,
                 device=None, layout=None, block_range=None, arrays=None,
                 host_store=None, host_write_through: bool = False,
                 kv_dtype: Optional[str] = None, sanitize: bool = False):
        for name, value in (("layout", layout), ("block_range", block_range),
                            ("arrays", arrays), ("host_store", host_store),
                            ("kv_dtype", kv_dtype)):
            if value is not None:
                raise NotImplementedError(f"PagedKVCache({name}=...) is not ported yet")
        if host_write_through or sanitize:
            raise NotImplementedError(
                "the host tier and the KV sanitizer are not ported yet")
        from repro_torch import resolve_device
        from repro_torch.models.transformer import period

        self.cfg = cfg
        self.block_size = block_size
        self.max_blocks = max_blocks_per_seq
        self.device = resolve_device(device)
        G = cfg.num_layers // period(cfg)
        self.pool = PagedPool(
            n_blocks, block_size,
            on_free=self._forget_block,
            keep_on_release=lambda b: b in self._block_key,
        )
        shape = (G, n_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
        dt = torch_dtype(cfg)
        self._arrays = PoolArrays(
            torch.zeros(shape, dtype=dt, device=self.device),
            torch.zeros(shape, dtype=dt, device=self.device),
        )
        self.lengths: Dict[int, int] = {}
        self.prefix_sharing = prefix_sharing
        self._prefix_index: Dict[bytes, int] = {}   # chain hash -> block id
        self._block_key: Dict[int, bytes] = {}      # reverse map for eviction
        self.shared_token_hits = 0                  # prompt tokens from shared blocks
        self.session_token_hits = 0                 # session-history subset

    @property
    def k(self):
        return self._arrays.k

    @property
    def v(self):
        return self._arrays.v

    # ----------------------------------------------------------- host side
    def _forget_block(self, block_id: int):
        key = self._block_key.pop(block_id, None)
        if key is not None and self._prefix_index.get(key) == block_id:
            del self._prefix_index[key]

    def _block_hits(self, tokens, layout) -> Dict[int, int]:
        """Block ordinal -> cached block id, for every keyed block already in
        the prefix index. Never includes the block holding the final prompt
        token — at least one token must run through the model to produce the
        first-sample logits. Hits touch warm blocks (LRU heat) even when the
        caller subsequently backpressures."""
        if not self.prefix_sharing or not len(tokens):
            return {}
        last_block = (len(tokens) - 1) // self.block_size
        hits: Dict[int, int] = {}
        for ordinal, key in enumerate(layout.block_keys):
            if key is None or ordinal == last_block:
                continue
            b = self._prefix_index.get(key)
            if b is not None:
                hits[ordinal] = b
                self.pool.touch(b)
        return hits

    def admit_tokens(self, seq_id: int, tokens, layout=None) -> Optional[Admission]:
        """Admission-controlled allocation for a prompt. Reuses every cached
        keyed block (+1 slack block for decode) and returns the admission
        record — or None when the pool cannot fit the request (backpressure).

        Invariants: all-or-nothing (on None nothing was allocated or shared;
        headroom counts new blocks AND warm revivals, revivals by unique block
        id); on success ``tables[seq_id]`` holds exactly
        ``blocks_needed(len(tokens)) + 1`` entries in prompt-block order; the
        block of the final prompt token is never served from cache;
        ``shared_spans`` are disjoint, sorted, block-aligned token ranges."""
        from repro_torch.serving.segments import build_layout

        Lp = len(tokens)
        if layout is None:
            layout = build_layout(np.asarray(tokens), self.block_size)
        bs = self.block_size
        n_blocks = self.pool.blocks_needed(Lp)
        hits = self._block_hits(tokens, layout)
        n_new = n_blocks - len(hits) + 1
        n_warm = sum(
            1 for b in set(hits.values()) if self.pool.refcounts.get(b, 0) == 0
        )
        if n_new + n_warm > self.pool.n_free:
            return None
        for ordinal in range(n_blocks):
            if ordinal in hits:
                self.pool.share(seq_id, hits[ordinal])
            else:
                self.pool.allocate(seq_id, 1)
        self.pool.allocate(seq_id, 1)  # decode slack block
        n_shared = len(hits) * bs
        hist = layout.history_block_set() if layout.seg_spans else set()
        n_shared_session = sum(bs for o in hits if o in hist)
        self.lengths[seq_id] = 0
        self.shared_token_hits += n_shared
        self.session_token_hits += n_shared_session
        spans: List[Tuple[int, int]] = []
        for ordinal in sorted(hits):
            lo, hi = ordinal * bs, (ordinal + 1) * bs
            if spans and spans[-1][1] == lo:
                spans[-1] = (spans[-1][0], hi)
            else:
                spans.append((lo, hi))
        return Admission(n_shared, spans, n_shared_session=n_shared_session)

    def register_prefix(self, seq_id: int, tokens, layout=None):
        """Publish this sequence's fully written prompt blocks into the prefix
        index so later requests reuse them. Only immutable (full, in-segment)
        blocks are keyed; call only after the prompt's K/V is written through
        those blocks (in stream order); first writer wins."""
        if not self.prefix_sharing:
            return
        from repro_torch.serving.segments import build_layout

        if layout is None:
            layout = build_layout(np.asarray(tokens), self.block_size)
        table = self.pool.tables.get(seq_id, [])
        for i, key in enumerate(layout.block_keys):
            if key is None or i >= len(table):
                continue
            if key not in self._prefix_index:
                self._prefix_index[key] = table[i]
                self._block_key[table[i]] = key

    def release(self, seq_id: int):
        self.pool.free(seq_id)
        self.lengths.pop(seq_id, None)

    def batch_tables(self, seq_ids: List[int]) -> np.ndarray:
        """Block-table rows truncated to ``max_blocks`` (int32, pad = -1)."""
        return self.pool.table_array(seq_ids, self.max_blocks)

    def utilization(self) -> float:
        return self.pool.utilization()
