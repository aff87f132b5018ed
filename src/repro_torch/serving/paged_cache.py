"""Paged KV cache (vLLM-style PagedAttention), ported from
``repro.serving.paged_cache``.

A global pool of fixed-size blocks per layer group and a block table per
sequence. Blocks are reference counted so concurrent RAG requests that embed
the same retrieved documents share prefix blocks instead of recomputing
them; two keying schemes feed one prefix index — whole-prompt chained hashes
(``prefix_block_keys``) for flat prompts and segment-scoped keys
(``serving.segments.build_layout``) for ``SegmentedPrompt`` requests.
Releases keep refcount-0 keyed blocks warm in an LRU eviction queue.

Beneath the device pool sits an optional host-memory tier
(``serving.host_tier.HostBlockStore``): warm blocks evicted from the device
demote their contents to host, and admission promotes host-resident keyed
blocks back — a second-chance hit class between a device hit and a prefill
miss (``Admission.n_host``).

Pool layout (matching the JAX package):
    k/v: (G, n_blocks, block_size, KVH, hd) torch tensors on the engine's
    device, in the config's dtype or int8 (``kv_dtype="int8"``: per-(block,
    KV head) float32 running-max scales ride alongside, (G, n_blocks, KVH)).
    Unlike JAX, which returns new pools from every step, the step programs
    here update the pools (and scales) IN PLACE, one layer-group slice at a
    time.
Block tables: (max_seqs, max_blocks_per_seq) int32, -1 = unallocated.

Because the pools change in place, every device->host copy (demotion,
write-through, swap-out) gathers into a fresh tensor on the compute stream
when it is enqueued, behind the steps that wrote the blocks; only the host
side's wait is deferred (``device_to_host``).

The gather and chunk-write functions of the oracle paths (``gather_paged*``,
``write_paged_chunk*``, ``paged_validity``) are functions on tensors that
return NEW pools, as the JAX functions do; the engine's oracle steps land
them back in the cache box. ``sanitize=True`` attaches the lifecycle
sanitizer (``analysis.kvsan``). A DP replica's cache allocates from a
block range of a pool box it shares with its siblings (``block_range``,
``arrays``); a tensor-parallel rank's cache holds its shard of the KV
heads (``layout``, ``serving.sharded_pool.ShardedPoolLayout``).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    # the global id of the device array's first block: a rank that holds
    # only its replica's block range (``ShardedPoolLayout(dp_blocks=True)``)
    # keeps global ids here and rebases them where they meet the device
    base: int = 0
    # optional analysis.kvsan.KVSanitizer: every state transition below
    # mirrors into its shadow machine, which raises on lifecycle violations
    sanitizer: Optional[Any] = None

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

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_needed(n_tokens) <= self.n_free

    def _pop_block(self) -> int:
        if self.free_list:
            return self.free_list.pop()
        if not self.cached:
            raise MemoryError("paged pool exhausted: no free or warm block")
        b = next(iter(self.cached))  # evict least-recently-used warm block
        del self.cached[b]
        if self.sanitizer is not None:
            self.sanitizer.device_warm_evict(b)
        if self.on_free is not None:
            self.on_free(b)
        return b

    def touch(self, block_id: int):
        """LRU heat signal: a prefix-index hit moves a warm block to the back
        of the eviction queue even when the hitting request cannot be admitted
        yet (backpressure). O(1)."""
        if self.refcounts.get(block_id, 0) == 0 and block_id in self.cached:
            if self.sanitizer is not None:
                self.sanitizer.device_touch(block_id)
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
            if self.sanitizer is not None:
                self.sanitizer.device_alloc(b, seq_id)
        self.tables.setdefault(seq_id, []).extend(blocks)
        return blocks

    def share(self, seq_id: int, block_id: int) -> int:
        """Append an already-written block to ``seq_id``'s table, bumping its
        refcount (only fully written, immutable prompt blocks are shared).
        Reviving a warm cached block removes it from the eviction queue."""
        if self.sanitizer is not None:
            self.sanitizer.device_share(block_id, seq_id)
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
        # evicted before heads. A missing refcount counts as 1, as in the
        # JAX allocator: a stale table's second release then passes here,
        # and the sanitizer (when attached) is what catches it
        for b in reversed(self.tables.pop(seq_id, [])):
            if self.sanitizer is not None:
                self.sanitizer.device_release(b, seq_id)
            self.refcounts[b] = self.refcounts.get(b, 1) - 1
            if self.refcounts[b] <= 0:
                del self.refcounts[b]
                if self.keep_on_release is not None and self.keep_on_release(b):
                    self.cached[b] = None  # stays warm for prefix reuse
                    if self.sanitizer is not None:
                        self.sanitizer.device_warm(b)
                else:
                    self.free_list.append(b)
                    if self.sanitizer is not None:
                        self.sanitizer.device_free(b)
                    if self.on_free is not None:
                        self.on_free(b)

    def table_array(self, seq_ids: List[int], max_blocks: int) -> np.ndarray:
        """Dense block-table rows for a batch of sequences: ``np.int32``,
        entries past a sequence's chain padded with ``-1`` (never ``0`` —
        block 0 is an ordinary block), so device consumers treat negatives
        as absent. The ids are the device array's (rebased by ``base``)."""
        out = np.full((len(seq_ids), max_blocks), -1, dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            blocks = self.tables.get(sid, [])[:max_blocks]
            out[i, : len(blocks)] = np.asarray(blocks, np.int64) - self.base
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
# the oracle paths' gathers and chunk writes (new tensors, as in JAX)
# ---------------------------------------------------------------------------


def _table_blocks(tables, idx):
    """``tables[..., idx]`` along the last axis with ``idx`` clamped to the
    table, as a JAX gather clamps an out-of-range index. int64."""
    return torch.gather(tables.long(), -1, idx.clamp(max=tables.shape[-1] - 1))


def _chunk_dest(block_table_row, start, C: int, bs: int, n_valid, null_dest: int):
    """Flat pool slots (C,) of a C-token chunk at ``start``: unallocated
    table entries read block 0, padding (index >= ``n_valid``) goes to slot
    0 of the ``null_dest`` scratch block."""
    ar = torch.arange(C, device=block_table_row.device)
    pos = torch.as_tensor(start, device=ar.device).long() + ar
    dest = _table_blocks(block_table_row, pos // bs).clamp(min=0) * bs + pos % bs
    if n_valid is not None:
        n_valid = torch.as_tensor(n_valid, device=ar.device)
        dest = torch.where(ar < n_valid, dest, torch.full_like(dest, null_dest * bs))
    return dest


def _batch_dest(block_tables, starts, C: int, bs: int, n_valid, null_dest: int):
    """Flat pool slots (B, C) of B rows' C-token chunks at ``starts`` (B,),
    routed as in ``_chunk_dest`` row by row."""
    ar = torch.arange(C, device=block_tables.device)
    pos = starts.long()[:, None] + ar                          # (B, C)
    dest = _table_blocks(block_tables, pos // bs).clamp(min=0) * bs + pos % bs
    if n_valid is not None:
        dest = torch.where(ar[None, :] < n_valid.long()[:, None], dest,
                           torch.full_like(dest, null_dest * bs))
    return dest


def _scatter_new(pool_kv, dest, new_kv):
    """A copy of pool_kv (G, nb, bs, KVH, hd) with ``new_kv`` (G, N, KVH,
    hd) at flat slots ``dest`` (N,)."""
    G, nb, bs = pool_kv.shape[:3]
    out = pool_kv.clone()
    out.view(G, nb * bs, *pool_kv.shape[3:])[:, dest] = new_kv.to(out.dtype)
    return out


def write_paged(pool_kv, block_table_row, pos, new_kv, block_size: int):
    """Write one token's (G, KVH, hd) entry at absolute position ``pos`` for
    the sequence whose blocks are ``block_table_row`` (max_blocks,) int32.
    pool_kv: (G, n_blocks, bs, KVH, hd). Returns a new pool."""
    pos = torch.as_tensor(pos, device=block_table_row.device).long().reshape(1)
    blk = _table_blocks(block_table_row, pos // block_size)
    return _scatter_new(pool_kv, blk * block_size + pos % block_size, new_kv[:, None])


def write_paged_chunk(pool_kv, block_table_row, start, new_kv, block_size: int,
                      n_valid=None, null_dest: int = 0):
    """Bulk write of a C-token chunk new_kv (G, C, KVH, hd) at absolute
    positions ``start .. start+C-1`` of one sequence. ``n_valid`` masks
    trailing padding tokens: their writes go to slot 0 of the ``null_dest``
    scratch block, which nothing reads. Returns a new pool."""
    dest = _chunk_dest(block_table_row, start, new_kv.shape[1], block_size, n_valid,
                       null_dest)
    return _scatter_new(pool_kv, dest, new_kv)


def write_paged_chunk_batch(pool_kv, block_tables, starts, new_kv, block_size: int,
                            n_valid=None, null_dest: int = 0):
    """Multi-row chunk scatter (the padded fused step; decode rows are
    chunks with ``n_valid == 1``): block_tables (B, mb) int32; starts/n_valid
    (B,); new_kv (G, B, C, KVH, hd). Padding goes to the scratch block.
    Returns a new pool."""
    G, B, C = new_kv.shape[:3]
    dest = _batch_dest(block_tables, starts, C, block_size, n_valid, null_dest)
    return _scatter_new(pool_kv, dest.reshape(-1), new_kv.reshape(G, B * C, *new_kv.shape[3:]))


def gather_paged(pool_kv, block_table_row, max_blocks: int):
    """A sequence's contiguous cache view (G, max_blocks*bs, KVH, hd) from
    its pages; unallocated pages read block 0 and must be masked by
    validity downstream."""
    safe = block_table_row[:max_blocks].long().clamp(min=0)
    g = pool_kv[:, safe]                                       # (G, mb, bs, KVH, hd)
    G, nb, bs = g.shape[:3]
    return g.reshape(G, nb * bs, *g.shape[3:])


def gather_paged_batch(pool_kv, block_tables):
    """Batched gather: block_tables (B, mb) -> (G, B, mb*bs, KVH, hd), the
    contiguous per-row view the oracle steps consume."""
    safe = block_tables.long().clamp(min=0)
    g = pool_kv[:, safe]                                       # (G, B, mb, bs, KVH, hd)
    G, B, mb, bs = g.shape[:4]
    return g.reshape(G, B, mb * bs, *g.shape[4:])


def paged_validity(block_table_row, length, block_size: int, max_blocks: int):
    """(max_blocks*block_size,) bool: the slot is backed by a real page AND
    below the sequence length."""
    slots = torch.arange(max_blocks * block_size, device=block_table_row.device)
    backed = block_table_row.long()[slots // block_size] >= 0
    return backed & (slots < torch.as_tensor(length, device=slots.device))


# ---------------------------------------------------------------------------
# int8 quantized pool scatters (per-block, per-KV-head running-max scales)
# ---------------------------------------------------------------------------


def _quantized_scatter(pool_kv, scales, dest, new_vals):
    """Core of every quantized write, in place: scatter float K/V entries
    into an int8 pool, keeping per-(block, KV head) absmax scales.

    pool_kv: (G, nb, bs, KVH, hd) int8; scales: (G, nb, KVH) float32; dest:
    (N,) flat slots (block * bs + offset, pads already routed to the scratch
    block); new_vals: (G, N, KVH, hd) floats. Returns ``(pool_kv, scales)``.

    The same operations in the same order as the JAX function, so the two
    agree bit for bit: a running-max scale (``max(old, absmax(new)/127)``);
    the affected blocks requantised as ``round(q * old/new)`` (ratio 1 where
    the new scale is 0); the new entries quantised with the NEW scale;
    round half to even, clamps to +-127, 1e-30 floors, and true division
    (no scalar divisor, see below). JAX rescales
    from a gather of the old blocks and then sets them; in place, every
    affected block is likewise read before any is written (a block named
    twice in ``dest`` gets the same rescaled values twice, never a second
    rescale)."""
    G, nb, bs = pool_kv.shape[0], pool_kv.shape[1], pool_kv.shape[2]
    dest = dest.long()
    blk = dest // bs                                              # (N,)
    absmax = new_vals.float().abs().amax(dim=-1)                  # (G, N, KVH)
    blk_max = torch.zeros_like(scales).scatter_reduce_(
        1, blk[None, :, None].expand_as(absmax), absmax, "amax")
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, one ulp off the true quotient that JAX and the CPU take
    new_scales = torch.maximum(scales, blk_max / torch.full_like(blk_max, 127.0))
    ratio = torch.where(new_scales > 0.0, scales / new_scales.clamp(min=1e-30),
                        torch.ones_like(scales))
    old_blocks = pool_kv[:, blk].float()                          # (G, N, bs, KVH, hd)
    r = ratio[:, blk]                                             # (G, N, KVH)
    rescaled = torch.round(old_blocks * r[:, :, None, :, None]).clamp(-127, 127)
    pool_kv[:, blk] = rescaled.to(pool_kv.dtype)
    s_dest = new_scales[:, blk].clamp(min=1e-30)                  # (G, N, KVH)
    q = torch.round(new_vals.float() / s_dest[:, :, :, None]).clamp(-127, 127)
    flat = pool_kv.view(G, nb * bs, *pool_kv.shape[3:])
    flat[:, dest] = q.to(pool_kv.dtype)
    scales.copy_(new_scales)
    return pool_kv, scales


def write_paged_packed_q(pool_kv, scales, block_tables, row_of, slots, new_kv,
                         block_size: int, null_dest: int = 0):
    """Quantized ``write_paged_packed``: one layer group's int8 pool slice
    (n_blocks, bs, KVH, hd) and scale slice (n_blocks, KVH), both updated in
    place. Returns ``(pool_kv, scales)``."""
    dest = packed_slots(block_tables, row_of, slots, block_size, null_dest)
    _quantized_scatter(pool_kv[None], scales[None], dest, new_kv[None])
    return pool_kv, scales


def dequantize_blocks(blocks, block_scales, out_dtype=torch.float32):
    """Dequantize gathered int8 blocks (..., bs, KVH, hd) with matching
    per-block scales (..., KVH): broadcast-multiply over slot and head dims."""
    return blocks.to(out_dtype) * block_scales[..., None, :, None].to(out_dtype)


def write_paged_chunk_q(pool_kv, scales, block_table_row, start, new_kv,
                        block_size: int, n_valid=None, null_dest: int = 0):
    """Quantized ``write_paged_chunk``: the same routing into an int8 pool
    through ``_quantized_scatter``. Returns new ``(pool, scales)``."""
    dest = _chunk_dest(block_table_row, start, new_kv.shape[1], block_size, n_valid,
                       null_dest)
    return _quantized_scatter(pool_kv.clone(), scales.clone(), dest, new_kv)


def write_paged_chunk_batch_q(pool_kv, scales, block_tables, starts, new_kv,
                              block_size: int, n_valid=None, null_dest: int = 0):
    """Quantized ``write_paged_chunk_batch``. Returns new ``(pool, scales)``."""
    G, B, C = new_kv.shape[:3]
    dest = _batch_dest(block_tables, starts, C, block_size, n_valid, null_dest)
    return _quantized_scatter(pool_kv.clone(), scales.clone(), dest.reshape(-1),
                              new_kv.reshape(G, B * C, *new_kv.shape[3:]))


def gather_paged_dq(pool_kv, scales, block_table_row, max_blocks: int,
                    out_dtype=torch.float32):
    """``gather_paged`` of a quantized pool: the dequantized contiguous view.
    With ``scales=None``, the plain gather."""
    if scales is None:
        return gather_paged(pool_kv, block_table_row, max_blocks)
    safe = block_table_row[:max_blocks].long().clamp(min=0)
    g = dequantize_blocks(pool_kv[:, safe], scales[:, safe], out_dtype)
    G, nb, bs = g.shape[:3]
    return g.reshape(G, nb * bs, *g.shape[3:])


def gather_paged_batch_dq(pool_kv, scales, block_tables, out_dtype=torch.float32):
    """``gather_paged_batch`` of a quantized pool: the batched dequantized
    view. With ``scales=None``, the plain gather."""
    if scales is None:
        return gather_paged_batch(pool_kv, block_tables)
    safe = block_tables.long().clamp(min=0)
    g = dequantize_blocks(pool_kv[:, safe], scales[:, safe], out_dtype)
    G, B, mb, bs = g.shape[:4]
    return g.reshape(G, B, mb * bs, *g.shape[4:])


# ---------------------------------------------------------------------------
# device <-> host copies
# ---------------------------------------------------------------------------


def device_to_host(*tensors):
    """Start copying FRESH device tensors (gathers, never views of a pool
    that later steps write) to host memory. Returns the host tensors and a
    ``wait`` that must run before they are read. On CUDA each copy goes
    into a new pinned buffer, non-blocking, on the current stream behind
    the work that produced the tensor; ``wait`` blocks on an event recorded
    after the copies. On the CPU the tensors are returned as they are.
    ``None`` entries pass through."""
    live = [t for t in tensors if t is not None]
    if not live or not live[0].is_cuda:
        return tensors, lambda: None
    host = tuple(None if t is None else torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in tensors)
    for h, t in zip(host, tensors):
        if t is not None:
            h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event.synchronize


def host_to_device(t, device):
    """Copy a host tensor to ``device``: on CUDA through a pinned staging
    copy, non-blocking on the current stream (the caching host allocator
    keeps the staging buffer until the copy has run), so the caller's
    tensor may be reused at once."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


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
    """Result of admission-controlled allocation for a prompt.
    ``shared_spans`` covers both hit classes (device-shared blocks and blocks
    promoted from the host tier hold exact KV either way); ``n_shared`` and
    ``n_host`` split the token counts per tier, and the ``*_session`` counts
    the session-history subset of each."""

    n_shared: int                       # prompt tokens from device-shared blocks
    shared_spans: List[Tuple[int, int]]  # token ranges prefill may skip
    n_host: int = 0                     # prompt tokens promoted from the host tier
    n_shared_session: int = 0           # session-history subset of n_shared
    n_host_session: int = 0             # session-history subset of n_host


class PoolArrays:
    """Device-side k/v pool tensors, boxed so they can be shared (DP
    replicas over one pool: ``DataParallelEngineGroup``). Quantized pools carry
    per-(block, KV head) float32 scale pools ``k_scale``/``v_scale`` of
    shape (G, n_blocks, KVH); both are ``None`` for float pools."""

    __slots__ = ("k", "v", "k_scale", "v_scale")

    def __init__(self, k, v, k_scale=None, v_scale=None):
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale


class PagedKVCache:
    """End-to-end paged cache for one model: one pool per K and V with a
    leading layer-group axis, a host-side allocator, and the prefix index.

    ``admit_tokens``/``register_prefix`` take an optional
    ``serving.segments.SegmentLayout``: segmented prompts key per-document
    blocks independently of document order, so hits can be non-contiguous
    (``Admission.shared_spans`` lists every skippable token range).

    ``kv_dtype="int8"`` stores the pools quantized, with per-(block, KV
    head) scale pools beside them. ``host_store`` attaches the host tier:
    evicted warm blocks demote there and ``admit_tokens`` promotes
    host-resident keys back; ``host_write_through`` also copies every newly
    published prefix block there at ``register_prefix``. ``client_tag``
    names this cache to a possibly shared store. ``sanitize=True`` attaches
    an ``analysis.kvsan.KVSanitizer`` that mirrors every block lifecycle
    transition of the pool and the host tier in a shadow state machine and
    raises ``KVSanError`` on a violation (a debug mode); ``sanitizer``
    injects one instead.

    ``block_range=(lo, hi)`` restricts allocation to blocks [lo, hi) for a
    DP replica with independent admission (``serving.sharded_pool
    .block_range``), and ``arrays`` shares one ``PoolArrays`` box between
    such replicas: a cache built on a quantized box is an int8 cache.
    ``layout`` (a ``serving.sharded_pool.ShardedPoolLayout``) makes the
    pools this rank's shard, ``KVH / tp`` heads of every block (float pools
    only, as in JAX); the host-side block metadata stays whole on every
    rank. A layout that splits blocks over "data" (``dp_blocks``) makes
    them ``hi - lo`` blocks, this rank's ``block_range`` only: the host
    metadata (free list, refcounts, prefix index, tables, the sanitizer's
    shadow) keeps global ids, and ``table_array``, the scatters' slots and
    the host-tier copies see them rebased by ``lo`` (``pool.base``).

    The legacy per-sequence API (``admit``, ``write_token``,
    ``write_prefill``, ``sequence_view``) streams K/V in without token
    identity, through the oracle paths' functions."""

    def __init__(self, cfg, n_blocks: int = 256, block_size: int = 16,
                 max_blocks_per_seq: int = 64, prefix_sharing: bool = True,
                 device=None, layout=None, block_range=None, arrays=None,
                 host_store=None, host_write_through: bool = False,
                 client_tag=None, kv_dtype: Optional[str] = None,
                 sanitize: bool = False, sanitizer=None):
        if layout is not None:
            layout.validate(cfg)
            if kv_dtype is not None:
                raise ValueError("kv_dtype='int8' is single-device only: the parallel "
                                 "scale pools do not shard over a mesh yet")
        if kv_dtype is not None and kv_dtype != "int8":
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        lo, hi = block_range if block_range is not None else (0, n_blocks)
        if not (0 <= lo < hi <= n_blocks):
            raise ValueError(f"block_range {(lo, hi)} outside [0, {n_blocks})")
        # a rank whose layout splits the block axis holds [lo, hi) only
        local = (layout.pool_shape(cfg, n_blocks, block_size)[1] if layout is not None
                 else n_blocks)
        if local != n_blocks and (block_range is None or hi - lo != local):
            raise ValueError(
                f"this rank's pool shard holds {local} of {n_blocks} blocks (dp_blocks): the "
                f"cache needs its replica's block_range of that size, got {block_range}")
        from repro_torch import resolve_device
        from repro_torch.models.transformer import period

        self.cfg = cfg
        self.layout = layout
        self.block_size = block_size
        self.max_blocks = max_blocks_per_seq
        if arrays is not None and device is None:
            device = arrays.k.device  # a shared box decides where the pools live
        self.device = resolve_device(device)
        self.kv_dtype = kv_dtype
        G = cfg.num_layers // period(cfg)
        if sanitizer is None and sanitize:
            from repro_torch.analysis.kvsan import KVSanitizer

            sanitizer = KVSanitizer()
        self.sanitizer = sanitizer
        self.pool = PagedPool(
            n_blocks, block_size,
            free_list=list(range(lo, hi)),
            base=lo if local != n_blocks else 0,
            on_free=self._forget_block,
            keep_on_release=lambda b: b in self._block_key,
            sanitizer=sanitizer,
        )
        if sanitizer is not None and host_store is not None \
                and getattr(host_store, "sanitizer", None) is None:
            host_store.sanitizer = sanitizer
        if arrays is None:
            shape = (layout.pool_shape(cfg, n_blocks, block_size) if layout is not None
                     else (G, n_blocks, block_size, cfg.num_kv_heads, cfg.head_dim))
            dt = torch.int8 if kv_dtype == "int8" else torch_dtype(cfg)
            zeros = lambda shp, d: torch.zeros(shp, dtype=d, device=self.device)
            scales = (None, None)
            if kv_dtype == "int8":
                sshape = (G, n_blocks, cfg.num_kv_heads)
                scales = (zeros(sshape, torch.float32), zeros(sshape, torch.float32))
            arrays = PoolArrays(zeros(shape, dt), zeros(shape, dt), *scales)
        self._arrays = arrays
        if self.kv_dtype is None and arrays.k_scale is not None:
            self.kv_dtype = "int8"  # shared box from a quantized sibling
        self.lengths: Dict[int, int] = {}
        self.prefix_sharing = prefix_sharing
        self.host_store = host_store
        self.host_write_through = host_write_through
        self.client_tag = client_tag if client_tag is not None else id(self)
        # async copy engine (serving.control_plane.CopyEngine), set by the
        # engine: demotions and write-through publishes then defer their
        # host-side wait off the step's critical path. None = synchronous
        # copies; the host tier's contents are the same either way.
        self.copy_engine = None
        self._wt_pending: List[Tuple[int, bytes]] = []  # (block, key) to write through
        self._prefix_index: Dict[bytes, int] = {}   # chain hash -> block id
        self._block_key: Dict[int, bytes] = {}      # reverse map for eviction
        self.shared_token_hits = 0                  # prompt tokens from shared blocks
        self.host_token_hits = 0                    # prompt tokens promoted from host
        self.session_token_hits = 0                 # session-history subsets of
        self.session_host_token_hits = 0            # the two counters above

    # the main path updates these tensors in place; the oracle steps and
    # the legacy API land new ones through the setters
    @property
    def k(self):
        return self._arrays.k

    @k.setter
    def k(self, value):
        self._arrays.k = value

    @property
    def v(self):
        return self._arrays.v

    @v.setter
    def v(self, value):
        self._arrays.v = value

    @property
    def k_scale(self):
        return self._arrays.k_scale

    @k_scale.setter
    def k_scale(self, value):
        self._arrays.k_scale = value

    @property
    def v_scale(self):
        return self._arrays.v_scale

    @v_scale.setter
    def v_scale(self, value):
        self._arrays.v_scale = value

    @property
    def quantized(self) -> bool:
        return self._arrays.k_scale is not None

    def _ids(self, ids) -> torch.Tensor:
        """Global block ids as the device array's (rebased by ``pool.base``),
        on the pool's device, uploaded without a sync (a pageable upload
        would wait for the step in flight)."""
        return host_to_device(torch.from_numpy(np.asarray(ids, np.int64) - self.pool.base),
                              self.device)

    def reset_block_scales(self, ids) -> None:
        """Zero the scales of freshly allocated blocks: a running max only
        grows while a block is written, so a reused block must not inherit
        its previous tenant's absmax. No-op for float pools."""
        if not self.quantized or not len(ids):
            return
        idx = self._ids(ids)
        self.k_scale[:, idx] = 0.0
        self.v_scale[:, idx] = 0.0

    def gather_blocks(self, ids):
        """Fresh device copies of blocks ``ids``: ``(k, v, k_scale,
        v_scale)`` of (G, n, bs, KVH, hd) and (G, n, KVH) (scales None for
        float pools). Gathers, never views: the pool changes in place."""
        idx = self._ids(ids)
        if self.quantized:
            return self.k[:, idx], self.v[:, idx], self.k_scale[:, idx], self.v_scale[:, idx]
        return self.k[:, idx], self.v[:, idx], None, None

    def write_blocks(self, ids, k, v, k_scale=None, v_scale=None) -> None:
        """Copy host blocks (G, n, bs, KVH, hd) (and their (G, n, KVH)
        scales for an int8 pool) into pool blocks ``ids``."""
        idx = self._ids(ids)
        self.k[:, idx] = host_to_device(k, self.device)
        self.v[:, idx] = host_to_device(v, self.device)
        if k_scale is not None:
            self.k_scale[:, idx] = host_to_device(k_scale, self.device)
            self.v_scale[:, idx] = host_to_device(v_scale, self.device)

    # ----------------------------------------------------------- host side
    def _forget_block(self, block_id: int):
        key = self._block_key.pop(block_id, None)
        if key is None or self._prefix_index.get(key) != block_id:
            return
        del self._prefix_index[key]
        if self.host_store is None:
            return
        # demotion: the block is being reclaimed but its contents are still
        # intact (its new owner writes later); mirror them to the host tier
        # so the key stays promotable. A resident key only re-heats.
        if self.host_store.contains(key):
            self.host_store.touch(key)
            return
        host, wait = device_to_host(*self.gather_blocks([block_id]))
        store, owner = self.host_store, self.client_tag

        def _demote(key=key, host=host, wait=wait):
            wait()
            if store.contains(key):
                store.touch(key)  # raced with a write-through or put
                return
            k, v, ks, vs = host
            store.put(key, k[:, 0], v[:, 0], owner=owner,
                      k_scale=None if ks is None else ks[:, 0],
                      v_scale=None if vs is None else vs[:, 0])

        if self.copy_engine is not None:
            self.copy_engine.submit(_demote, tag=key)
        else:
            _demote()

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

    def _host_block_hits(self, n_tokens: int, layout,
                         hbm_hits: Dict[int, int]) -> Dict[int, bytes]:
        """Block ordinal -> prefix key for every keyed block that misses the
        device index but is resident in the host tier, with the exclusions
        of ``_block_hits``. Re-heats each such key now: allocation may demote
        evicted device blocks into the store, whose LRU must take colder
        keys first."""
        if self.host_store is None or not self.prefix_sharing or not n_tokens:
            return {}
        last_block = (n_tokens - 1) // self.block_size
        out: Dict[int, bytes] = {}
        for ordinal, key in enumerate(layout.block_keys):
            if key is None or ordinal == last_block or ordinal in hbm_hits:
                continue
            if self.host_store.contains(key):
                out[ordinal] = key
                self.host_store.touch(key)
        return out

    def _promote_host_blocks(self, promote: List[Tuple[int, bytes]]):
        """Copy host-resident blocks into freshly allocated device blocks
        (one batched host->device scatter) and publish their keys in the
        device index, so the next request with the same content hits there."""
        keys = [key for _, key in promote]
        self.write_blocks([b for b, _ in promote],
                          *self.host_store.read(keys, owner=self.client_tag))
        for b, key in promote:
            if key not in self._prefix_index:  # first writer wins
                self._prefix_index[key] = b
                self._block_key[b] = key
                if self.sanitizer is not None:
                    self.sanitizer.device_key(b, key)

    def admit_tokens(self, seq_id: int, tokens, layout=None) -> Optional[Admission]:
        """Admission-controlled allocation for a prompt. Reuses every cached
        keyed block (+1 slack block for decode) and returns the admission
        record — or None when the pool cannot fit the request (backpressure).

        Invariants: all-or-nothing (on None nothing was allocated, shared or
        promoted; headroom counts new blocks AND warm revivals, revivals by
        unique block id); on success ``tables[seq_id]`` holds exactly
        ``blocks_needed(len(tokens)) + 1`` entries in prompt-block order
        (host hits take fresh blocks, filled from the host tier); the block
        of the final prompt token is never served from cache;
        ``shared_spans`` are disjoint, sorted, block-aligned token ranges
        covering both hit tiers."""
        from repro_torch.serving.segments import build_layout

        Lp = len(tokens)
        if layout is None:
            layout = build_layout(np.asarray(tokens), self.block_size)
        bs = self.block_size
        n_blocks = self.pool.blocks_needed(Lp)
        hits = self._block_hits(tokens, layout)
        host_hits = self._host_block_hits(Lp, layout, hits)
        n_new = n_blocks - len(hits) + 1
        n_warm = sum(
            1 for b in set(hits.values()) if self.pool.refcounts.get(b, 0) == 0
        )
        if n_new + n_warm > self.pool.n_free:
            return None
        promote: List[Tuple[int, int, bytes]] = []  # (ordinal, block, key)
        fresh: List[int] = []
        for ordinal in range(n_blocks):
            if ordinal in hits:
                self.pool.share(seq_id, hits[ordinal])
            else:
                b = self.pool.allocate(seq_id, 1)[0]
                fresh.append(b)
                if ordinal in host_hits:
                    promote.append((ordinal, b, host_hits[ordinal]))
        fresh.extend(self.pool.allocate(seq_id, 1))  # decode slack block
        self.reset_block_scales(fresh)
        # allocation may have demoted evicted blocks into the host store,
        # whose LRU can drop a pending-promote key under extreme pressure:
        # such ordinals degrade to ordinary misses
        promote = [(o, b, k) for o, b, k in promote if self.host_store.contains(k)]
        if promote:
            self._promote_host_blocks([(b, k) for _o, b, k in promote])
        n_shared = len(hits) * bs
        n_host = len(promote) * bs
        hist = layout.history_block_set() if layout.seg_spans else set()
        n_shared_session = sum(bs for o in hits if o in hist)
        n_host_session = sum(bs for o, _b, _k in promote if o in hist)
        self.lengths[seq_id] = 0
        self.shared_token_hits += n_shared
        self.host_token_hits += n_host
        self.session_token_hits += n_shared_session
        self.session_host_token_hits += n_host_session
        spans: List[Tuple[int, int]] = []
        for ordinal in sorted(set(hits) | {o for o, _b, _k in promote}):
            lo, hi = ordinal * bs, (ordinal + 1) * bs
            if spans and spans[-1][1] == lo:
                spans[-1] = (spans[-1][0], hi)
            else:
                spans.append((lo, hi))
        return Admission(n_shared, spans, n_host, n_shared_session=n_shared_session,
                         n_host_session=n_host_session)

    def register_prefix(self, seq_id: int, tokens, layout=None):
        """Publish this sequence's fully written prompt blocks into the prefix
        index so later requests reuse them. Only immutable (full, in-segment)
        blocks are keyed; call only after the prompt's K/V is written through
        those blocks (in stream order); first writer wins. With write-through,
        newly published blocks are copied to the host tier too: at once
        without a copy engine, else queued for ``flush_write_through``."""
        if not self.prefix_sharing:
            return
        from repro_torch.serving.segments import build_layout

        if layout is None:
            layout = build_layout(np.asarray(tokens), self.block_size)
        table = self.pool.tables.get(seq_id, [])
        published: List[Tuple[int, bytes]] = []
        for i, key in enumerate(layout.block_keys):
            if key is None or i >= len(table):
                continue
            if key not in self._prefix_index:
                self._prefix_index[key] = table[i]
                self._block_key[table[i]] = key
                if self.sanitizer is not None:
                    self.sanitizer.device_key(table[i], key)
                published.append((table[i], key))
        if published and self.host_store is not None and self.host_write_through:
            # the pipelined control plane registers prefixes at plan-BUILD
            # time, before the plan that writes the completing chunk is
            # dispatched: with a copy engine, gather after that dispatch
            self._wt_pending.extend(published)
            if self.copy_engine is None:
                self.flush_write_through()

    def flush_write_through(self) -> None:
        """Copy queued write-through publishes to the host tier. MUST run
        after the plan that completes the published blocks has been
        dispatched: the gather is enqueued behind it on the stream. Blocks
        whose key was forgotten meanwhile are skipped (their demotion
        already mirrored or dropped them)."""
        pend = [(b, key) for b, key in self._wt_pending if self._block_key.get(b) == key]
        self._wt_pending = []
        if not pend or self.host_store is None:
            return
        host, wait = device_to_host(*self.gather_blocks([b for b, _ in pend]))
        store, owner = self.host_store, self.client_tag

        def _publish(host=host, wait=wait, pend=tuple(pend)):
            wait()
            k, v, ks, vs = host
            for j, (_b, key) in enumerate(pend):
                store.put(key, k[:, j], v[:, j], owner=owner,
                          k_scale=None if ks is None else ks[:, j],
                          v_scale=None if vs is None else vs[:, j])

        if self.copy_engine is not None:
            self.copy_engine.submit(_publish, tag="write_through")
        else:
            _publish()

    def admit(self, seq_id: int, prompt_len: int) -> bool:
        """Length-only admission (no prefix sharing), for callers that stream
        K/V in without token identity."""
        if not self.pool.can_allocate(prompt_len + self.block_size):
            return False  # backpressure: the caller keeps the request queued
        self.reset_block_scales(self.pool.allocate(seq_id, prompt_len + self.block_size))
        self.lengths[seq_id] = 0
        return True

    def release(self, seq_id: int):
        self.pool.free(seq_id)
        self.lengths.pop(seq_id, None)

    def batch_tables(self, seq_ids: List[int]) -> np.ndarray:
        """Block-table rows truncated to ``max_blocks`` (int32, pad = -1)."""
        return self.pool.table_array(seq_ids, self.max_blocks)

    # --------------------------------------------------------- device side
    def _row(self, seq_id: int) -> torch.Tensor:
        """The sequence's block-table row (max_blocks,) int32 on the pool's
        device (-1 past its chain: the gathers clamp, validity masks)."""
        # pad-ok: write_token writes only position lengths[seq], in a block
        # extend_for just reserved; write_prefill's Lp tokens were reserved by
        # the caller's allocate (and _chunk_dest clamps); sequence_view's
        # gathers clamp pad rows and paged_validity masks them.
        row = self.pool.table_array([seq_id], self.max_blocks)[0]   # already rebased
        return host_to_device(torch.from_numpy(row), self.device)

    def write_token(self, seq_id: int, k_entry, v_entry):
        """k/v_entry: (G, KVH, hd) for the next position of ``seq_id``."""
        pos = self.lengths[seq_id]
        new_blk = self.pool.extend_for(seq_id, pos + 1)
        if new_blk is not None:
            self.reset_block_scales([new_blk])
        row = self._row(seq_id)
        if self.quantized:
            self.k, self.k_scale = write_paged_chunk_q(
                self.k, self.k_scale, row, pos, k_entry[:, None], self.block_size)
            self.v, self.v_scale = write_paged_chunk_q(
                self.v, self.v_scale, row, pos, v_entry[:, None], self.block_size)
        else:
            self.k = write_paged(self.k, row, pos, k_entry, self.block_size)
            self.v = write_paged(self.v, row, pos, v_entry, self.block_size)
        self.lengths[seq_id] = pos + 1

    def write_prefill(self, seq_id: int, k_seq, v_seq):
        """k/v_seq: (G, Lp, KVH, hd), a prefilled prompt written in one
        scatter into the blocks the caller's admission reserved."""
        row = self._row(seq_id)
        if self.quantized:
            self.k, self.k_scale = write_paged_chunk_q(
                self.k, self.k_scale, row, 0, k_seq, self.block_size)
            self.v, self.v_scale = write_paged_chunk_q(
                self.v, self.v_scale, row, 0, v_seq, self.block_size)
        else:
            self.k = write_paged_chunk(self.k, row, 0, k_seq, self.block_size)
            self.v = write_paged_chunk(self.v, row, 0, v_seq, self.block_size)
        self.lengths[seq_id] = k_seq.shape[1]

    def sequence_view(self, seq_id: int) -> Tuple:
        """(k, v, valid): the contiguous gathered view (dequantized to
        float32 for an int8 pool) and its validity mask."""
        row = self._row(seq_id)
        k = gather_paged_dq(self.k, self.k_scale, row, self.max_blocks)
        v = gather_paged_dq(self.v, self.v_scale, row, self.max_blocks)
        valid = paged_validity(row, self.lengths[seq_id], self.block_size, self.max_blocks)
        return k, v, valid

    def utilization(self) -> float:
        return self.pool.utilization()
