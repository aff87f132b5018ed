"""Host-memory KV block tier: the level beneath the device block pools,
ported from ``repro.serving.host_tier``.

The ``HostBlockStore`` mirrors the device pools' block geometry (``(G,
block, block_size, KVH, hd)``, the same segment-scoped prefix keys as
``serving.paged_cache``) in host memory, for three roles:

* **Demotion target for the warm-cache LRU.** When the device pool reclaims
  a warm (refcount-0 but prefix-indexed) block, its contents demote here
  (``PagedKVCache._forget_block``); a later request whose key misses the
  device index but hits here is promoted back with one host->device copy
  instead of a prefill.
* **Swap-out preemption staging.** ``preempt="swap"`` parks a victim's whole
  block chain here and restores it on re-admission. Swap sets are *pinned*:
  keyed blocks may be evicted to make room, swap sets never are
  (``restore_seq``/``drop_seq`` are the only exits).
* **Cross-replica sharing.** Keys are content hashes, so one store can serve
  several caches; ``put``/``read`` carry an ``owner`` tag (``cross_hits``).
  Replicas in processes of their own keep a store each and exchange the
  blocks they put (``journal``, ``block``; ``serving.engine.
  DataParallelEngineGroup`` on a data-axis mesh).

The slabs are torch CPU tensors: numpy has no bfloat16 of its own. They are
pinned when the store serves a CUDA pool (``pin=True``), so the pool's
device<->host copies can run asynchronously. Everything else is plain dict
bookkeeping, single-threaded like the rest of the allocator. The device-side
copies live with the callers (``serving.paged_cache``, ``serving.engine``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch


class HostBlockStore:
    """Fixed-capacity host block slab with a keyed LRU region and pinned
    swap sets.

    Invariants:

    * every slot is exactly one of free, keyed (in ``_by_key``/``_lru``) or
      pinned in a swap set — ``len(free) + n_keyed + n_swapped == n_blocks``;
    * keyed slots form an LRU (hits re-heat), evicted oldest first when
      capacity is needed;
    * swap sets are never evicted; ``reserve_seq`` is all-or-nothing;
    * once every engine drains, ``n_swapped == 0``.
    """

    def __init__(self, block_shape: Tuple[int, int, int, int], dtype: torch.dtype,
                 n_blocks: int = 256, pin: bool = False):
        G, bs, KVH, hd = block_shape
        self.n_blocks = n_blocks
        self.block_size = bs
        shape = (G, n_blocks, bs, KVH, hd)
        self.k = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        self.v = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        # int8 pools carry per-(block, KV-head) scales through the tier: a
        # promoted or swapped-in block must dequantize as it did on device
        self.quantized = dtype == torch.int8
        if self.quantized:
            self.k_scale = torch.zeros((G, n_blocks, KVH), dtype=torch.float32,
                                       pin_memory=pin)
            self.v_scale = torch.zeros((G, n_blocks, KVH), dtype=torch.float32,
                                       pin_memory=pin)
        else:
            self.k_scale = self.v_scale = None
        self.free: List[int] = list(range(n_blocks))
        # optional analysis.kvsan.KVSanitizer: slot transitions mirror into
        # its shadow (attached by PagedKVCache(sanitize=True))
        self.sanitizer: Optional[Any] = None
        self._by_key: Dict[bytes, int] = {}     # prefix key -> slot
        self._key_of: Dict[int, bytes] = {}     # reverse map
        self._lru: Dict[bytes, None] = {}       # keyed slots, eviction order
        self._producer: Dict[bytes, Any] = {}   # key -> owner tag that demoted it
        self._swap: Dict[Any, List[int]] = {}   # swap tag -> pinned slots
        # (key, owner) of each block ``put`` inserts while a list is set:
        # the rows of a data-axis mesh exchange these after a group step
        self.journal: Optional[List[Tuple[bytes, Any]]] = None
        self.puts = 0
        self.hits = 0
        self.cross_hits = 0   # promotions whose producer was a different owner
        self.evictions = 0
        self.swap_outs = 0
        self.swap_ins = 0

    @classmethod
    def for_config(cls, cfg, n_blocks: int, block_size: int,
                   kv_dtype: Optional[str] = None, pin: bool = False) -> "HostBlockStore":
        """Mirror the device pool geometry of ``PagedKVCache`` for ``cfg``;
        ``kv_dtype="int8"`` mirrors a quantized pool (int8 payload + scale
        slabs). ``pin`` pins the slabs (a store beside a CUDA pool)."""
        from repro_torch.models.transformer import period
        from repro_torch.params import torch_dtype

        G = cfg.num_layers // period(cfg)
        dtype = torch.int8 if kv_dtype == "int8" else torch_dtype(cfg)
        return cls((G, block_size, cfg.num_kv_heads, cfg.head_dim), dtype,
                   n_blocks=n_blocks, pin=pin)

    # ------------------------------------------------------------- capacity
    @property
    def n_swapped(self) -> int:
        return sum(len(s) for s in self._swap.values())

    @property
    def n_keyed(self) -> int:
        return len(self._by_key)

    @property
    def block_bytes(self) -> int:
        """Host bytes of one block: K and V payloads plus their scales."""
        n = 2 * self.k[:, 0].numel() * self.k.element_size()
        if self.quantized:
            n += 2 * self.k_scale[:, 0].numel() * 4
        return n

    def utilization(self) -> float:
        return 1.0 - len(self.free) / max(self.n_blocks, 1)

    def _evict_one(self) -> Optional[int]:
        """Reclaim the least-recently-used keyed slot (swap sets are pinned)."""
        if not self._lru:
            return None
        key = next(iter(self._lru))
        del self._lru[key]
        slot = self._by_key.pop(key)
        del self._key_of[slot]
        self._producer.pop(key, None)
        self.evictions += 1
        if self.sanitizer is not None:
            self.sanitizer.host_evict(key, slot)
        return slot

    def _take_slot(self) -> Optional[int]:
        if self.free:
            return self.free.pop()
        return self._evict_one()

    def _touch(self, key: bytes) -> None:
        if key in self._lru:
            del self._lru[key]
            self._lru[key] = None  # move to the MRU end, O(1)

    def touch(self, key: bytes) -> None:
        """Public re-heat: move a resident key to the MRU end so intervening
        evictions take colder keys first."""
        self._touch(key)

    # ------------------------------------------------------ keyed (cache) API
    def contains(self, key: bytes) -> bool:
        return key in self._by_key

    def put(self, key: bytes, k_block: torch.Tensor, v_block: torch.Tensor,
            owner: Any = None, k_scale: Optional[torch.Tensor] = None,
            v_scale: Optional[torch.Tensor] = None) -> bool:
        """Demote one block's contents ``(G, bs, KVH, hd)`` under ``key``. A
        resident key is only re-heated (equal key means identical KV).
        Returns False when no free or evictable slot exists. Quantized
        stores need the block's ``(G, KVH)`` scales."""
        if key in self._by_key:
            self._touch(key)
            return True
        if self.quantized and (k_scale is None or v_scale is None):
            raise ValueError("quantized HostBlockStore.put needs k/v scales")
        slot = self._take_slot()
        if slot is None:
            return False
        self.k[:, slot] = k_block
        self.v[:, slot] = v_block
        if self.quantized:
            self.k_scale[:, slot] = k_scale
            self.v_scale[:, slot] = v_scale
        self._by_key[key] = slot
        self._key_of[slot] = key
        self._lru[key] = None
        self._producer[key] = owner
        self.puts += 1
        if self.journal is not None:
            self.journal.append((key, owner))
        if self.sanitizer is not None:
            self.sanitizer.host_put(key, slot, owner)
            self.sanitizer.audit_host(self)
        return True

    def _copies(self, slots: List[int]):
        """Fresh copies of ``slots`` (the slab may be reused at once)."""
        idx = torch.as_tensor(slots, dtype=torch.long)
        out = (self.k[:, idx], self.v[:, idx])
        if self.quantized:
            out += (self.k_scale[:, idx], self.v_scale[:, idx])
        return out

    def block(self, key: bytes):
        """Copies of a resident key's block, ``(k, v, k_scale, v_scale)``
        of (G, bs, KVH, hd) and (G, KVH) (scales None for a float store),
        without a hit or a re-heat; None when the key is not resident."""
        slot = self._by_key.get(key)
        if slot is None:
            return None
        out = self._copies([slot])
        return tuple(t[:, 0] for t in out) + ((None, None) if len(out) == 2 else ())

    def read(self, keys: Sequence[bytes], owner: Any = None):
        """Batched promotion read: ``(k, v)`` stacked ``(G, len(keys), bs,
        KVH, hd)`` copies in key order (``(k, v, k_scale, v_scale)`` for a
        quantized store). Records hits and cross-owner hits and re-heats
        every key; every key must be resident."""
        slots = [self._by_key[k] for k in keys]
        if self.sanitizer is not None:
            self.sanitizer.host_read(keys, slots)
        for key in keys:
            self._touch(key)
            self.hits += 1
            producer = self._producer.get(key)
            if owner is not None and producer is not None and producer != owner:
                self.cross_hits += 1
        return self._copies(slots)

    # ------------------------------------------------------------- swap API
    def reserve_seq(self, tag: Any, n: int) -> Optional[List[int]]:
        """Pin ``n`` slots for a preempted sequence under ``tag`` without
        contents (all-or-nothing: None when they cannot all be had). The
        contents follow through ``fill_seq``."""
        if tag in self._swap:
            raise ValueError(f"swap tag {tag!r} already saved")
        if n == 0 or n > len(self.free) + len(self._lru):
            return None
        slots = []
        for _ in range(n):
            s = self._take_slot()
            assert s is not None  # capacity checked above
            slots.append(s)
        self._swap[tag] = slots
        self.swap_outs += 1
        if self.sanitizer is not None:
            self.sanitizer.host_reserve(tag, slots)
            self.sanitizer.audit_host(self)
        return slots

    def fill_seq(self, tag: Any, k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None) -> None:
        """Fill a reserved swap set ``(G, n, bs, KVH, hd)``; a tag dropped
        before the copy drained is ignored (the sanitizer too allows that
        race, and only that one)."""
        if self.sanitizer is not None:
            self.sanitizer.host_fill(tag)
        slots = self._swap.get(tag)
        if slots is None:
            return
        if self.quantized and (k_scales is None or v_scales is None):
            raise ValueError("quantized HostBlockStore.fill_seq needs scales")
        idx = torch.as_tensor(slots, dtype=torch.long)
        self.k[:, idx] = k_blocks
        self.v[:, idx] = v_blocks
        if self.quantized:
            self.k_scale[:, idx] = k_scales
            self.v_scale[:, idx] = v_scales

    def save_seq(self, tag: Any, k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None) -> bool:
        """``reserve_seq`` + ``fill_seq`` in one call; False (store unchanged
        apart from keyed evictions) when the chain cannot be pinned."""
        if self.reserve_seq(tag, int(k_blocks.shape[1])) is None:
            return False
        self.fill_seq(tag, k_blocks, v_blocks, k_scales, v_scales)
        return True

    def saved_blocks(self, tag: Any) -> int:
        return len(self._swap.get(tag, ()))

    def restore_seq(self, tag: Any):
        """Unpin and return a swap set's ``(k, v)`` copies (``(k, v,
        k_scale, v_scale)`` for a quantized store)."""
        if self.sanitizer is not None:
            self.sanitizer.host_restore(tag)
        slots = self._swap.pop(tag)
        out = self._copies(slots)
        self.free.extend(slots)
        self.swap_ins += 1
        return out

    def drop_seq(self, tag: Any) -> None:
        """Abandon a swap set without restoring it."""
        if self.sanitizer is not None and tag in self._swap:
            self.sanitizer.host_drop(tag)
        self.free.extend(self._swap.pop(tag, []))

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        return {
            "n_blocks": self.n_blocks,
            "n_free": len(self.free),
            "n_keyed": self.n_keyed,
            "n_swapped": self.n_swapped,
            "puts": self.puts,
            "hits": self.hits,
            "cross_hits": self.cross_hits,
            "evictions": self.evictions,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "utilization": self.utilization(),
        }
