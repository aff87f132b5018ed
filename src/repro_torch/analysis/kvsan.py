"""KV-block lifecycle sanitizer: shadow state for the three-tier block pools.
A copy of ``repro.analysis.kvsan`` for the port (pure Python, no torch).

The paged serving stack moves KV blocks through three tiers — the device
pool's refcounted allocator (``serving.paged_cache.PagedPool``), the warm
prefix LRU, and the host block store (``serving.host_tier.HostBlockStore``)
— with an async ``CopyEngine`` deferring the device<->host copies between
dispatches. On the card those copies are non-blocking pinned copies that
land when the copy engine drains them, so the order of a fill, a restore
and a block's reuse is a real property of a run; this module checks the
allocator invariants on EVERY operation while a workload runs.

``KVSanitizer`` mirrors each tier in a shadow state machine:

device block:  free -> allocated(refs>=1) -> warm (refcount 0, keyed/shared)
               -> free   (warm eviction demotes contents to host)
host slot:     free -> keyed (demoted/promoted LRU)  |  pinned (swap set)
copy engine:   per-tag pending set (submit -> drained), ordering edges

Every instrumented operation (allocate/share/release, demote/promote,
reserve/fill/restore/drop, submit/drain) first validates against the shadow
and then advances it. A mismatch raises ``KVSanError`` immediately, with the
current operation's backtrace plus the recent operation history of the block
/ slot / tag involved.

Detected violation classes (each mutation-tested through
``python -m repro_torch.analysis kvsan --mutate <id>``):

* ``use-after-free``    — share/touch/write of a block in the free state
* ``double-alloc``      — allocating a block that is not free
* ``double-free``       — releasing a block already free
* ``refcount-underflow``— releasing a block whose shadow refcount is 0
* ``fill-before-reserve``— ``fill_seq`` on a tag never reserved (the store
  itself is silently tolerant; the sanitizer is not)
* ``cross-tier-aliasing``— one host slot simultaneously keyed and pinned,
  or pinned into two swap sets
* ``swap-order``        — ``restore_seq`` while the tag's fill is still
  pending in the copy engine (a missing ``sync(tag)`` happens-before edge)
* ``unknown-key``       — host read/evict of a key the shadow never saw

Hooks are no-ops when no sanitizer is attached; ``sanitize=True`` on
``PagedKVCache`` / ``GenerationEngine`` wires one through the pool, the host
store and the copy engine. Overhead is a few dict operations plus a short
captured backtrace per pool operation — a debug mode, not a serving mode.
"""
from __future__ import annotations

import sys
import traceback
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

__all__ = ["KVSanError", "KVSanitizer"]

# device-block shadow states
FREE = "free"
ALLOCATED = "allocated"
WARM = "warm"

# host-slot shadow states
H_KEYED = "keyed"
H_PINNED = "pinned"


class KVSanError(AssertionError):
    """A KV lifecycle contract violation, with operation backtraces.

    ``code`` is the violation class (stable identifiers, listed in the
    module docstring); ``history`` holds the recent shadow operations that
    touched the offending block/slot/tag, oldest first.
    """

    def __init__(self, code: str, message: str, history: List[str]):
        self.code = code
        self.history = history
        trail = "\n".join(f"    {h}" for h in history) or "    (no prior ops)"
        super().__init__(
            f"[kvsan:{code}] {message}\n  recent operations:\n{trail}"
        )


def _site(skip: int = 3, limit: int = 14) -> str:
    """Compact call-site tag for the op log: the innermost non-sanitizer
    frame, as ``file.py:line in func``."""
    for frame in reversed(traceback.extract_stack(limit=limit)[:-skip]):
        if "analysis/kvsan" not in frame.filename.replace("\\", "/"):
            name = frame.filename.rsplit("/", 1)[-1]
            return f"{name}:{frame.lineno} in {frame.name}"
    return "?"


class KVSanitizer:
    """Shadow state machine for device blocks, host slots and copy tags.

    One sanitizer instance covers one pool namespace: a lone engine, or an
    entire DP group (replicas allocate from disjoint ranges of one shared
    array, so a shared sanitizer additionally catches cross-replica
    double-ownership). Attach via ``PagedKVCache(sanitize=True)`` or share
    explicitly with ``PagedKVCache(sanitizer=...)``.
    """

    def __init__(self, log_len: int = 64):
        # device tier
        self._state: Dict[int, str] = {}        # block -> FREE/ALLOCATED/WARM
        self._refs: Dict[int, int] = {}         # block -> shadow refcount
        self._keys: Dict[int, bytes] = {}       # block -> published prefix key
        # host tier
        self._hslot: Dict[int, Tuple[str, Any]] = {}  # slot -> (state, key|tag)
        self._htags: Dict[Any, List[int]] = {}        # swap tag -> slots
        self._dropped_tags: Set[Any] = set()          # fills may land post-drop
        # copy engine
        self._pending: Dict[Any, int] = {}            # tag -> in-flight count
        # bounded per-entity op history for error reports
        self._log: Dict[Any, Deque[str]] = {}
        self._log_len = log_len
        self.ops = 0          # total ops checked (stats/CLI)
        self.op_counts: Dict[str, int] = {}   # hook name -> times invoked
        self.violations = 0   # raised violations (always fatal; count anyway)

    # ------------------------------------------------------------- plumbing
    def _rec(self, entity: Any, what: str) -> None:
        log = self._log.get(entity)
        if log is None:
            log = self._log[entity] = deque(maxlen=self._log_len)
        log.append(f"{what}  @ {_site()}")
        self.ops += 1
        hook = sys._getframe(1).f_code.co_name  # public hook that recorded
        self.op_counts[hook] = self.op_counts.get(hook, 0) + 1

    def _fail(self, code: str, entity: Any, message: str) -> None:
        self.violations += 1
        raise KVSanError(code, message, list(self._log.get(entity, ())))

    def _dstate(self, block: int) -> str:
        return self._state.get(block, FREE)

    # ---------------------------------------------------------- device tier
    def device_alloc(self, block: int, seq: Any) -> None:
        st = self._dstate(block)
        if st != FREE:
            self._fail(
                "double-alloc", ("blk", block),
                f"block {block} allocated for seq {seq} while {st} "
                f"(refs={self._refs.get(block, 0)})",
            )
        self._state[block] = ALLOCATED
        self._refs[block] = 1
        self._rec(("blk", block), f"alloc block={block} seq={seq}")

    def device_share(self, block: int, seq: Any) -> None:
        st = self._dstate(block)
        if st == FREE:
            self._fail(
                "use-after-free", ("blk", block),
                f"block {block} shared into seq {seq} but it is free",
            )
        self._state[block] = ALLOCATED
        self._refs[block] = self._refs.get(block, 0) + 1
        self._rec(("blk", block),
                  f"share block={block} seq={seq} refs={self._refs[block]}")

    def device_release(self, block: int, seq: Any) -> None:
        st = self._dstate(block)
        if st == FREE:
            self._fail(
                "double-free", ("blk", block),
                f"block {block} released from seq {seq} but it is already free",
            )
        if st == WARM or self._refs.get(block, 0) <= 0:
            self._fail(
                "refcount-underflow", ("blk", block),
                f"block {block} released from seq {seq} with shadow "
                f"refcount {self._refs.get(block, 0)} (state {st})",
            )
        self._refs[block] -= 1
        self._rec(("blk", block),
                  f"release block={block} seq={seq} refs={self._refs[block]}")

    def device_warm(self, block: int) -> None:
        """refcount hit 0 and the warm-LRU kept the block (still keyed)."""
        self._state[block] = WARM
        self._refs.pop(block, None)
        self._rec(("blk", block), f"warm block={block}")

    def device_free(self, block: int) -> None:
        """refcount hit 0 and the block went straight to the free list."""
        self._state[block] = FREE
        self._refs.pop(block, None)
        self._keys.pop(block, None)
        self._rec(("blk", block), f"free block={block}")

    def device_warm_evict(self, block: int) -> None:
        """The warm LRU reclaimed a refcount-0 block for reallocation."""
        st = self._dstate(block)
        if st != WARM:
            self._fail(
                "use-after-free", ("blk", block),
                f"warm-LRU eviction of block {block} in state {st}",
            )
        self._state[block] = FREE
        self._keys.pop(block, None)
        self._rec(("blk", block), f"warm-evict block={block}")

    def device_touch(self, block: int) -> None:
        if self._dstate(block) == FREE:
            self._fail(
                "use-after-free", ("blk", block),
                f"LRU touch of free block {block}",
            )
        self._rec(("blk", block), f"touch block={block}")

    def device_key(self, block: int, key: bytes) -> None:
        """A prefix key was published to point at ``block``."""
        if self._dstate(block) == FREE:
            self._fail(
                "use-after-free", ("blk", block),
                f"prefix key published for free block {block}",
            )
        self._keys[block] = key
        self._rec(("blk", block), f"key block={block} key={key.hex()[:12]}")

    # ------------------------------------------------------------ host tier
    def host_put(self, key: bytes, slot: int, owner: Any = None) -> None:
        st = self._hslot.get(slot)
        if st is not None:
            self._fail(
                "cross-tier-aliasing", ("slot", slot),
                f"host put of key {key.hex()[:12]} into slot {slot} "
                f"already {st[0]} ({st[1]!r})",
            )
        self._hslot[slot] = (H_KEYED, key)
        self._rec(("slot", slot),
                  f"host-put slot={slot} key={key.hex()[:12]} owner={owner!r}")

    def host_evict(self, key: bytes, slot: int) -> None:
        st = self._hslot.get(slot)
        if st is None or st[0] != H_KEYED:
            self._fail(
                "unknown-key", ("slot", slot),
                f"host evict of slot {slot} (key {key.hex()[:12]}) "
                f"in state {st!r}",
            )
        del self._hslot[slot]
        self._rec(("slot", slot), f"host-evict slot={slot}")

    def host_read(self, keys, slots) -> None:
        for key, slot in zip(keys, slots):
            st = self._hslot.get(slot)
            if st is None or st[0] != H_KEYED or st[1] != key:
                self._fail(
                    "unknown-key", ("slot", slot),
                    f"host read of key {key.hex()[:12]} via slot {slot} "
                    f"in state {st!r}",
                )
            self._rec(("slot", slot), f"host-read slot={slot}")

    def host_reserve(self, tag: Any, slots: List[int]) -> None:
        if tag in self._htags:
            self._fail(
                "cross-tier-aliasing", ("tag", tag),
                f"swap tag {tag!r} reserved twice",
            )
        for slot in slots:
            st = self._hslot.get(slot)
            if st is not None:
                self._fail(
                    "cross-tier-aliasing", ("slot", slot),
                    f"swap reserve of tag {tag!r} pinned slot {slot} "
                    f"already {st[0]} ({st[1]!r})",
                )
            self._hslot[slot] = (H_PINNED, tag)
            self._rec(("slot", slot), f"host-reserve slot={slot} tag={tag!r}")
        self._htags[tag] = list(slots)
        self._dropped_tags.discard(tag)
        self._rec(("tag", tag), f"reserve tag={tag!r} n={len(slots)}")

    def host_fill(self, tag: Any) -> None:
        if tag in self._htags:
            self._rec(("tag", tag), f"fill tag={tag!r}")
            return
        if tag in self._dropped_tags:
            # legal race: the owner dropped the swap set before the deferred
            # copy drained; the store discards the payload
            self._rec(("tag", tag), f"fill-after-drop tag={tag!r}")
            return
        self._fail(
            "fill-before-reserve", ("tag", tag),
            f"fill_seq for tag {tag!r} which was never reserved",
        )

    def host_restore(self, tag: Any) -> None:
        if tag not in self._htags:
            self._fail(
                "unknown-key", ("tag", tag),
                f"restore_seq for unknown swap tag {tag!r}",
            )
        if self._pending.get(tag, 0) > 0:
            self._fail(
                "swap-order", ("tag", tag),
                f"restore_seq for tag {tag!r} while its fill is still "
                f"pending in the copy engine (missing sync(tag))",
            )
        for slot in self._htags.pop(tag):
            self._hslot.pop(slot, None)
            self._rec(("slot", slot), f"host-unpin slot={slot} tag={tag!r}")
        self._rec(("tag", tag), f"restore tag={tag!r}")

    def host_drop(self, tag: Any) -> None:
        for slot in self._htags.pop(tag, []):
            self._hslot.pop(slot, None)
            self._rec(("slot", slot), f"host-unpin slot={slot} tag={tag!r}")
        self._dropped_tags.add(tag)
        self._rec(("tag", tag), f"drop tag={tag!r}"
                  )

    # ----------------------------------------------------------- copy engine
    def copy_submit(self, tag: Any) -> None:
        if tag is None:
            return
        self._pending[tag] = self._pending.get(tag, 0) + 1
        self._rec(("tag", tag), f"copy-submit tag={tag!r}")

    def copy_drained(self, tag: Any) -> None:
        if tag is None:
            return
        n = self._pending.get(tag, 0) - 1
        if n <= 0:
            self._pending.pop(tag, None)
        else:
            self._pending[tag] = n
        self._rec(("tag", tag), f"copy-drained tag={tag!r}")

    # ----------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        states = list(self._state.values())
        return {
            "ops": self.ops,
            "violations": self.violations,
            "device_allocated": states.count(ALLOCATED),
            "device_warm": states.count(WARM),
            "host_keyed": sum(1 for s, _ in self._hslot.values() if s == H_KEYED),
            "host_pinned": sum(1 for s, _ in self._hslot.values() if s == H_PINNED),
            "copy_pending": sum(self._pending.values()),
        }

    # --------------------------------------------------- cross-checks (audit)
    def audit_host(self, store) -> None:
        """Cross-validate the shadow against a live ``HostBlockStore`` (the
        port's, whose slabs are torch CPU tensors; only its slot maps are
        read): no slot may appear in both the keyed index and a swap set
        (cross-tier aliasing), nor in two swap sets. Cheap; the store hooks
        call it after each mutating operation."""
        keyed = set(store._key_of)
        pinned = {s for slots in store._swap.values() for s in slots}
        overlap = keyed & pinned
        if overlap:
            slot = next(iter(overlap))
            self._fail(
                "cross-tier-aliasing", ("slot", slot),
                f"host slot(s) {sorted(overlap)} are keyed AND pinned in a "
                f"swap set",
            )
        dup: Dict[int, int] = {}
        for slots in store._swap.values():
            for s in slots:
                dup[s] = dup.get(s, 0) + 1
        doubly = [s for s, n in dup.items() if n > 1]
        if doubly:
            self._fail(
                "cross-tier-aliasing", ("slot", doubly[0]),
                f"host slot(s) {doubly} pinned by more than one swap set",
            )
