"""CLI of the port's analysis tools.

::

    python -m repro_torch.analysis kvsan                  # clean lifecycle under the shadow
    python -m repro_torch.analysis kvsan --mutate <id>    # one seeded defect
    python -m repro_torch.analysis --list-mutations

Exit status is nonzero iff a violation was found. ``--mutate <id>`` seeds
one known lifecycle defect on the port's ``PagedPool``, ``HostBlockStore``
and ``CopyEngine`` before running: the command must then exit nonzero (the
sanitizer detecting the mutation). Everything runs on the host; no device
is touched."""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import torch


def _mk_pool(sanitizer, n_blocks=8, warm=False):
    from repro_torch.serving.paged_cache import PagedPool

    return PagedPool(n_blocks=n_blocks, block_size=4, sanitizer=sanitizer,
                     keep_on_release=(lambda b: True) if warm else None)


def _mk_store(sanitizer, n_blocks=8):
    from repro_torch.serving.host_tier import HostBlockStore

    store = HostBlockStore((1, 4, 1, 2), torch.float32, n_blocks=n_blocks)
    store.sanitizer = sanitizer
    return store


def _blockish(n=1):
    return torch.zeros((1, n, 4, 1, 2), dtype=torch.float32)


def _kv_use_after_free(san) -> None:
    pool = _mk_pool(san)
    blocks = pool.allocate(1, 8)
    pool.free(1)                      # blocks return to the free list
    pool.share(2, blocks[0])          # sharing a freed block


def _kv_double_free(san) -> None:
    pool = _mk_pool(san)
    blocks = pool.allocate(1, 4)
    pool.free(1)
    pool.tables[1] = [blocks[0]]      # stale table resurrects the chain
    pool.free(1)                      # second release of the same block


def _kv_refcount_underflow(san) -> None:
    pool = _mk_pool(san, warm=True)
    blocks = pool.allocate(1, 4)
    pool.free(1)                      # block parks WARM (prefix cache)
    pool.tables[1] = [blocks[0]]
    pool.free(1)                      # releasing a WARM block: refs go < 0


def _kv_fill_before_reserve(san) -> None:
    store = _mk_store(san)
    store.fill_seq(("eng", 7), _blockish(), _blockish())  # never reserved


def _kv_cross_tier_aliasing(san) -> None:
    store = _mk_store(san)
    store.put(b"prefix-key", _blockish()[:, 0], _blockish()[:, 0])
    keyed_slot = store._by_key[b"prefix-key"]
    store._take_slot = lambda: keyed_slot   # allocator bug: hands out a keyed slot
    store.reserve_seq(("eng", 1), 1)


def _kv_swap_order(san) -> None:
    from repro_torch.serving.control_plane import CopyEngine

    store = _mk_store(san)
    ce = CopyEngine()
    ce.sanitizer = san
    tag = ("eng", 1)
    store.reserve_seq(tag, 1)
    ce.submit(lambda: store.fill_seq(tag, _blockish(), _blockish()), tag=tag)
    store.restore_seq(tag)            # read ahead of the deferred fill


KVSAN_MUTANTS: Dict[str, Callable] = {
    "kvsan-use-after-free": _kv_use_after_free,
    "kvsan-double-free": _kv_double_free,
    "kvsan-refcount-underflow": _kv_refcount_underflow,
    "kvsan-fill-before-reserve": _kv_fill_before_reserve,
    "kvsan-cross-tier-aliasing": _kv_cross_tier_aliasing,
    "kvsan-swap-order": _kv_swap_order,
}


def cmd_kvsan(args) -> int:
    from repro_torch.analysis.kvsan import KVSanError, KVSanitizer
    from repro_torch.serving.control_plane import CopyEngine

    san = KVSanitizer()
    if args.mutate:
        try:
            KVSAN_MUTANTS[args.mutate](san)
        except KVSanError as e:
            print(e)
            print(f"kvsan: mutation {args.mutate!r} detected")
            return 1
        print(f"kvsan: mutation {args.mutate!r} NOT detected")
        return 0

    # clean lifecycle: device alloc/share/free, warm cache, host demote/
    # promote, reserve/fill via the copy engine, restore — zero violations
    pool = _mk_pool(san, warm=True)
    store = _mk_store(san)
    ce = CopyEngine()
    ce.sanitizer = san
    blocks = pool.allocate(1, 16)
    pool.share(2, blocks[0])
    pool.free(1)
    pool.free(2)
    store.put(b"k0", _blockish()[:, 0], _blockish()[:, 0], owner="e0")
    store.read([b"k0"], owner="e1")
    tag = ("e0", 42)
    store.reserve_seq(tag, 2)
    ce.submit(lambda: store.fill_seq(tag, _blockish(2), _blockish(2)), tag=tag)
    ce.sync(tag)
    store.restore_seq(tag)
    san.audit_host(store)
    stats = san.stats()
    print(f"kvsan: {stats['ops']} ops checked, "
          f"{stats['violations']} violation(s)")
    return 1 if stats["violations"] else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's analysis tools: the KV lifecycle sanitizer")
    ap.add_argument("command", nargs="?", default="kvsan", choices=["kvsan"])
    ap.add_argument("--mutate", default=None, metavar="ID", choices=sorted(KVSAN_MUTANTS),
                    help="seed a registered defect; the run must exit nonzero")
    ap.add_argument("--list-mutations", action="store_true")
    args = ap.parse_args(argv)
    if args.list_mutations:
        for mid in sorted(KVSAN_MUTANTS):
            print(f"{mid}  (kvsan)")
        return 0
    return cmd_kvsan(args)


if __name__ == "__main__":
    sys.exit(main())
