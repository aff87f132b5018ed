"""CLI of the port's analysis tools.

::

    python -m repro_torch.analysis lint                 # repo-specific AST lint
    python -m repro_torch.analysis kvsan                # clean lifecycle under the shadow
    python -m repro_torch.analysis audit [--int8]       # step-program contract audit (cuda)
    python -m repro_torch.analysis audit --device cpu   # ... on the plain versions
    python -m repro_torch.analysis all [--device cpu]   # lint + kvsan + audit
    python -m repro_torch.analysis --list-mutations

Exit status is nonzero iff a violation was found. ``--mutate <id>`` seeds
one known defect before running — an in-memory broken source tree (lint),
a scripted lifecycle bug on the port's ``PagedPool``, ``HostBlockStore``
and ``CopyEngine`` (kvsan), a patched or misused step program (audit) — and
the command must then exit nonzero (the analyzer detecting the mutation).
``lint`` and ``kvsan`` touch no device; ``audit`` builds a smoke-width
engine of ``--arch`` on ``--device`` (default ``cuda``). The JAX package's
``types`` command (mypy) has no counterpart here."""
from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Callable, Dict

import torch


def _fail(msg: str) -> int:
    print(msg)
    return 1


# --------------------------------------------------------------------- lint
def _lint_mutants() -> Dict[str, Dict[str, str]]:
    """Each lint mutation is an in-memory source tree that violates exactly
    one rule (the file paths select which rules apply)."""
    return {
        "lint-layering": {
            "core/scheduler.py": "import torch\n\ndef plan():\n    return []\n",
        },
        "lint-pad": {
            "serving/batcher.py": (
                "def assemble(pool, ids, width):\n"
                "    rows = pool.table_array(ids, width)\n"
                "    return rows.sum()\n"
            ),
        },
        "lint-determinism": {
            "serving/control_plane.py": (
                "import time\n\n"
                "def build_plan(state):\n"
                "    return (state, time.time())\n"
            ),
        },
        "lint-prng": {
            "serving/device_runner.py": (
                "from repro_torch.serving.sampler import sample_tokens\n\n"
                "def dispatch(eng, logits, temps):\n"
                "    toks = sample_tokens(eng._generator, logits, temps)\n"
                "    again = sample_tokens(eng._generator, logits, temps)\n"
                "    return toks, again\n"
            ),
        },
    }


def cmd_lint(args) -> int:
    from repro_torch.analysis.lint import run_lint

    sources = _lint_mutants()[args.mutate] if args.mutate else None
    violations = run_lint(sources=sources)
    for v in violations:
        print(v)
    print(f"lint: {len(violations)} violation(s)")
    return 1 if violations else 0


# -------------------------------------------------------------------- kvsan
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


# -------------------------------------------------------------------- audit
def _smoke_engine(arch: str, device: str, **kw):
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.serving.engine import GenerationEngine

    return GenerationEngine(smoke_variant(get_arch(arch)), max_batch=2, max_seq=64,
                            prefill_chunk_size=16, token_budget=20, device=device, **kw)


def patch_pool_program(eng, wrap) -> None:
    """Replace the engine's pool-roundtrip program by ``wrap(program)``
    (mutation helper: the wrapper injects the defect)."""
    orig = eng.step_program

    def patched(which):
        fn, pargs = orig(which)
        return (wrap(fn), pargs) if which == "pool" else (fn, pargs)

    eng.step_program = patched


@contextlib.contextmanager
def one_rank_gloo():
    """A world-size-1 gloo process group for the collective mutation
    (an in-process store: no address, no port). Destroyed on exit."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _au_collective(eng) -> None:
    import torch.distributed as dist

    def wrap(fn):
        def bad(k_pool, *rest):
            out, view = fn(k_pool, *rest)
            # an all-reduce sneaks into the pool roundtrip
            dist.all_reduce(torch.zeros(()))
            return out, view
        return bad

    patch_pool_program(eng, wrap)


def _au_host_sync(eng) -> None:
    def wrap(fn):
        def bad(k_pool, *rest):
            out, view = fn(k_pool, *rest)
            # a host round-trip inside the step program
            view.float().sum().item()
            return out, view
        return bad

    patch_pool_program(eng, wrap)


AUDIT_ENGINE_MUTANTS: Dict[str, Callable] = {
    "audit-collective": _au_collective,
    "audit-host-sync": _au_host_sync,
}


def off_bucket_call(eng) -> int:
    """Run the ragged step at one packed length past the warmed ones (the
    ``audit-cache-buckets`` mutation); returns that length."""
    fn, a = eng.step_program("fused_ragged")
    T = max(eng._warm_lengths) + eng.pack_align
    flat = torch.zeros((T,), dtype=torch.int32, device=eng.device)
    with torch.no_grad():
        fn(a[0], flat, flat, flat, flat, flat, flat, a[7])
    return T


def cmd_audit(args) -> int:
    from repro_torch.analysis.step_audit import StepContract, audit_engine, default_contracts

    device = args.device or "cuda"
    if args.mutate == "audit-int8-upcast":
        # the gather-oracle decode dequantizes outside the kernel: holding it
        # to the in-kernel contract is the seeded violation
        eng = _smoke_engine(args.arch, device, kv_dtype="int8", kernel="pallas")
        report = audit_engine(eng, contracts=[StepContract(
            "decode_ref", max_all_reduce=0, require_int8_kernel_path=True)])
    elif args.mutate == "audit-cache-buckets":
        eng = _smoke_engine(args.arch, device)
        eng.warmup_step_variants()
        off_bucket_call(eng)
        report = audit_engine(eng, contracts=[])
    elif args.mutate in AUDIT_ENGINE_MUTANTS:
        eng = _smoke_engine(args.arch, device)
        AUDIT_ENGINE_MUTANTS[args.mutate](eng)
        contracts = [c for c in default_contracts(eng) if c.program == "pool"]
        ctx = one_rank_gloo() if args.mutate == "audit-collective" else contextlib.nullcontext()
        with ctx:
            report = audit_engine(eng, contracts=contracts)
    elif args.mutate:
        return _fail(f"unknown audit mutation {args.mutate!r}")
    else:
        kw = {"kv_dtype": "int8", "kernel": "pallas"} if args.int8 else {}
        eng = _smoke_engine(args.arch, device, **kw)
        report = audit_engine(eng)
    print(report.render())
    return 0 if report.ok else 1


# ---------------------------------------------------------------------- all
def cmd_all(args) -> int:
    rc = 0
    for sub in (cmd_lint, cmd_kvsan, cmd_audit):
        rc |= sub(args)
    return rc


def all_mutations() -> Dict[str, str]:
    """mutation id -> subcommand that hosts it (the test matrix)."""
    out = {m: "lint" for m in _lint_mutants()}
    out.update({m: "kvsan" for m in KVSAN_MUTANTS})
    out.update({m: "audit" for m in AUDIT_ENGINE_MUTANTS})
    out.update({"audit-int8-upcast": "audit", "audit-cache-buckets": "audit"})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's analysis tools: lint, kv sanitizer, step-program audit")
    ap.add_argument("command", nargs="?", default="all",
                    choices=["lint", "kvsan", "audit", "all"])
    ap.add_argument("--mutate", default=None, metavar="ID",
                    help="seed a registered defect; the run must exit nonzero")
    ap.add_argument("--list-mutations", action="store_true")
    ap.add_argument("--arch", default="smollm-135m",
                    help="architecture of the audit's smoke engine")
    ap.add_argument("--int8", action="store_true",
                    help="audit the int8-pool engine with the paged kernels")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the audit's engine runs (default cuda)")
    args = ap.parse_args(argv)
    if args.list_mutations:
        for mid, sub in sorted(all_mutations().items()):
            print(f"{mid}  ({sub})")
        return 0
    if args.mutate and all_mutations().get(args.mutate) != args.command:
        return _fail(f"mutation {args.mutate!r} belongs to "
                     f"{all_mutations().get(args.mutate)!r}, not {args.command!r}")
    return {"lint": cmd_lint, "kvsan": cmd_kvsan, "audit": cmd_audit,
            "all": cmd_all}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
