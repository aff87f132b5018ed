"""The port's KV lifecycle sanitizer (``repro_torch.analysis.kvsan``) on the
CPU, against the JAX package's.

* The six seeded defects of ``python -m repro_torch.analysis kvsan
  --mutate <id>`` each raise their violation code (with the operation
  trail), and the CLI exits 1 for each and 0 for the clean lifecycle.
* The pool's default refcount hides a double free that the sanitizer
  catches; a fill that lands after its swap set was dropped stays legal.
* The invariant harness's bursty workload (``tests/test_engine_invariants
  .py::test_invariants_under_kv_sanitizer``: recompute on a full pool;
  swap, cost and int8 + swap on a 6-block pool) under ``sanitize=True``:
  no violation, the shadow agrees with the pool and the host store at the
  drain, and the sanitizer counts the same operations, hook for hook, as
  the JAX engine's sanitizer on the same workload and weights.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.kvsan import KVSanitizer as JaxSanitizer
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_params as jax_init_params
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.analysis import KVSanError, KVSanitizer
from repro_torch.analysis.__main__ import KVSAN_MUTANTS, main
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.host_tier import HostBlockStore
from repro_torch.serving.paged_cache import PagedKVCache, PagedPool
from torch_harness import bursty_workload

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

CODES = {
    "kvsan-use-after-free": "use-after-free",
    "kvsan-double-free": "double-free",
    "kvsan-refcount-underflow": "refcount-underflow",
    "kvsan-fill-before-reserve": "fill-before-reserve",
    "kvsan-cross-tier-aliasing": "cross-tier-aliasing",
    "kvsan-swap-order": "swap-order",
}


def test_the_mutant_registry_is_the_references():
    assert sorted(KVSAN_MUTANTS) == sorted(CODES)


@pytest.mark.parametrize("mid", sorted(CODES))
def test_kvsan_mutations_raise_their_code(mid, capsys):
    san = KVSanitizer()
    with pytest.raises(KVSanError) as ei:
        KVSAN_MUTANTS[mid](san)
    assert ei.value.code == CODES[mid]
    assert san.violations == 1
    assert "recent operations" in str(ei.value)
    assert main(["kvsan", "--mutate", mid]) == 1
    assert f"mutation {mid!r} detected" in capsys.readouterr().out


def test_cli_exit_codes():
    assert main(["kvsan"]) == 0
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for argv, rc in ((["kvsan"], 0), (["kvsan", "--mutate", "kvsan-swap-order"], 1)):
        out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", *argv],
                             capture_output=True, text=True, env=env, timeout=120)
        assert out.returncode == rc, out.stdout + out.stderr
    assert "0 violation(s)" in subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "kvsan"], capture_output=True,
        text=True, env=env, timeout=120).stdout


def test_kvsan_catches_free_masked_by_default_refcount():
    """``PagedPool.free`` counts a missing refcount as 1, as the JAX pool
    does, so a stale table's second release passes the pool; the shadow
    catches it."""
    san = KVSanitizer()
    pool = PagedPool(n_blocks=4, block_size=4, sanitizer=san)
    blocks = pool.allocate(1, 4)
    pool.free(1)
    assert blocks[0] not in pool.refcounts
    pool.tables[1] = [blocks[0]]
    with pytest.raises(KVSanError) as ei:
        pool.free(1)
    assert ei.value.code == "double-free"
    bare = PagedPool(n_blocks=4, block_size=4)           # no sanitizer: no raise
    blocks = bare.allocate(1, 4)
    bare.free(1)
    bare.tables[1] = [blocks[0]]
    bare.free(1)


def test_kvsan_fill_after_drop_is_legal():
    san = KVSanitizer()
    store = HostBlockStore((1, 4, 1, 2), torch.float32, n_blocks=4)
    store.sanitizer = san
    tag = ("e", 1)
    store.reserve_seq(tag, 1)
    store.drop_seq(tag)
    store.fill_seq(tag, torch.zeros((1, 1, 4, 1, 2)), torch.zeros((1, 1, 4, 1, 2)))
    assert san.violations == 0
    assert san.op_counts["host_fill"] == 1 and san.stats()["host_pinned"] == 0


def test_paged_kv_cache_sanitizer_wiring():
    cfg = smoke_variant(get_arch("smollm-135m"))
    store = HostBlockStore.for_config(cfg, 8, 16)
    kv = PagedKVCache(cfg, 16, 16, 8, device="cpu", host_store=store, sanitize=True)
    assert kv.sanitizer is not None and kv.pool.sanitizer is kv.sanitizer
    assert store.sanitizer is kv.sanitizer
    shared = KVSanitizer()
    other = PagedKVCache(cfg, 16, 16, 8, device="cpu", sanitizer=shared)
    assert other.sanitizer is shared and other.pool.sanitizer is shared
    assert PagedKVCache(cfg, 16, 16, 8, device="cpu").sanitizer is None
    # the legacy per-sequence API under the shadow
    assert kv.admit(7, 20)
    k = torch.randn(cfg.num_layers, 20, cfg.num_kv_heads, cfg.head_dim)
    kv.write_prefill(7, k, -k)
    kv.write_token(7, k[:, 0], k[:, 1])
    kview, vview, valid = kv.sequence_view(7)
    assert int(valid.sum()) == 21
    torch.testing.assert_close(kview[:, :20], k, rtol=0, atol=0)
    torch.testing.assert_close(vview[:, 20], k[:, 1], rtol=0, atol=0)
    kv.release(7)
    assert kv.sanitizer.violations == 0 and kv.sanitizer.stats()["device_allocated"] == 0


# -------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def weights():
    cfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return cfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


def _pin_token_time(eng, value):
    """Hold the runner's per-token step time (the cost model's input, a
    wall-clock quantity otherwise) at ``value`` through the run."""
    runner = eng.runner
    orig = runner.materialize

    def materialize(ex):
        out = orig(ex)
        runner.token_time_ema = value
        return out

    runner.materialize = materialize
    runner.token_time_ema = value


# (seed, n_blocks, preempt, pipeline, kv_dtype), as the JAX harness's test;
# both engines run kernel="pallas" (the JAX one in interpret mode), the cost
# case with the per-token step time pinned on both sides to 1e-5 s, a CPU
# step's order, at which every victim of seed 6 swaps (at 6e-7 every one
# recomputes and the host tier would see no swap set)
PINNED_TOKEN_S = 1e-5
CASES = [
    (0, None, "recompute", True, None),
    (5, 6, "swap", True, None),
    (6, 6, "cost", False, None),
    (5, 6, "swap", True, "int8"),
]


@pytest.fixture(scope="module")
def runs(weights):
    jcfg, jparams, tcfg, tparams = weights
    out = {}
    for case in CASES:
        seed, nb, preempt, pipeline, kv_dtype = case
        kw = dict(max_batch=3, max_seq=96, n_blocks=nb, prefill_chunk_size=16,
                  token_budget=20, scheduler="fifo", preempt=preempt, pipeline=pipeline,
                  kv_dtype=kv_dtype, sanitize=True, kernel="pallas")
        sides = []
        for eng in (JaxEngine(jcfg, params=jparams, **kw),
                    GenerationEngine(tcfg, params=tparams, device="cpu", **kw)):
            if preempt == "cost":
                _pin_token_time(eng, PINNED_TOKEN_S)
            sides.append((eng, bursty_workload(eng, seed, nb is not None)))
        out[case] = sides
    return out


@pytest.mark.parametrize("case", CASES)
def test_invariants_under_kv_sanitizer(runs, case):
    _, (eng, reqs) = runs[case]
    san = eng.sanitizer
    assert isinstance(san, KVSanitizer) and san.violations == 0
    assert eng.kv.pool.sanitizer is san and eng._copy.sanitizer is san
    assert san.op_counts.get("device_alloc", 0) > 0
    if case[1] is not None:
        assert eng.preemptions >= 1
        assert eng.host_store.sanitizer is san
        for hook in ("host_reserve", "host_restore", "copy_submit"):
            assert san.op_counts.get(hook, 0) > 0, hook
    assert all(r.done and len(r.out_tokens) == r.max_new for r in reqs)
    shadow = san.stats()
    pool = eng.kv.pool
    assert shadow["device_allocated"] == 1   # the scratch block only
    assert shadow["device_warm"] == len(pool.cached)
    assert shadow["copy_pending"] == 0
    if eng.host_store is not None:
        san.audit_host(eng.host_store)
        assert shadow["host_pinned"] == 0 and shadow["host_keyed"] == eng.host_store.n_keyed


@pytest.mark.parametrize("case", CASES)
def test_sanitizer_counts_match_jax(runs, case):
    (jeng, jreqs), (teng, treqs) = runs[case]
    assert isinstance(jeng.sanitizer, JaxSanitizer)
    for a, b in zip(jreqs, treqs):
        assert b.out_tokens == a.out_tokens, (a.req_id, a.out_tokens, b.out_tokens)
    assert teng.sanitizer.op_counts == jeng.sanitizer.op_counts
    assert teng.sanitizer.stats() == jeng.sanitizer.stats()
    for key in ("preemptions", "swap_outs", "cost_swap_choices", "cost_recompute_choices"):
        assert teng.stats()[key] == jeng.stats()[key], key
    if case[2] == "cost":
        assert teng.stats()["cost_swap_choices"] > 0


def test_sanitized_oracle_paths_drain_clean(weights):
    """The sequential and padded paths under the shadow, with swap."""
    tcfg, tparams = weights[2], weights[3]
    for kw in (dict(interleave=False), dict(ragged=False, kernel="reference")):
        eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=3, max_seq=96,
                               n_blocks=6, prefill_chunk_size=16, token_budget=20,
                               preempt="swap", sanitize=True, **kw)
        reqs = bursty_workload(eng, 5, True)
        san = eng.sanitizer
        assert all(r.done for r in reqs) and eng.preemptions >= 1
        assert san.violations == 0 and san.op_counts.get("host_restore", 0) > 0
        assert san.stats()["device_allocated"] == 1 and san.stats()["copy_pending"] == 0
