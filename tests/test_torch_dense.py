"""The port's dense backend against the JAX package on the CPU, at smoke
width in float32, on the same numpy inputs and weights.

- The plain versions of the two dense kernels (``ref_flash_attention``,
  ``ref_decode_attention``) against the Pallas kernels in interpret mode
  (``repro.kernels.ops``) and the jnp oracles (``repro.kernels.ref``), at
  ``TOL`` of tests/test_kernel_conformance.py.
- ``cache_validity`` of a full-attention cache and of an SWA ring against
  JAX's, and both masks against the ``slot < min(pos + 1, Sc)`` lengths the
  port's decode passes to its kernel; ``blockwise_attention`` with
  ``attn_type=ATTN_SWA`` against JAX's.
- ``forward(want_cache=True)``, ``prefill``, ``init_cache`` and
  ``decode_step`` against JAX's: logits at 1e-4 (two float32 stacks in
  different summation orders), caches at 1e-5.
- The dense engine's greedy tokens against the JAX dense engine's and the
  port's paged engine's, on the workloads of tests/test_paged_engine.py
  (three batched prompts; prompt lengths around block and bucket edges; a
  truncated prompt) and on an engine whose ``max_seq`` of 100 makes a
  bucket that is not a power of two.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.kernels import ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import ATTN_CHUNKED_LOCAL, ATTN_FULL, ATTN_SWA
from repro_torch.kernels.decode_attention import ref_decode_attention
from repro_torch.kernels.flash_attention import ref_flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)          # tests/test_kernel_conformance.py
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KVH,hd,block", [
    (1, 37, 4, 2, 64, 256),     # S not a power of two: one 37-row Pallas block
    (2, 64, 8, 2, 32, 16),      # four Pallas blocks each way: the causal block skip
])
def test_plain_flash_matches_pallas_and_ref(B, S, H, KVH, hd, block, causal):
    rng = np.random.default_rng(S * hd + causal)
    q, k, v = (_normal(rng, (B, S, n, hd)) for n in (H, KVH, KVH))
    got = ref_flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    pallas = ops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 block_q=block, block_k=block)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    want = jax_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("B,Sc,H,KVH,hd,lengths,block", [
    (3, 40, 4, 2, 64, [1, 17, 40], 512),     # a length-1 row and a full one
    (2, 96, 8, 1, 32, [96, 5], 16),          # six Pallas blocks, MQA
])
def test_plain_decode_matches_pallas_and_ref(B, Sc, H, KVH, hd, lengths, block):
    rng = np.random.default_rng(Sc + hd)
    q = _normal(rng, (B, H, hd))
    k, v = _normal(rng, (B, Sc, KVH, hd)), _normal(rng, (B, Sc, KVH, hd))
    lens = np.asarray(lengths, np.int32)
    got = ref_decode_attention(*map(torch.from_numpy, (q, k, v, lens))).numpy()
    pallas = ops.decode_attention(*map(jnp.asarray, (q, k, v, lens)), block_k=block)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    want = jax_ref.decode_attention_ref(*map(jnp.asarray, (q, k, v, lens)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# a full-attention cache and an SWA ring; Sc = 1 and pos far past Sc exercise
# the clamp. The decode stacks mask either by the kernel's lengths alone:
# each case holds those lengths against JAX's mask too
@pytest.mark.parametrize("attn_type,Sc,pos", [
    (ATTN_FULL, 24, [0, 5, 23, 30, 47]),
    (ATTN_FULL, 1, [0, 3]),
    (ATTN_FULL, 64, [63, 0, 17, 200]),
    (ATTN_SWA, 24, [0, 5, 23, 30, 47]),
    (ATTN_SWA, 64, [63, 0, 17, 200]),
], ids=["full", "full-Sc1", "full-Sc64", "swa", "swa-Sc64"])
def test_cache_validity_matches_jax(attn_type, Sc, pos):
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jax_attn.cache_validity(attn_type, Sc, jnp.asarray(pos)))
    # the mask is slot < min(pos + 1, Sc), the lengths the port's decode
    # hands to its kernel (a full-attention engine keeps pos <= Sc - 1; an
    # SWA ring wraps)
    lengths = np.minimum(pos + 1, Sc)
    np.testing.assert_array_equal(np.arange(Sc)[None] < lengths[:, None], want)
    got = attn.cache_validity(attn_type, Sc, torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    scalar = attn.cache_validity(attn_type, Sc, torch.tensor(7)).numpy()
    np.testing.assert_array_equal(
        scalar, np.asarray(jax_attn.cache_validity(attn_type, Sc, jnp.int32(7))))


def test_unported_attention_raises():
    """The SWA and chunked-local arms are ported (held against JAX here, the
    chunked one where JAX is right: S % chunk == 0, tests/test_torch_llama4.py
    has the rest); cross attention (S_kv != S) is ported in its non-causal
    form (tests/test_torch_whisper.py), the causal form, which JAX never
    asks for, still raises; the int8 dense cache is ported
    (tests/test_torch_int8_dense.py)."""
    rng = np.random.default_rng(8)
    q, kv = _normal(rng, (1, 8, 4, 64)), _normal(rng, (2, 1, 8, 2, 64))
    want = jax_attn.blockwise_attention(jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                        attn_type=ATTN_SWA, window=4)
    got = attn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(kv[0]),
                                   torch.from_numpy(kv[1]), attn_type=ATTN_SWA, window=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    swa = attn.cache_validity(ATTN_SWA, 24, torch.tensor([3, 30]), 8).numpy()
    np.testing.assert_array_equal(
        swa, np.asarray(jax_attn.cache_validity(ATTN_SWA, 24, jnp.asarray([3, 30]), 8)))
    want = jax_attn.blockwise_attention(jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                                        attn_type=ATTN_CHUNKED_LOCAL, chunk=4)
    got = attn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(kv[0]),
                                   torch.from_numpy(kv[1]), attn_type=ATTN_CHUNKED_LOCAL, chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    chunked = attn.cache_validity(ATTN_CHUNKED_LOCAL, 24, torch.tensor([3, 30]), 8).numpy()
    np.testing.assert_array_equal(
        chunked, np.asarray(jax_attn.cache_validity(ATTN_CHUNKED_LOCAL, 24, jnp.asarray([3, 30]),
                                                    8)))
    q, kv = torch.from_numpy(q), torch.from_numpy(kv[0])
    with pytest.raises(NotImplementedError):       # causal cross attention: S_kv != S
        attn.blockwise_attention(q, kv[:, :4], kv[:, :4])
    with pytest.raises(NotImplementedError):       # a windowed one
        attn.blockwise_attention(q, kv[:, :4], kv[:, :4], attn_type=ATTN_SWA, window=2,
                                 causal=False)
    cfg = smoke_variant(get_arch("smollm-135m")).replace(kv_cache_quant=True)
    entry = init_cache(cfg, 2, 16, "cpu")[0]
    assert entry["k"].dtype == torch.int8 and tuple(entry["k_scale"].shape) == (2, 2, 16, 2)


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------


def _setup(arch, seed):
    """JAX and torch params from one numpy tree, QKV biases randomised (JAX
    initialises them to zero, which would hide the bias path)."""
    jcfg = jax_smoke(jax_get_arch(arch))
    tcfg = smoke_variant(get_arch(arch))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    a = tree["blocks"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in a:
            a[name] = (0.5 * rng.standard_normal(a[name].shape)).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, "cpu"), rng


@pytest.mark.parametrize("arch,seed", [("qwen2.5-3b", 0), ("smollm-135m", 1)])
def test_forward_and_prefill_match_jax(arch, seed):
    jcfg, tcfg, jp, tp, rng = _setup(arch, seed)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    jl, _, jc = jax_forward(jcfg, jp, {"tokens": jnp.asarray(tokens)}, want_cache=True)
    tl, aux, tc = forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)}, want_cache=True)
    assert tuple(tl.shape) == (2, 21, jcfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert len(tc) == len(jc) == 1
    for name in ("k", "v"):
        assert tuple(tc[0][name].shape) == jc[0][name].shape
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]), **CACHE_TOL)
    last, pc = prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **LOGIT_TOL)
    np.testing.assert_allclose(pc[0]["k"].numpy(), np.asarray(jc[0]["k"]), **CACHE_TOL)


@pytest.mark.parametrize("arch,seed", [("qwen2.5-3b", 2), ("smollm-135m", 3)])
def test_init_cache_and_decode_step_match_jax(arch, seed):
    jcfg, tcfg, jp, tp, rng = _setup(arch, seed)
    B, Sc = 3, 40
    jzero = jax_init_cache(jcfg, B, Sc)
    tzero = init_cache(tcfg, B, Sc, "cpu")
    assert len(tzero) == len(jzero) == 1 and set(tzero[0]) == set(jzero[0]) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(tzero[0][name].shape) == jzero[0][name].shape
        assert tzero[0][name].dtype == torch.float32 and not tzero[0][name].any()
    # prior cache contents, one new token per row; row 2 inactive (token 0
    # at pos 0, as the engine decodes free slots)
    shape = jzero[0]["k"].shape
    k, v = _normal(rng, shape), _normal(rng, shape)
    pos = np.asarray([37, 16, 0], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    tokens[2] = 0
    jl, jc = jax_decode_step(jcfg, jp, ({"k": jnp.asarray(k), "v": jnp.asarray(v)},),
                             jnp.asarray(tokens), jnp.asarray(pos))
    tc = ({"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())},)
    tl, out = decode_step(tcfg, tp, tc, torch.from_numpy(tokens), torch.from_numpy(pos))
    assert out is tc                                 # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]), **CACHE_TOL)
    assert not np.allclose(tc[0]["k"].numpy(), k)    # it did write


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke(jax_get_arch("smollm-135m"))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch("smollm-135m"))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


# (engine arguments, [(prompt, max_new)]); tests/test_paged_engine.py:35-46,
# :203-216 and :190-200, and max_seq 100: a 70-token prompt in a 100-token
# bucket and a truncated 120-token one
ENGINE_WORKLOADS = {
    "batched": (dict(max_batch=3, max_seq=128),
                [(np.arange(9) % 50, 8), (np.arange(21) % 50 + 3, 8),
                 (np.arange(5) % 50 + 7, 8)]),
    "lengths": (dict(max_batch=1, max_seq=128),
                [((np.arange(n) * 7) % 90, 4) for n in (1, 15, 16, 17, 63, 64, 65)]),
    "truncated": (dict(max_batch=1, max_seq=64), [(np.arange(100) % 90, 4)]),
    "max_seq_100": (dict(max_batch=2, max_seq=100),
                    [((np.arange(70) * 3) % 90, 20), ((np.arange(120) * 5) % 90, 4),
                     ((np.arange(30) * 11) % 90, 12)]),
}


@pytest.mark.parametrize("workload", list(ENGINE_WORKLOADS))
def test_dense_engine_matches_jax_and_paged(weights, workload):
    jcfg, jparams, tcfg, tparams = weights
    kw, prompts = ENGINE_WORKLOADS[workload]
    runs = {
        "jax dense": JaxEngine(jcfg, params=jparams, backend="dense", **kw),
        "dense": GenerationEngine(tcfg, params=tparams, device="cpu", backend="dense", **kw),
        "paged": GenerationEngine(tcfg, params=tparams, device="cpu", **kw),
    }
    out = {}
    for name, eng in runs.items():
        reqs = [eng.submit(p, max_new=n) for p, n in prompts]
        eng.run_until_done()
        assert all(r.done for r in reqs) and not any(eng.slots), name
        out[name] = [(r.out_tokens, r.truncated, r.pos) for r in reqs]
    assert out["dense"] == out["jax dense"]
    assert [t for t, _, _ in out["paged"]] == [t for t, _, _ in out["dense"]]
    dense = runs["dense"]
    st = dense.stats()
    assert (st["backend"], st["kernel"], st["interleave"], st["pipeline"]) == \
        ("dense", "plain", False, False)
    assert st["steps"] == runs["jax dense"].steps
    assert st["tokens_out"] == sum(len(t) for t, _, _ in out["dense"])
    assert dense.latency_summary()["n_finished"] == len(prompts)
    assert dense.warmup_step_variants() == 0
    for (toks, truncated, pos), (p, n) in zip(out["dense"], prompts):
        assert pos <= kw["max_seq"] and truncated == (len(p) > kw["max_seq"])
        assert len(toks) == (1 if truncated else n)
