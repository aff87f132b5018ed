"""The int8 dense cache (``kv_cache_quant``) on the port against the JAX
package on the CPU, at smoke width in float32, on the same numpy inputs and
weights.

- ``quantize_kv`` bit for bit against JAX ``_quantize_kv`` (zero slots, .5
  ties, a bf16 input), ``dequantize_kv`` against ``_dequantize_kv``, and
  the ring roll commuting with the quantization.
- ``init_cache``'s entries (int8 K/V, float32 scales; MLA, RWKV-6 and the
  cross entries stay float); a sequence layer's int8 entry; the decode layer
  over an int8 cache against JAX's for a full-attention cache, a wrapped
  sliding-window ring, a chunked-local ring (llama4's MoE layer) and a
  hybrid layer's ring (hymba); ``prefill_chunk`` into an int8 cache.
- The dense engine with ``kv_cache_quant`` (smollm-135m with
  ``backend="dense"``, internvl2-1b) against the JAX dense engine on
  ``torch_harness.bursty_workload``: identical greedy tokens, the caches'
  codes within one and their scales within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_harness import bursty_workload

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_chunk as jax_prefill_chunk
from repro.models import transformer as jax_tfm
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models import init_cache, prefill_chunk
from repro_torch.models import transformer as tfm
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

torch.set_num_threads(1)

OUT_TOL = dict(rtol=1e-4, atol=1e-4)        # two f32 stacks, other summation orders
SCALE_TOL = dict(rtol=1e-5, atol=0)
# logits read through int8 codes the two stacks quantized themselves: the
# float K/V differ by summation order, so a code may land one apart (one
# code of a V entry moves the logits of the smoke model by ~4e-4)
CODE_LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


def _cfgs(arch):
    return (jax_smoke(jax_get_arch(arch)).replace(kv_cache_quant=True),
            smoke_variant(get_arch(arch)).replace(kv_cache_quant=True))


def _jax_quantize(x):
    q, s = jax_tfm._quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def test_quantize_kv_is_bit_for_bit_with_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 17, 2, 64)) * rng.uniform(0.01, 30, (3, 17, 2, 1))
         ).astype(np.float32)
    x[0, 3] = 0.0                                         # a zero slot: scale 0, codes 0
    x[1, 5, 0] = np.concatenate([[127.0], np.arange(63) - 31.5]).astype(np.float32)  # .5 ties
    q, s = tfm.quantize_kv(torch.from_numpy(x))
    jq, js = _jax_quantize(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (3, 17, 2)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    assert not q[0, 3].any() and not s[0, 3].any()
    np.testing.assert_array_equal(q[1, 5, 0, 1:].numpy(), np.round(np.arange(63) - 31.5))
    # a bfloat16 input quantizes from its float32 widening, as in JAX
    xb = torch.from_numpy(x).bfloat16()
    qb, sb = tfm.quantize_kv(xb)
    jqb, jsb = _jax_quantize(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(qb.numpy(), jqb)
    np.testing.assert_array_equal(sb.numpy(), jsb)
    for dtype in (torch.float32, torch.bfloat16):
        got = tfm.dequantize_kv(q, s, dtype)
        want = jax_tfm._dequantize_kv(jnp.asarray(jq), jnp.asarray(js),
                                      jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("S,Sc", [(100, 64), (64, 64), (130, 64), (20, 20)])
def test_ring_and_quantization_commute(S, Sc):
    """The prefill quantizes after the ring roll; the scales are per slot,
    so quantizing first and rolling after gives the same bits."""
    k = torch.from_numpy(np.random.default_rng(S).standard_normal((2, S, 2, 64))
                         .astype(np.float32))
    q1, s1 = tfm.quantize_kv(tfm._ring(k, Sc))
    q, s = tfm.quantize_kv(k)
    torch.testing.assert_close(q1, tfm._ring(q, Sc), rtol=0, atol=0)
    torch.testing.assert_close(s1, tfm._ring(s, Sc), rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b", "llama4-scout-17b-a16e",
                                  "minicpm3-4b", "rwkv6-7b", "whisper-large-v3"])
def test_init_cache_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jc, tc = jax_init_cache(jcfg, 2, 40), init_cache(tcfg, 2, 40, "cpu")
    assert len(tc) == len(jc)
    for te, je in zip(tc, jc):
        assert set(te) == set(je)
        for name, a in je.items():
            assert tuple(te[name].shape) == a.shape, (name, te[name].shape, a.shape)
            assert str(te[name].dtype).split(".")[-1] == str(a.dtype), name
            assert not te[name].any()
    if "k" in tc[0]:
        assert tc[0]["k"].dtype == torch.int8 and tc[0]["k_scale"].dtype == torch.float32
    if "ck" in tc[0]:
        assert tc[0]["ck"].dtype == torch.float32               # cross entries stay float


def _layer(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    tree = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    lp = jax.tree.map(lambda a: a[0], tree["blocks"][0])
    return jcfg, tcfg, jax.tree.map(jnp.asarray, lp), params_from_numpy(tcfg, lp, "cpu")


def test_layer_seq_int8_entry_matches_jax():
    jcfg, tcfg, jp, tp = _layer("smollm-135m", 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 23, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(23, dtype=np.int32), (2, 23)).copy()
    jx, jc, _ = jax_tfm.apply_layer_seq(jcfg, jax_tfm.layer_kind(jcfg, 0), jp, jnp.asarray(x),
                                        jnp.asarray(pos), True)
    tx, tc, _ = tfm.apply_layer_seq(tcfg, tp, torch.from_numpy(x),
                                    tfm._rope(tcfg, torch.from_numpy(pos)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **OUT_TOL)
    assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale"}
    for name in ("k", "v"):
        assert tc[name].dtype == torch.int8
        assert np.abs(tc[name].numpy().astype(int) - np.asarray(jc[name]).astype(int)).max() <= 1
        np.testing.assert_allclose(tc[name + "_scale"].numpy(), np.asarray(jc[name + "_scale"]),
                                   **SCALE_TOL)


# (arch, Sc, pos): a full-attention cache; a sliding-window ring wrapped
# (positions past the window); llama4's chunked-local ring (period
# position 0: chunk 64, top-1 MoE with a shared expert); hymba's hybrid
# layer on its window's ring
DECODE_CASES = {
    "full": ("smollm-135m", 40, [39, 3, 20]),
    "swa_ring": ("qwen2.5-3b-swa", 64, [63, 64, 150]),
    "chunked_ring": ("llama4-scout-17b-a16e", 64, [63, 64, 130]),
    "hybrid_ring": ("hymba-1.5b", 64, [10, 64, 200]),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_int8_decode_layer_matches_jax(case):
    """One decode layer over an int8 cache of random codes and scales: the
    new token's K/V quantized into slot pos % Sc, the cache read dequantized
    whole: the output within OUT_TOL, the written codes within one and
    scales within 1e-5 relative, the rest of the cache untouched."""
    arch, Sc, pos = DECODE_CASES[case]
    jcfg, tcfg, jp, tp = _layer(arch, 2)
    B, KVH, hd = len(pos), jcfg.num_kv_heads, jcfg.head_dim
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    cache = {n: rng.integers(-127, 128, (B, Sc, KVH, hd)).astype(np.int8) for n in ("k", "v")}
    cache.update({n + "_scale": rng.uniform(0.005, 0.05, (B, Sc, KVH)).astype(np.float32)
                  for n in ("k", "v")})
    if case == "hybrid_ring":
        cache["conv"] = rng.standard_normal((B, jcfg.ssm_conv - 1, jcfg.d_model)
                                            ).astype(np.float32)
        cache["h"] = rng.standard_normal((B, jcfg.d_model, jcfg.ssm_state)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    kind = jax_tfm.layer_kind(jcfg, 0)
    jx, jc = jax_tfm.apply_layer_decode(jcfg, kind, jp, jnp.asarray(x),
                                        {n: jnp.asarray(a) for n, a in cache.items()},
                                        jnp.asarray(p))
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tpos = torch.from_numpy(p)
    rope = tfm._rope(tcfg, tpos[:, None])
    lengths = tfm.decode_lengths(tcfg, tfm.layer_kind(tcfg, 0), Sc, tpos)
    if case == "hybrid_ring":
        tx = tfm.apply_layer_decode_hybrid(tcfg, tp, torch.from_numpy(x), tcache, tpos,
                                           rope=rope, lengths=lengths)
    else:
        tx = tfm.apply_layer_decode(tcfg, tp, torch.from_numpy(x), tcache, tpos, rope=rope,
                                    lengths=lengths)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **OUT_TOL)
    slot = p % Sc
    rows = np.arange(B)
    for name in ("k", "v"):
        got, want = tcache[name].numpy().astype(int), np.asarray(jc[name]).astype(int)
        assert np.abs(got - want).max() <= 1
        np.testing.assert_allclose(tcache[name + "_scale"].numpy(),
                                   np.asarray(jc[name + "_scale"]), **SCALE_TOL)
        keep = np.ones((B, Sc), bool)
        keep[rows, slot] = False
        np.testing.assert_array_equal(got[keep], cache[name][keep].astype(int))
    if case == "hybrid_ring":
        for name in ("conv", "h"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jc[name]), **OUT_TOL)


def test_prefill_chunk_into_int8_cache_matches_jax():
    """Two chunks (16 tokens at slot 0, then 10 at 16) into a zero int8
    cache of 48 slots, as the JAX function writes them: the logits within
    ``CODE_LOGIT_TOL``, the codes within one and the scales within 1e-5."""
    jcfg, tcfg = _cfgs("smollm-135m")
    tree = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(4)))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, "cpu")
    rng = np.random.default_rng(4)
    jc, tc = jax_init_cache(jcfg, 2, 48), init_cache(tcfg, 2, 48, "cpu")
    for start, C in ((0, 16), (16, 10)):
        toks = rng.integers(0, jcfg.vocab_size, (2, C)).astype(np.int32)
        jl, jc = jax_prefill_chunk(jcfg, jp, jc, jnp.asarray(toks), start)
        tl, tc = prefill_chunk(tcfg, tp, tc, torch.from_numpy(toks), start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **CODE_LOGIT_TOL)
    for name in ("k", "v"):
        diff = tc[0][name].numpy().astype(int) - np.asarray(jc[0][name]).astype(int)
        assert np.abs(diff).max() <= 1
        np.testing.assert_allclose(tc[0][name + "_scale"].numpy(),
                                   np.asarray(jc[0][name + "_scale"]), **SCALE_TOL)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["smollm-135m", "internvl2-1b"])
def engine_weights(request):
    jcfg, tcfg = _cfgs(request.param)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(5)))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


@pytest.mark.parametrize("seed", [0, 2])
def test_int8_dense_engine_matches_jax_dense_engine(engine_weights, seed):
    """``backend="dense"`` with ``kv_cache_quant``: the int8 dense cache on
    both sides. The bursty harness workload: identical greedy tokens and
    steps; the batch caches' int8 codes within one and their scales within
    1e-5 relative (the float K/V differ by summation order)."""
    jcfg, jparams, tcfg, tparams = engine_weights
    kw = dict(max_batch=3, max_seq=128, backend="dense")
    teng = GenerationEngine(tcfg, params=tparams, device="cpu", **kw)
    jeng = JaxEngine(jcfg, params=jparams, **kw)
    assert teng.backend == jeng.backend == "dense"
    assert teng.cache[0]["k"].dtype == torch.int8 and set(teng.cache[0]) == set(jeng.cache[0])
    long_decode = seed == 2
    got = [(r.out_tokens, r.pos) for r in bursty_workload(teng, seed, long_decode)]
    want = [(r.out_tokens, r.pos) for r in bursty_workload(jeng, seed, long_decode)]
    assert got == want and teng.steps == jeng.steps
    for name in ("k", "v"):
        diff = teng.cache[0][name].numpy().astype(int) - np.asarray(jeng.cache[0][name]
                                                                    ).astype(int)
        assert np.abs(diff).max() <= 1
        np.testing.assert_allclose(teng.cache[0][name + "_scale"].numpy(),
                                   np.asarray(jeng.cache[0][name + "_scale"]), **SCALE_TOL)
