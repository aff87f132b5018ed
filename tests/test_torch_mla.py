"""minicpm3-4b (multi-head latent attention) on the port's dense backend
against the JAX package on the CPU, at smoke width (2 layers, d 256, 4
heads, q_lora 64, kv_lora 32, nope 32, rope 16, v 32, vocab 512) in
float32, on the same numpy inputs and weights (JAX ``init_params`` through
``params_from_numpy``).

- The config and the MLA params tree; ``mla_latents``, ``mla_queries``,
  ``mla_prefill`` (expanded heads through the flash kernel's plain version
  at split head dims: 48 query/key, 32 value) and ``mla_decode`` (the
  absorbed form) against JAX; the plain flash at MLA's split dims against
  JAX ``blockwise_attention``.
- An MLA layer over a sequence, ``forward``, ``init_cache`` and
  ``decode_step`` against JAX (MLA in JAX is consistent: its engine, its
  ``forward`` and its ``decode_step`` agree).
- The engine (a full-attention cache of latents, prefill padded to the
  bucket as in JAX) against the JAX dense engine and against the no-cache
  oracle (JAX ``forward``, teacher-forced) at Lp 5, 23, 40 and 100; the
  launcher.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import attention as jax_attn
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import transformer as jax_tfm
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import card_smoke_variant, get_arch, smoke_variant
from repro_torch.configs.base import ATTN_MLA
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention, ref_flash_attention
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (
    decode_step,
    dense_cache_supported,
    forward,
    init_cache,
    init_params,
    paged_cache_supported,
    prefill,
    prefills_unpadded,
)
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

torch.set_num_threads(1)

ARCH = "minicpm3-4b"
OUT_TOL = dict(rtol=1e-4, atol=1e-4)        # two f32 stacks, other summation orders
FN_TOL = dict(rtol=1e-5, atol=1e-5)         # one function, other summation orders


def test_config_matches_jax():
    full, jfull = get_arch(ARCH), jax_get_arch(ARCH)
    small, jsmall = smoke_variant(full), jax_smoke(jfull)
    for t, j in ((full, jfull), (small, jsmall)):
        for name in ("name", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
                     "d_ff", "vocab_size", "attn_type", "q_lora_rank", "kv_lora_rank",
                     "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "rope_theta",
                     "padded_vocab", "num_experts"):
            assert getattr(t, name) == getattr(j, name), name
    assert (full.qk_nope_head_dim + full.qk_rope_head_dim, full.v_head_dim) == (96, 64)
    assert full.attn_type == ATTN_MLA and tfm.period(full) == 1
    for cfg in (full, small):
        assert dense_cache_supported(cfg) and not paged_cache_supported(cfg)
        assert not prefills_unpadded(cfg)           # a linear cache: bucketed, as in JAX


@pytest.mark.parametrize("arch", ["minicpm3-4b", "llama4-scout-17b-a16e", "qwen2.5-3b"])
def test_card_smoke_variant(arch):
    """The smoke variant the card runs: minicpm3's at MLA's real head dims,
    one of the flash kernel's instantiations; every other arch's unchanged."""
    cfg, small = card_smoke_variant(arch), smoke_variant(get_arch(arch))
    if arch != ARCH:
        assert cfg == small
        return
    full = get_arch(arch)
    dims = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.head_dim)
    assert dims == (full.qk_nope_head_dim, full.qk_rope_head_dim, full.v_head_dim,
                    full.head_dim) == (64, 32, 64, 96)
    assert (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim) in HEAD_DIMS
    assert (small.qk_nope_head_dim + small.qk_rope_head_dim, small.v_head_dim) not in HEAD_DIMS
    assert cfg.replace(qk_nope_head_dim=small.qk_nope_head_dim,
                       qk_rope_head_dim=small.qk_rope_head_dim, v_head_dim=small.v_head_dim,
                       head_dim=small.head_dim) == small


def _tree(seed):
    """The JAX smoke model's tree as numpy, the norm scales (model and MLA)
    given seeded noise (JAX initialises them to ones)."""
    jcfg = jax_smoke(jax_get_arch(ARCH))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    blk = tree["blocks"][0]
    for parent, name in ((blk["norm1"], "scale"), (blk["norm2"], "scale"),
                         (blk["attn"], "q_norm"), (blk["attn"], "kv_norm")):
        parent[name] = (parent[name] + 0.1 * rng.standard_normal(parent[name].shape)
                        ).astype(np.float32)
    return jcfg, smoke_variant(get_arch(ARCH)), tree, rng


def test_params_tree_matches_jax():
    jcfg, tcfg, tree, _ = _tree(0)
    ttree = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_leaves_with_path(tree)
    tl = jax.tree_util.tree_leaves_with_path(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    assert [tuple(x.shape) for _, x in tl] == [x.shape for _, x in jl]
    a = ttree["blocks"][0]["attn"]
    assert set(a) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert tuple(a["wkv_b"].shape) == (2, 32, 4 * (32 + 32))
    assert bool((a["q_norm"] == 1).all()) and bool((a["kv_norm"] == 1).all())


def _layer(seed):
    jcfg, tcfg, tree, rng = _tree(seed)
    layer = jax.tree.map(lambda a: a[0], tree["blocks"][0])
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, layer), params_from_numpy(tcfg, layer, "cpu"),
            rng)


@pytest.mark.parametrize("S", [1, 23, 70])
def test_mla_functions_match_jax(S):
    jcfg, tcfg, jp, tp, rng = _layer(1)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + 5, (2, S)).copy()
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    tx, rope = torch.from_numpy(x), tfm._rope(tcfg, torch.from_numpy(pos))
    assert rope[0].shape[-1] == jcfg.qk_rope_head_dim // 2
    for want, got in zip(jax_attn.mla_latents(jp["attn"], jx, jcfg, jpos),
                         attn.mla_latents(tp["attn"], tx, tcfg, rope)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    for want, got in zip(jax_attn.mla_queries(jp["attn"], jx, jcfg, jpos),
                         attn.mla_queries(tp["attn"], tx, tcfg, rope)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    jout, (jc, jk) = jax_attn.mla_prefill(jp["attn"], jx, jcfg, jpos)
    tout, (tc, tk) = attn.mla_prefill(tp["attn"], tx, tcfg, rope)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **FN_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **FN_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **FN_TOL)


@pytest.mark.parametrize("Sc,pos", [(40, [0, 17, 39]), (96, [95, 3, 50])])
def test_mla_decode_matches_jax(Sc, pos):
    """The absorbed decode over a latent cache (c_kv, k_rope) of Sc slots,
    slots <= pos valid, per-row positions."""
    jcfg, tcfg, jp, tp, rng = _layer(2)
    B = len(pos)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    c_kv = rng.standard_normal((B, Sc, jcfg.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((B, Sc, jcfg.qk_rope_head_dim)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = jax_attn.mla_decode(jp["attn"], jnp.asarray(x), jcfg, jnp.asarray(c_kv),
                               jnp.asarray(k_rope), jnp.asarray(p))
    got = attn.mla_decode(tp["attn"], torch.from_numpy(x), tcfg, torch.from_numpy(c_kv),
                          torch.from_numpy(k_rope), torch.from_numpy(p),
                          tfm._rope(tcfg, torch.from_numpy(p)[:, None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("S", [7, 64, 130])
def test_split_head_dim_flash_matches_jax(S):
    """The flash kernel's plain version at MLA's split head dims (q/k 48, v
    32 at smoke width; 96 and 64 at full width) against JAX
    ``blockwise_attention``, scale 1/sqrt(48)."""
    rng = np.random.default_rng(S)
    q, k = (rng.standard_normal((1, S, 4, 48)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, S, 4, 32)).astype(np.float32)
    want = np.asarray(jax_attn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                                   scale=1 / np.sqrt(48)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = ref_flash_attention(*t, scale=1 / np.sqrt(48))
    assert tuple(got.shape) == (1, S, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, **FN_TOL)
    np.testing.assert_array_equal(flash_attention(*t, scale=1 / np.sqrt(48)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("S", [20, 90])
def test_mla_layer_seq_matches_jax(S):
    jcfg, tcfg, jp, tp, rng = _layer(3)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jx, jc, _ = jax_tfm.apply_layer_seq(jcfg, jax_tfm.layer_kind(jcfg, 0), jp, jnp.asarray(x),
                                        jnp.asarray(pos), True)
    tx, tc, taux = tfm.apply_layer_seq(tcfg, tp, torch.from_numpy(x),
                                       tfm._rope(tcfg, torch.from_numpy(pos)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **OUT_TOL)
    assert set(tc) == set(jc) == {"c_kv", "k_rope"} and float(taux) == 0
    for name in tc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **OUT_TOL)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke(jax_get_arch(ARCH))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch(ARCH))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


@pytest.mark.parametrize("S", [21, 60])
def test_forward_and_prefill_match_jax(weights, S):
    jcfg, jparams, tcfg, tparams = weights
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jl, _, jc = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, want_cache=True)
    tl, taux, tc = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, want_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    assert float(taux) == 0 and len(tc) == 1
    for name in ("c_kv", "k_rope"):
        assert tuple(tc[0][name].shape) == jc[0][name].shape
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]), **OUT_TOL)
    last, _ = prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **OUT_TOL)


def test_init_cache_and_decode_step_match_jax(weights):
    """Five decode steps, rows at different positions, after a 20-token
    prompt on 48-slot latent caches."""
    jcfg, jparams, tcfg, tparams = weights
    B, Sc = 2, 48
    jzero, tzero = jax_init_cache(jcfg, B, Sc), init_cache(tcfg, B, Sc, "cpu")
    assert set(tzero[0]) == set(jzero[0]) == {"c_kv", "k_rope"}
    for name, a in jzero[0].items():
        assert tuple(tzero[0][name].shape) == a.shape and not tzero[0][name].any()
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, 20)).astype(np.int32)
    _, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    _, tc = prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    jcache = ({n: jnp.zeros_like(jzero[0][n]).at[:, :, :20].set(a) for n, a in jc[0].items()},)
    tcache = init_cache(tcfg, B, Sc, "cpu")
    for n in ("c_kv", "k_rope"):
        tcache[0][n][:, :, :20] = tc[0][n]
    for i in range(5):
        toks1 = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.asarray([20 + i, 20 + 2 * i], np.int32)
        jl, jcache = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(toks1), jnp.asarray(pos))
        tl, out = decode_step(tcfg, tparams, tcache, torch.from_numpy(toks1),
                              torch.from_numpy(pos))
        assert out is tcache                                  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    for n in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[0][n].numpy(), np.asarray(jcache[0][n]), **OUT_TOL)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

N_NEW, MAX_SEQ = 8, 256
LENGTHS = (5, 23, 40, 100)


def _prompts(lengths, vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve(eng, prompts, max_new=N_NEW):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run_until_done()
    assert all(r.done for r in reqs) and not any(eng.slots)
    return [r.out_tokens for r in reqs]


def test_engine_matches_jax_dense_engine_and_forward(weights):
    """The four prompts through two slots (reused), ``backend="paged"``
    falling back to the dense backend: the JAX dense engine's tokens and
    step count, and every token the greedy token of JAX ``forward`` on the
    prompt plus the tokens so far (teacher-forced: one forward of the
    prompt and all but the last token)."""
    jcfg, jparams, tcfg, tparams = weights
    prompts = _prompts(LENGTHS, jcfg.vocab_size)
    teng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2, max_seq=MAX_SEQ)
    st = teng.stats()
    assert (st["backend"], st["kernel"]) == ("dense", "plain")
    assert set(teng.cache[0]) == {"c_kv", "k_rope"} and teng.cache[0]["c_kv"].shape[2] == MAX_SEQ
    jeng = JaxEngine(jcfg, params=jparams, backend="dense", max_batch=2, max_seq=MAX_SEQ)
    got = _serve(teng, prompts)
    assert got == _serve(jeng, prompts) and teng.steps == jeng.steps
    fwd = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t})[0])
    for prompt, toks in zip(prompts, got):
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        greedy = np.asarray(fwd(jparams, jnp.asarray(seq[None])))[0, len(prompt) - 1:].argmax(-1)
        assert greedy.tolist() == toks, len(prompt)


def test_launcher_serves_smoke_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n-requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke: device=cpu backend=dense mode=sync kernel=plain" in out
    assert out.count("4 tokens") == 3
