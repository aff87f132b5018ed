"""whisper-large-v3 (an encoder-decoder: a causal encoder over frame
embeddings, a decoder with cross attention, sinusoidal positions, GELU
MLPs, layer norms with bias) on the port against the JAX package on the
CPU, at smoke width (2 + 2 layers, d 256, 4 heads over 2 KV heads, hd 64,
64 frames, vocab 512) in float32, on the same numpy inputs and weights (JAX
``init_params`` through ``params_from_numpy``, the norm and MLP biases
noised).

- The config and the params tree (``enc_blocks``, ``enc_final_norm``,
  ``frame_proj``, ``cross_norm``/``cross_attn``, the GELU MLP).
- ``sinusoidal_positions`` and ``sinusoidal_at`` against JAX's
  ``sinusoidal_positions`` and ``_sinusoidal_at``.
- ``blockwise_attention`` at S_kv != S (non-causal cross attention,
  through the flash kernel's plain version) against JAX's; the causal
  cross form raises.
- The encoder, causal as in JAX (outputs before a changed frame do not
  move); a decoder layer over a sequence with its cross entries.
- ``forward``, ``prefill``, ``init_cache`` then ``decode_step`` against
  JAX's, and teacher-forced decode against ``forward``.
- The engine: the JAX dense engine fails with ``KeyError: 'frames'`` on
  any prompt, and the port's ``GenerationEngine`` refuses the config with
  a ``ValueError``.
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
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import prefill as jax_prefill
from repro.models import transformer as jax_tfm
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.kernels.flash_attention import flash_attention, ref_flash_attention
from repro_torch.models import (
    decode_step,
    dense_cache_supported,
    forward,
    init_cache,
    init_params,
    paged_cache_supported,
    prefill,
)
from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import sinusoidal_at, sinusoidal_positions
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
TOL = dict(rtol=2e-5, atol=2e-5)            # tests/test_kernel_conformance.py
OUT_TOL = dict(rtol=1e-4, atol=1e-4)        # two f32 stacks, other summation orders


def test_config_matches_jax():
    full, jfull = get_arch(ARCH), jax_get_arch(ARCH)
    small, jsmall = smoke_variant(full), jax_smoke(jfull)
    for t, j in ((full, jfull), (small, jsmall)):
        for name in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
                     "head_dim", "d_ff", "vocab_size", "attn_type", "use_rope", "act",
                     "is_encoder_decoder", "encoder_layers", "encoder_seq", "qkv_bias",
                     "padded_vocab", "tie_embeddings"):
            assert getattr(t, name) == getattr(j, name), name
    assert (full.num_layers, full.encoder_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim, full.d_ff, full.vocab_size,
            full.encoder_seq) == (32, 32, 1280, 20, 20, 64, 5120, 51866, 1500)
    assert full.padded_vocab == 51968 and (small.encoder_layers, small.encoder_seq) == (2, 64)
    for cfg in (full, small):
        assert dense_cache_supported(cfg) and not paged_cache_supported(cfg)
    # the encoder-decoder stack takes GELU MLPs only
    assert not dense_cache_supported(small.replace(act="silu"))


def _tree(seed):
    """The JAX smoke model's tree as numpy, every norm and MLP bias and norm
    scale given seeded noise (JAX initialises them to zeros and ones)."""
    jcfg = jax_smoke(jax_get_arch(ARCH))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    noise = lambda a, s: (a + s * rng.standard_normal(a.shape)).astype(np.float32)
    norms = [tree["final_norm"], tree["enc_final_norm"]]
    for blk in (tree["blocks"][0], tree["enc_blocks"][0]):
        norms += [blk[n] for n in ("norm1", "norm2", "cross_norm") if n in blk]
        for name in ("b_up", "b_down"):
            blk["mlp"][name] = noise(blk["mlp"][name], 0.3)
    for norm in norms:
        norm["scale"], norm["bias"] = noise(norm["scale"], 0.1), noise(norm["bias"], 0.1)
    return jcfg, smoke_variant(get_arch(ARCH)), tree, rng


def test_params_tree_matches_jax():
    jcfg, tcfg, tree, _ = _tree(0)
    ttree = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_leaves_with_path(tree)
    tl = jax.tree_util.tree_leaves_with_path(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    assert [tuple(x.shape) for _, x in tl] == [x.shape for _, x in jl]
    dec, enc = ttree["blocks"][0], ttree["enc_blocks"][0]
    assert set(dec) == {"norm1", "attn", "cross_norm", "cross_attn", "norm2", "mlp"}
    assert set(enc) == {"norm1", "attn", "norm2", "mlp"}
    assert set(dec["cross_attn"]) == {"wq", "wk", "wv", "wo"}          # no bias
    assert set(dec["mlp"]) == {"w_up", "b_up", "w_down", "b_down"}
    assert set(dec["norm1"]) == {"scale", "bias"}
    assert not dec["mlp"]["b_up"].any() and tuple(enc["attn"]["wq"].shape) == (2, 256, 256)


@pytest.mark.parametrize("S,d", [(1, 256), (64, 256), (1500, 1280), (37, 64)])
def test_sinusoidal_positions_match_jax(S, d):
    want = np.asarray(jax_layers.sinusoidal_positions(S, d))
    got = sinusoidal_positions(S, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pos = np.asarray([0, 3, S - 1, 447], np.int32)
    want_at = np.stack([np.asarray(jax_model._sinusoidal_at(jnp.int32(p), d)) for p in pos])
    np.testing.assert_allclose(sinusoidal_at(torch.from_numpy(pos), d).numpy(), want_at, **TOL)
    np.testing.assert_array_equal(sinusoidal_at(torch.arange(S), d).numpy(), got.numpy())


@pytest.mark.parametrize("S", [1, 5, 64])
@pytest.mark.parametrize("S_kv", [64, 100])
def test_cross_blockwise_attention_matches_jax(S, S_kv):
    """Non-causal attention of S queries over S_kv keys (cross attention),
    4 heads over 2 KV heads, against JAX ``blockwise_attention``; the flash
    wrapper on CPU tensors is its plain version."""
    rng = np.random.default_rng(S * 1000 + S_kv)
    q = rng.standard_normal((2, S, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, S_kv, 2, 64)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_attn.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=False))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = attn.blockwise_attention(*t, causal=False)
    assert tuple(got.shape) == (2, S, 4, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(flash_attention(*t, causal=False).numpy(), got.numpy())
    np.testing.assert_array_equal(ref_flash_attention(*t, causal=False).numpy(), got.numpy())
    if S != S_kv:
        with pytest.raises(NotImplementedError):        # JAX never asks for it
            attn.blockwise_attention(*t)
        with pytest.raises(ValueError):
            flash_attention(*t, causal=True)
        with pytest.raises(ValueError):
            flash_attention(*t, causal=False, window=8)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg, tree, _ = _tree(1)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def test_encoder_matches_jax_and_is_causal(weights):
    """The encoder (frame_proj, sinusoidal positions, its layers,
    enc_final_norm) against JAX's ``_encode``; and causal, as JAX's is:
    frames 40.. changed leave outputs 0..39 exactly as they were."""
    jcfg, jp, tcfg, tp = weights
    frames = _frames(jcfg, 2, 3)
    want = np.asarray(jax_model._encode(jcfg, jp, {"frames": jnp.asarray(frames)}))
    got = model_mod._encode(tcfg, tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    moved = frames.copy()
    moved[:, 40:] += np.random.default_rng(4).standard_normal(moved[:, 40:].shape)
    got2 = model_mod._encode(tcfg, tp, torch.from_numpy(moved)).numpy()
    np.testing.assert_array_equal(got2[:, :40], got.numpy()[:, :40])
    assert np.abs(got2[:, 40:] - got.numpy()[:, 40:]).max() > 0.1
    want2 = np.asarray(jax_model._encode(jcfg, jp, {"frames": jnp.asarray(moved)}))
    np.testing.assert_allclose(want2[:, :40], want[:, :40], rtol=0, atol=0)


@pytest.mark.parametrize("S", [1, 23])
def test_decoder_layer_seq_matches_jax(weights, S):
    """One decoder layer over a sequence: self-attention, cross attention
    over an encoder output, GELU MLP; its entry {k, v, ck, cv}."""
    jcfg, jp, tcfg, tp = weights
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    tlp = tfm.layer_slice(tp["blocks"][0], 0)
    jx, jc, _ = jax_tfm.apply_layer_seq(jcfg, jax_tfm.layer_kind(jcfg, 0), jlp, jnp.asarray(x),
                                        jnp.asarray(pos), True, jnp.asarray(enc))
    tx, tc, aux = tfm.apply_layer_seq(tcfg, tlp, torch.from_numpy(x), None,
                                      enc_out=torch.from_numpy(enc))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **OUT_TOL)
    assert set(tc) == set(jc) == {"k", "v", "ck", "cv"} and float(aux) == 0
    for name in tc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **OUT_TOL)


@pytest.mark.parametrize("S", [5, 21])
def test_forward_and_prefill_match_jax(weights, S):
    jcfg, jp, tcfg, tp = weights
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    frames = _frames(jcfg, 2, S + 1)
    jl, _, jc = jax_forward(jcfg, jp, {"tokens": jnp.asarray(tokens),
                                       "frames": jnp.asarray(frames)}, want_cache=True)
    tb = {"tokens": torch.from_numpy(tokens), "frames": torch.from_numpy(frames)}
    tl, aux, tc = forward(tcfg, tp, tb, want_cache=True)
    assert tuple(tl.shape) == (2, S, jcfg.padded_vocab) and float(aux) == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    assert set(tc[0]) == set(jc[0]) == {"k", "v", "ck", "cv"}
    for name in tc[0]:
        assert tuple(tc[0][name].shape) == jc[0][name].shape
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]), **OUT_TOL)
    assert tuple(tc[0]["ck"].shape) == (2, 2, 64, 2, 64)
    last, _ = prefill(tcfg, tp, tb)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **OUT_TOL)


def test_init_cache_and_decode_step_match_jax(weights):
    """A 12-token prompt prefilled into 40-slot caches with the cross
    entries, then five decode steps, rows at different positions."""
    jcfg, jp, tcfg, tp = weights
    B, Sc, Lp = 2, 40, 12
    jzero, tzero = jax_init_cache(jcfg, B, Sc), init_cache(tcfg, B, Sc, "cpu")
    assert set(tzero[0]) == set(jzero[0]) == {"k", "v", "ck", "cv"}
    for name, a in jzero[0].items():
        assert tuple(tzero[0][name].shape) == a.shape and not tzero[0][name].any()
    assert tuple(tzero[0]["ck"].shape) == (2, B, jcfg.encoder_seq, 2, 64)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (B, Lp)).astype(np.int32)
    frames = _frames(jcfg, B, 6)
    _, jc = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    _, tc = prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens),
                               "frames": torch.from_numpy(frames)})
    jcache = ({k: (jnp.zeros_like(jzero[0][k]).at[:, :, :Lp].set(a) if k in ("k", "v") else a)
               for k, a in jc[0].items()},)
    tcache = init_cache(tcfg, B, Sc, "cpu")
    for k in ("k", "v"):
        tcache[0][k][:, :, :Lp] = tc[0][k]
    for k in ("ck", "cv"):
        tcache[0][k].copy_(tc[0][k])
    for i in range(5):
        toks = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.asarray([Lp + i, Lp + 2 * i], np.int32)
        jl, jcache = jax_decode_step(jcfg, jp, jcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, out = decode_step(tcfg, tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos))
        assert out is tcache                                   # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    for k in tcache[0]:
        np.testing.assert_allclose(tcache[0][k].numpy(), np.asarray(jcache[0][k]), **OUT_TOL)


def test_decode_after_prefill_matches_forward(weights):
    """Teacher-forced decode after ``prefill`` gives ``forward``'s logits of
    the same sequence and frames: 8 tokens, 2 rows."""
    _, _, tcfg, tp = weights
    B, Lp, n_new = 2, 9, 8
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (B, Lp + n_new)).astype(np.int32))
    frames = torch.from_numpy(_frames(tcfg, B, 9))
    want, _ = forward(tcfg, tp, {"tokens": tokens, "frames": frames})
    _, pc = prefill(tcfg, tp, {"tokens": tokens[:, :Lp], "frames": frames})
    cache = init_cache(tcfg, B, Lp + n_new, "cpu")
    for k, t in pc[0].items():
        cache[0][k][:, :, :t.shape[2]] = t
    for i in range(n_new - 1):
        pos = torch.full((B,), Lp + i, dtype=torch.int32)
        logits, _ = decode_step(tcfg, tp, cache, tokens[:, Lp + i:Lp + i + 1], pos)
        np.testing.assert_allclose(logits.numpy(), want[:, Lp + i].numpy(), **OUT_TOL)


def test_engines_refuse_the_encoder_decoder(weights):
    """Neither engine serves whisper: the JAX dense engine's prefill calls
    ``forward`` without frames and fails with ``KeyError: 'frames'``; the
    port's engine refuses the config with a ``ValueError`` that says so."""
    jcfg, jp, tcfg, tp = weights
    jeng = JaxEngine(jcfg, params=jp, max_batch=2, max_seq=64)
    assert jeng.backend == "dense"
    jeng.submit(np.arange(7, dtype=np.int32), max_new=4)
    with pytest.raises(KeyError, match="frames"):
        jeng.run_until_done()
    for backend in ("paged", "dense"):
        with pytest.raises(ValueError, match="encoder-decoder.*JAX engine"):
            GenerationEngine(tcfg, params=tp, device="cpu", backend=backend)
