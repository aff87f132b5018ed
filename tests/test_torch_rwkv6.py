"""rwkv6-7b on the port's dense backend against the JAX package on the CPU,
at smoke width in float32, on the same numpy inputs and weights.

- The plain WKV recurrence (``ref_rwkv6_chunked``, what the CUDA kernel is
  held to on the card) against ``repro.kernels.ref.rwkv6_ref`` with a
  nonzero ``state0`` at 1e-5 (the same recurrence; sums in another order),
  and against the Pallas kernel in interpret mode at zero state at 2e-3
  (tests/test_kernels.py: its chunked form divides by running decay
  products), including the adversarial decay w = 0.45 (5e-3 there).
  Decays near 0 (w = 1e-6) are held against ``rwkv6_ref`` only: the Pallas
  form's running product underflows there.
- ``group_norm``, ``apply_rwkv6`` and ``apply_rwkv6_ffn`` against JAX: a
  prefill and one decode step with the carried state and token shifts, the
  zero-initialised leaves (``mu_*``, ``u``, ``decay_base``) perturbed with
  seeded noise so that every term counts; outputs at 1e-4.
- ``forward``, ``prefill``, ``decode_step``, ``init_cache`` and the weight
  bridge against JAX: logits at 1e-4, states at 1e-4; the port's
  ``init_params`` tree has JAX's shapes at full width (meta device against
  ``jax.eval_shape``).
- The engine: the port's dense backend gives the greedy tokens of JAX
  ``prefill`` on the unpadded prompt followed by ``decode_step`` at every
  tested prompt length, and the JAX dense engine's at bucket lengths. The
  JAX dense engine pads prompts to a power-of-two bucket and keeps the pad
  tokens in the recurrent state: a strict xfail shows that reference fault.
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
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import rwkv6 as jax_rwkv
from repro.models.layers import group_norm as jax_group_norm
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import ATTN_CHUNKED_LOCAL, ATTN_MLA, ATTN_SWA
from repro_torch.kernels.rwkv6_scan import ref_rwkv6_chunked, rwkv6_chunked
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (
    decode_step,
    dense_cache_supported,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import group_norm
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

torch.set_num_threads(1)

REF_TOL = dict(rtol=1e-5, atol=1e-5)      # the same recurrence, other summation order
PALLAS_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_kernels.py, chunked form
ADVERSARIAL_TOL = dict(rtol=5e-3, atol=5e-3)
OUT_TOL = dict(rtol=1e-4, atol=1e-4)      # two f32 stacks, other summation orders
ARCH = "rwkv6-7b"


def _wkv_inputs(rng, B, S, H, hd, decay):
    r, k = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(2))
    v = rng.standard_normal((B, S, H, hd))
    if decay is None:   # realistic Finch decay: w = exp(-exp(z)), z ~ N(0, 0.5)
        w = np.exp(-np.exp(0.5 * rng.standard_normal((B, S, H, hd))))
    else:
        w = np.full((B, S, H, hd), decay)
    u = 0.3 * rng.standard_normal((H, hd))
    state0 = 0.5 * rng.standard_normal((B, H, hd, hd))
    return [x.astype(np.float32) for x in (r, k, v, w, u, state0)]


@pytest.mark.parametrize("B,S,H,hd,decay", [
    (2, 1, 2, 32, None),      # one decode step
    (1, 37, 2, 64, None),     # odd S: the Pallas chunk halves down to 1
    (2, 64, 2, 32, None),
    (1, 64, 1, 32, 0.45),     # tests/test_kernels.py:71, adversarial decay
    (1, 40, 2, 32, 1e-6),     # decays near 0
], ids=["S1", "S37", "S64", "w0.45", "w1e-6"])
def test_plain_wkv_matches_ref_and_pallas(B, S, H, hd, decay):
    rng = np.random.default_rng(S * hd + B)
    r, k, v, w, u, state0 = _wkv_inputs(rng, B, S, H, hd, decay)
    t = lambda a: torch.from_numpy(a)
    y, st = ref_rwkv6_chunked(t(r), t(k), t(v), t(w), t(u), t(state0))
    y_ref, st_ref = jax_ref.rwkv6_ref(*map(jnp.asarray, (r, k, v, w, u, state0)))
    assert y.dtype == st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **REF_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), **REF_TOL)
    # the wrapper on CPU tensors is the plain version; state_out may be state0
    st_in = t(state0.copy())
    y2, st2 = rwkv6_chunked(t(r), t(k), t(v), t(w), t(u), st_in, state_out=st_in)
    assert st2 is st_in and rwkv6_chunked.launches == 0
    np.testing.assert_array_equal(y2.numpy(), y.numpy())
    np.testing.assert_array_equal(st_in.numpy(), st.numpy())
    # zero state: against the Pallas kernel, which ignores state0
    y0, st0 = rwkv6_chunked(t(r), t(k), t(v), t(w), t(u))
    if decay is not None and decay < 1e-3:
        assert np.isfinite(y0.numpy()).all() and np.isfinite(st0.numpy()).all()
        y0_ref, st0_ref = jax_ref.rwkv6_ref(*map(jnp.asarray, (r, k, v, w, u)))
        np.testing.assert_allclose(y0.numpy(), np.asarray(y0_ref), **REF_TOL)
        return
    tol = ADVERSARIAL_TOL if decay is not None else PALLAS_TOL
    y_p, st_p = ops.rwkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)), chunk=16 if decay else 32)
    np.testing.assert_allclose(y0.numpy(), np.asarray(y_p), **tol)
    np.testing.assert_allclose(st0.numpy(), np.asarray(st_p), **tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _perturbed_tree(seed):
    """The JAX smoke model's init tree as numpy, its zero-initialised
    leaves (and ``ln_x`` and the norms) given seeded noise."""
    jcfg = jax_smoke(jax_get_arch(ARCH))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    blk = tree["blocks"][0]
    noise = lambda a, s: (a + s * rng.standard_normal(a.shape)).astype(np.float32)
    for name in ("mu_first", "mu_base", "u", "decay_base", "ln_x"):
        blk["rwkv"][name] = noise(blk["rwkv"][name], 0.5)
    for name in ("mu_k", "mu_r"):
        blk["rwkv_ffn"][name] = noise(blk["rwkv_ffn"][name], 0.5)
    for norm in ("norm1", "norm2"):
        for name in ("scale", "bias"):
            blk[norm][name] = noise(blk[norm][name], 0.1)
    return jcfg, smoke_variant(get_arch(ARCH)), tree, rng


def test_group_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 5, 256)) + 1.0).astype(np.float32)
    scale = rng.standard_normal(256).astype(np.float32)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(scale), 8, eps=64e-5)
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(scale), 8, eps=64e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_rwkv_layers_prefill_then_decode_match_jax():
    jcfg, tcfg, tree, rng = _perturbed_tree(1)
    layer = jax.tree.map(lambda a: a[0], tree["blocks"][0])   # layer 0
    jp = jax.tree.map(jnp.asarray, layer)
    tp = params_from_numpy(tcfg, layer, "cpu")
    B, S, D = 2, 9, jcfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
    # prefill from zeros, then one decode step with the carried state
    j_out, (j_xp, j_st) = jax_rwkv.apply_rwkv6(jp["rwkv"], jnp.asarray(x), jcfg)
    t_out, (t_xp, t_st) = rwkv.apply_rwkv6(tp["rwkv"], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **OUT_TOL)
    np.testing.assert_allclose(t_xp.numpy(), np.asarray(j_xp), **OUT_TOL)
    np.testing.assert_allclose(t_st.numpy(), np.asarray(j_st), **OUT_TOL)
    j_out1, (_, j_st1) = jax_rwkv.apply_rwkv6(jp["rwkv"], jnp.asarray(x1), jcfg,
                                              x_prev_last=j_xp, state=j_st)
    t_out1, (_, t_st1) = rwkv.apply_rwkv6(tp["rwkv"], torch.from_numpy(x1), tcfg,
                                          x_prev_last=t_xp, state=t_st, state_out=t_st)
    assert t_st1 is t_st                                   # updated in place
    np.testing.assert_allclose(t_out1.numpy(), np.asarray(j_out1), **OUT_TOL)
    np.testing.assert_allclose(t_st1.numpy(), np.asarray(j_st1), **OUT_TOL)
    # channel mixing, the same way
    j_f, j_fx = jax_rwkv.apply_rwkv6_ffn(jp["rwkv_ffn"], jnp.asarray(x))
    t_f, t_fx = rwkv.apply_rwkv6_ffn(tp["rwkv_ffn"], torch.from_numpy(x))
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), **OUT_TOL)
    j_f1, _ = jax_rwkv.apply_rwkv6_ffn(jp["rwkv_ffn"], jnp.asarray(x1), j_fx)
    t_f1, _ = rwkv.apply_rwkv6_ffn(tp["rwkv_ffn"], torch.from_numpy(x1), t_fx)
    np.testing.assert_allclose(t_f1.numpy(), np.asarray(j_f1), **OUT_TOL)


# ---------------------------------------------------------------------------
# model API and the weight bridge
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_init_params_tree_matches_jax_at_full_width():
    jshapes = dict(_leaves(jax.eval_shape(
        lambda: jax_init_params(jax_get_arch(ARCH), jax.random.PRNGKey(0)))))
    tcfg = get_arch(ARCH)
    tshapes = dict(_leaves(init_params(tcfg, torch.Generator(), "meta")))
    assert set(tshapes) == set(jshapes)
    for name, leaf in jshapes.items():
        assert tuple(tshapes[name].shape) == leaf.shape, name
    # the smoke variant's drawn weights: the same tree, zero and unit leaves
    # where JAX has them, init scales within sampling error
    small = init_params(smoke_variant(tcfg), torch.Generator().manual_seed(0), "cpu")
    rw = small["blocks"][0]["rwkv"]
    assert not any(rw[n].any() for n in ("mu_first", "mu_base", "u", "decay_base"))
    assert bool((rw["ln_x"] == 1).all()) and bool((small["final_norm"]["bias"] == 0).all())
    assert abs(float(rw["mix_w1"].std()) - 0.01) < 1e-3
    assert abs(float(rw["wr"].std()) - 256 ** -0.5) < 3e-3


def test_params_bridge_carries_the_rwkv_tree():
    jcfg, tcfg, tree, _ = _perturbed_tree(2)
    tp = params_from_numpy(tcfg, tree, "cpu")
    got, want = dict(_leaves(tp)), dict(_leaves(tree))
    assert set(got) == set(want) and "/blocks/0/rwkv/decay_w2" in got
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)


def test_forward_prefill_decode_and_cache_match_jax():
    jcfg, tcfg, tree, rng = _perturbed_tree(3)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, "cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    jl, _, jc = jax_forward(jcfg, jp, {"tokens": jnp.asarray(tokens)}, want_cache=True)
    tl, aux, tc = forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)}, want_cache=True)
    assert tuple(tl.shape) == (2, 13, jcfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    names = {"state", "x_prev_att", "x_prev_ffn"}
    assert len(tc) == len(jc) == 1 and set(tc[0]) == set(jc[0]) == names
    for name in names:
        assert tuple(tc[0][name].shape) == jc[0][name].shape
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]), **OUT_TOL)
    last, pc = prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **OUT_TOL)
    # init_cache: zeros of JAX's shapes and dtypes (the state in f32)
    B = 3
    jzero, tzero = jax_init_cache(jcfg, B, 64), init_cache(tcfg, B, 64, "cpu")
    for name in names:
        assert tuple(tzero[0][name].shape) == jzero[0][name].shape
        assert tzero[0][name].dtype == torch.float32 and not tzero[0][name].any()
    # one decode step from a prior state (row 2 from zeros, token 0, as the
    # engine decodes a free slot)
    prior = {n: (0.3 * rng.standard_normal(jzero[0][n].shape)).astype(np.float32)
             for n in names}
    for n in names:
        prior[n][:, 2] = 0
    toks1 = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    toks1[2] = 0
    pos = np.asarray([13, 40, 0], np.int32)
    jl1, jc1 = jax_decode_step(jcfg, jp, ({n: jnp.asarray(a) for n, a in prior.items()},),
                               jnp.asarray(toks1), jnp.asarray(pos))
    tc1 = ({n: torch.from_numpy(a.copy()) for n, a in prior.items()},)
    tl1, out = decode_step(tcfg, tp, tc1, torch.from_numpy(toks1), torch.from_numpy(pos))
    assert out is tc1                                   # updated in place
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **OUT_TOL)
    for n in names:
        np.testing.assert_allclose(tc1[0][n].numpy(), np.asarray(jc1[0][n]), **OUT_TOL)
        assert not np.allclose(tc1[0][n].numpy(), prior[n])  # it did write


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

N_NEW, MAX_SEQ = 8, 64


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke(jax_get_arch(ARCH))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch(ARCH))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


def _prompts(lengths, vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def oracle(weights):
    """Greedy tokens of JAX ``prefill`` on the unpadded prompt, then
    ``decode_step`` (equal to token-by-token decode from an empty cache),
    on the module's weights; cached per prompt."""
    jcfg, jparams, _, _ = weights
    pf = jax.jit(lambda p, t: jax_prefill(jcfg, p, {"tokens": t}))
    dec = jax.jit(lambda p, c, t, pos: jax_decode_step(jcfg, p, c, t, pos))
    done = {}

    def tokens(prompt):
        key = prompt.tobytes()
        if key not in done:
            logits, cache = pf(jparams, jnp.asarray(prompt[None]))
            out = [int(jnp.argmax(logits[0]))]
            for i in range(N_NEW - 1):
                logits, cache = dec(jparams, cache, jnp.asarray([[out[-1]]], jnp.int32),
                                    jnp.asarray([len(prompt) + i], jnp.int32))
                out.append(int(jnp.argmax(logits[0])))
            done[key] = out
        return done[key]

    return tokens


def _serve(eng, prompts):
    reqs = [eng.submit(p, max_new=N_NEW) for p in prompts]
    eng.run_until_done()
    assert all(r.done for r in reqs) and not any(eng.slots)
    return [r.out_tokens for r in reqs]


def test_engine_matches_unpadded_prefill_oracle(weights, oracle):
    """Prompt lengths off and on the bucket sizes, five prompts through two
    slots (so slots are reused), ``backend="paged"`` falling back."""
    jcfg, jparams, tcfg, tparams = weights
    prompts = _prompts((1, 5, 16, 23, 40), jcfg.vocab_size)
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2, max_seq=MAX_SEQ)
    st = eng.stats()
    assert (st["backend"], st["interleave"], st["pipeline"], st["kernel"]) == \
        ("dense", False, False, "plain")
    got = _serve(eng, prompts)
    assert got == [oracle(p) for p in prompts]
    assert eng.stats()["prefill_tokens"] == sum(len(p) for p in prompts)


def test_engine_matches_jax_dense_engine_at_bucket_lengths(weights):
    """At bucket lengths the JAX dense engine pads nothing: both engines
    give the same tokens, here with a queue longer than ``max_batch``."""
    jcfg, jparams, tcfg, tparams = weights
    prompts = _prompts((16, 32, 16, 32, 16), jcfg.vocab_size)
    jeng = JaxEngine(jcfg, params=jparams, max_batch=2, max_seq=MAX_SEQ)
    teng = GenerationEngine(tcfg, params=tparams, device="cpu", backend="dense", max_batch=2,
                            max_seq=MAX_SEQ)
    assert jeng.backend == teng.backend == "dense"
    assert _serve(teng, prompts) == _serve(jeng, prompts)
    assert teng.steps == jeng.steps


@pytest.mark.xfail(strict=True, reason="reference fault (ROADMAP §3): the JAX dense engine "
                   "prefills the prompt padded with token 0 to its power-of-two bucket and "
                   "keeps the pad tokens in the RWKV state")
@pytest.mark.parametrize("Lp", [5, 23])
def test_jax_dense_engine_matches_unpadded_prefill_oracle(weights, oracle, Lp):
    jcfg, jparams, _, _ = weights
    prompt = _prompts((Lp,), jcfg.vocab_size)[0]
    jeng = JaxEngine(jcfg, params=jparams, max_batch=2, max_seq=MAX_SEQ)
    assert _serve(jeng, [prompt]) == [oracle(prompt)]


def test_truncated_prompt_and_unported_archs():
    tcfg = smoke_variant(get_arch(ARCH))
    eng = GenerationEngine(tcfg, device="cpu", max_batch=1, max_seq=32)
    req = eng.submit(np.arange(50) % tcfg.vocab_size, max_new=4)
    eng.run_until_done()
    assert req.truncated and req.pos <= 32 and len(req.out_tokens) == 1
    assert dense_cache_supported(tcfg)
    base = smoke_variant(get_arch("smollm-135m"))
    # SWA-only stacks and MoE on GQA stacks are ported (tests/test_torch_swa.py,
    # tests/test_torch_moe.py), chunked-local stacks with global layers and MLA
    # too (tests/test_torch_llama4.py, tests/test_torch_mla.py); MoE on RWKV-6
    # is not
    for cfg in (base.replace(attn_type=ATTN_SWA),
                base.replace(num_experts=4, num_experts_per_tok=2),
                base.replace(attn_type=ATTN_CHUNKED_LOCAL, global_layer_every=2)):
        assert dense_cache_supported(cfg)
        assert init_cache(cfg, 1, 16, "cpu")[0]["k"].shape[2] == 16
    mla = smoke_variant(get_arch("minicpm3-4b"))
    assert mla.attn_type == ATTN_MLA and dense_cache_supported(mla)
    assert init_cache(mla, 1, 16, "cpu")[0]["c_kv"].shape[2] == 16
    for cfg in (tcfg.replace(num_experts=4, num_experts_per_tok=2),
                base.replace(is_encoder_decoder=True, encoder_layers=2)):
        assert not dense_cache_supported(cfg)
        with pytest.raises(NotImplementedError):
            GenerationEngine(cfg, device="cpu")
        with pytest.raises(NotImplementedError):
            init_cache(cfg, 1, 16, "cpu")


def test_launcher_serves_rwkv6_smoke_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n-requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "rwkv6-7b-smoke: device=cpu backend=dense mode=sync kernel=plain" in out
    assert out.count("4 tokens") == 3
