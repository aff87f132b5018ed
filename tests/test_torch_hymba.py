"""hymba-1.5b on the port's dense backend against the JAX package on the CPU,
at smoke width (2 layers, d 256, window 64, 8 meta tokens, ssm_state 8,
vocab 512) in float32, on the same numpy inputs and weights.

- The plain selective scan (``ref_ssm_scan``, what the CUDA kernel is held
  to on the card) against ``repro.kernels.ref.ssm_scan_ref`` at 1e-5 (the
  same recurrence; sums in another order), also continued from the h of a
  first part of the sequence, and against the Pallas kernel in interpret
  mode at zero h0 at 3e-3 (tests/test_kernels.py:125).
- ``init_ssm``, ``_causal_depthwise_conv`` and ``apply_ssm`` against JAX,
  the last over a whole sequence and over a prefill followed by single
  decode steps that carry the convolution tail and h: outputs at 1e-4.
- The windowed plain flash attention against JAX ``blockwise_attention(
  attn_type=ATTN_SWA)`` below, at and above the window at 1e-5.
- The hybrid layer, ``forward`` (meta prefix stripped; the K/V ring is JAX's
  cache rolled by S % Sc) and ``decode_step`` (where the whole context fits
  the window, so JAX's linear cache is right) against JAX at 1e-4; pad
  logits masked by ``decode_step``.
- The engine against the no-cache oracle: JAX ``forward`` on the prompt
  plus the tokens so far, greedy. The port's tokens are checked against it
  teacher-forced: one ``forward`` of the prompt and all but the last token,
  whose logits at each position are, by causality, those of the step-by-step
  oracle. Strict xfails record the reference's faults (ROADMAP §3): the JAX
  dense engine's meta-token offset and bucket padding, bucket padding alone,
  the window lost at decode, and the unmasked pad logits of its
  ``decode_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.configs.base import ATTN_SWA as JAX_ATTN_SWA
from repro.kernels import ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tfm
from repro.serving.engine import GenerationEngine as JaxEngine
from repro.serving.engine import _bucket
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import ATTN_SWA
from repro_torch.kernels.flash_attention import flash_attention, ref_flash_attention
from repro_torch.kernels.ssm_scan import ref_ssm_scan, ssm_scan
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (
    decode_step,
    dense_cache_supported,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

torch.set_num_threads(1)

REF_TOL = dict(rtol=1e-5, atol=1e-5)      # the same recurrence, other summation order
PALLAS_TOL = dict(rtol=3e-3, atol=3e-3)   # tests/test_kernels.py:125
OUT_TOL = dict(rtol=1e-4, atol=1e-4)      # two f32 stacks, other summation orders
ARCH = "hymba-1.5b"


def _scan_inputs(rng, B, S, Di, N):
    """The inputs of tests/test_kernels.py:117-122, from numpy."""
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Di)) - 2.0))     # softplus
    x = rng.standard_normal((B, S, Di))
    bm, cm = (0.5 * rng.standard_normal((B, S, N)) for _ in range(2))
    a_log = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float64), (Di, N)))
    return [a.astype(np.float32) for a in (dt, x, bm, cm, a_log)]


@pytest.mark.parametrize("B,S,Di,N,chunk", [
    (1, 64, 64, 8, 16),       # tests/test_kernels.py:111-115
    (2, 128, 128, 16, 32),
    (1, 96, 256, 16, 32),
    (2, 37, 64, 16, 32),      # odd S: the Pallas chunk halves down to 1
    (3, 1, 64, 8, 32),        # one decode step
], ids=["S64", "S128", "S96", "S37", "S1"])
def test_plain_scan_matches_ref_and_pallas(B, S, Di, N, chunk):
    dt, x, bm, cm, a_log = _scan_inputs(np.random.default_rng(S + Di), B, S, Di, N)
    t = torch.from_numpy
    y, h = ref_ssm_scan(t(dt), t(x), t(bm), t(cm), t(a_log))
    y_ref, h_ref = jax_ref.ssm_scan_ref(*map(jnp.asarray, (dt, x, bm, cm, a_log)))
    assert y.dtype == h.dtype == torch.float32 and tuple(h.shape) == (B, Di, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **REF_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **REF_TOL)
    y_p, h_p = ops.ssm_scan(*map(jnp.asarray, (dt, x, bm, cm, a_log)), chunk=chunk,
                            di_block=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_p), **PALLAS_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_p), **PALLAS_TOL)
    # the wrapper on CPU tensors is the plain version, counting no launch
    y2, h2 = ssm_scan(t(dt), t(x), t(bm), t(cm), t(a_log))
    assert ssm_scan.launches == 0
    np.testing.assert_array_equal(y2.numpy(), y.numpy())
    np.testing.assert_array_equal(h2.numpy(), h.numpy())


@pytest.mark.parametrize("S,split", [(40, 17), (9, 8), (64, 1)])
def test_plain_scan_continues_from_h0(S, split):
    """From the nonzero h of the sequence's first ``split`` steps, the rest
    of the scan gives ``ssm_scan_ref``'s y and h of the whole sequence; h
    may be updated in place."""
    dt, x, bm, cm, a_log = _scan_inputs(np.random.default_rng(S), 2, S, 32, 16)
    y_ref, h_ref = jax_ref.ssm_scan_ref(*map(jnp.asarray, (dt, x, bm, cm, a_log)))
    first = [torch.from_numpy(a[:, :split].copy()) for a in (dt, x, bm, cm)]
    rest = [torch.from_numpy(a[:, split:].copy()) for a in (dt, x, bm, cm)]
    a = torch.from_numpy(a_log)
    y1, h1 = ssm_scan(*first, a)
    assert bool(h1.abs().max() > 0)
    y2, h2 = ssm_scan(*rest, a, h1, h_out=h1)
    assert h2 is h1
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), np.asarray(y_ref), **REF_TOL)
    np.testing.assert_allclose(h1.numpy(), np.asarray(h_ref), **REF_TOL)


# ---------------------------------------------------------------------------
# the SSM branch
# ---------------------------------------------------------------------------


def _ssm_params(seed):
    """The JAX smoke model's SSM params of layer 0, as numpy, with D and
    conv_b given seeded noise so that every term counts."""
    jcfg = jax_smoke(jax_get_arch(ARCH))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jax_ssm.init_ssm(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    p["D"] = (p["D"] + 0.5 * rng.standard_normal(p["D"].shape)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(np.float32)
    return jcfg, smoke_variant(get_arch(ARCH)), p, rng


def test_init_ssm_matches_jax():
    jcfg, tcfg, jp, _ = _ssm_params(0)
    tp = ssm.init_ssm(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    assert set(tp) == set(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == leaf.shape, name
    jp = jax.tree.map(np.asarray, jax_ssm.init_ssm(jax.random.PRNGKey(0), jcfg, jnp.float32))
    for name in ("conv_b", "dt_bias", "A_log", "D"):          # the constant leaves
        np.testing.assert_allclose(tp[name].numpy(), jp[name], rtol=1e-6, err_msg=name)
    assert abs(float(tp["conv_w"].std()) - 0.1) < 0.01
    assert abs(float(tp["w_in"].std()) - 256 ** -0.5) < 3e-3
    # stacked over the layer groups, as transformer.init_layer asks
    lead = ssm.init_ssm(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu", lead=(3,))
    assert tuple(lead["A_log"].shape) == (3, 256, 8) and tuple(lead["w_x"].shape) == (3, 256, 20)


@pytest.mark.parametrize("S", [1, 5, 11])
def test_causal_depthwise_conv_matches_jax(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    tail = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for carried in (None, tail):
        jy, jt = jax_ssm._causal_depthwise_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if carried is None else jnp.asarray(carried))
        ty, tt = ssm._causal_depthwise_conv(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if carried is None else torch.from_numpy(carried))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_apply_ssm_whole_and_stepwise_match_jax():
    jcfg, tcfg, p, rng = _ssm_params(1)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    B, S, D, split = 2, 12, jcfg.d_model, 9
    x = (0.5 * rng.standard_normal((B, S, D))).astype(np.float32)
    j_out, (j_tail, j_h) = jax_ssm.apply_ssm(jp, jnp.asarray(x), jcfg)
    t_out, (t_tail, t_h) = ssm.apply_ssm(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **OUT_TOL)
    np.testing.assert_allclose(t_tail.numpy(), np.asarray(j_tail), **OUT_TOL)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), **OUT_TOL)
    # a prefill of ``split`` tokens, then one decode step at a time carrying
    # the tail and h (h updated in place), against JAX's own carry
    outs, (tail, h) = ssm.apply_ssm(tp, torch.from_numpy(x[:, :split]), tcfg)
    jo, (jtail, jh) = jax_ssm.apply_ssm(jp, jnp.asarray(x[:, :split]), jcfg)
    outs = [outs]
    for i in range(split, S):
        o, (tail, h2) = ssm.apply_ssm(tp, torch.from_numpy(x[:, i:i + 1]), tcfg,
                                      conv_tail=tail, h0=h, h_out=h)
        assert h2 is h
        outs.append(o)
        jo1, (jtail, jh) = jax_ssm.apply_ssm(jp, jnp.asarray(x[:, i:i + 1]), jcfg,
                                             conv_tail=jtail, h0=jh)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo1), **OUT_TOL)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), np.asarray(j_out), **OUT_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **OUT_TOL)
    np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), **OUT_TOL)


# ---------------------------------------------------------------------------
# sliding-window attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [13, 64, 78, 130, 256])    # 78 = 8 meta + 70 text tokens
def test_windowed_flash_matches_jax_swa(S):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 64)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_attn.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), attn_type=JAX_ATTN_SWA, window=64))
    t = torch.from_numpy
    got = attn.blockwise_attention(t(q), t(k), t(v), attn_type=ATTN_SWA, window=64)
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    np.testing.assert_array_equal(flash_attention(t(q), t(k), t(v), window=64).numpy(),
                                  got.numpy())
    assert flash_attention.launches == 0
    # no window: full causal attention, which differs once S > window
    full = ref_flash_attention(t(q), t(k), t(v))
    assert np.allclose(full.numpy(), got.numpy()) == (S <= 64)


# ---------------------------------------------------------------------------
# layers and model API
# ---------------------------------------------------------------------------


def _tree(seed):
    """The JAX smoke model's init tree as numpy, its constant leaves (gates,
    norms, D, conv_b) given seeded noise."""
    jcfg = jax_smoke(jax_get_arch(ARCH))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    blk = tree["blocks"][0]
    noise = lambda a, s: (a + s * rng.standard_normal(a.shape)).astype(np.float32)
    for name in ("gate_attn", "gate_ssm"):
        blk[name] = noise(blk[name], 0.2)
    blk["norm1"]["scale"] = noise(blk["norm1"]["scale"], 0.1)
    blk["ssm"]["D"] = noise(blk["ssm"]["D"], 0.5)
    blk["ssm"]["conv_b"] = noise(blk["ssm"]["conv_b"], 0.1)
    return jcfg, smoke_variant(get_arch(ARCH)), tree, rng


def _ring(a, S):
    """JAX's linear K/V cache (G, B, Sc, ...) of an S-token sequence as the
    port's ring: position p at slot p % Sc."""
    return np.roll(a, S % a.shape[2], axis=2)


@pytest.mark.parametrize("S", [20, 64, 90])
def test_hybrid_layer_seq_matches_jax(S):
    jcfg, tcfg, tree, rng = _tree(1)
    layer = jax.tree.map(lambda a: a[0], tree["blocks"][0])
    jp, tp = jax.tree.map(jnp.asarray, layer), params_from_numpy(tcfg, layer, "cpu")
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    kind = jax_tfm.layer_kind(jcfg, 0)
    jx, jc, _ = jax_tfm.apply_layer_seq(jcfg, kind, jp, jnp.asarray(x), jnp.asarray(pos), True)
    tx, tc, aux = tfm.apply_layer_seq(tcfg, tp, torch.from_numpy(x),
                                      tfm._rope(tcfg, torch.from_numpy(pos)))
    assert float(aux) == 0.0                              # no MoE
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **OUT_TOL)
    assert set(tc) == set(jc) == {"k", "v", "conv", "h"}
    for name in ("k", "v"):                               # (B, Sc, KVH, hd)
        assert tc[name].shape[1] == min(S, jcfg.window)
        want = np.roll(np.asarray(jc[name]), S % tc[name].shape[1], axis=1)
        np.testing.assert_allclose(tc[name].numpy(), want, **OUT_TOL)
    for name in ("conv", "h"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **OUT_TOL)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_init_params_and_bridge_match_jax():
    jshapes = dict(_leaves(jax.eval_shape(
        lambda: jax_init_params(jax_get_arch(ARCH), jax.random.PRNGKey(0)))))
    tshapes = dict(_leaves(init_params(get_arch(ARCH), torch.Generator(), "meta")))
    assert set(tshapes) == set(jshapes) and "/meta_tokens" in tshapes
    for name, leaf in jshapes.items():
        assert tuple(tshapes[name].shape) == leaf.shape, name
    small = init_params(smoke_variant(get_arch(ARCH)), torch.Generator().manual_seed(0), "cpu")
    assert abs(float(small["meta_tokens"].std()) - 0.02) < 2e-3
    assert bool((small["blocks"][0]["gate_ssm"] == 1).all())
    # the bridge carries meta_tokens and every SSM leaf
    _, tcfg, tree, _ = _tree(2)
    got, want = dict(_leaves(params_from_numpy(tcfg, tree, "cpu"))), dict(_leaves(tree))
    assert set(got) == set(want) and "/blocks/0/ssm/A_log" in got
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)


@pytest.mark.parametrize("S", [20, 70])
def test_forward_and_prefill_match_jax(S):
    jcfg, tcfg, tree, rng = _tree(3)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, "cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jl, _, jc = jax_forward(jcfg, jp, {"tokens": jnp.asarray(tokens)}, want_cache=True)
    tl, aux, tc = forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)}, want_cache=True)
    assert tuple(tl.shape) == (2, S, jcfg.padded_vocab) and float(aux) == 0.0  # meta stripped
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    total = S + jcfg.num_meta_tokens
    for name in ("k", "v"):
        assert tc[0][name].shape[2] == min(total, jcfg.window)
        np.testing.assert_allclose(tc[0][name].numpy(), _ring(np.asarray(jc[0][name]), total),
                                   **OUT_TOL)
    for name in ("conv", "h"):
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]), **OUT_TOL)
    last, _ = prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **OUT_TOL)


def test_init_cache_and_decode_step_match_jax():
    """Three decode steps after a 20-token prompt (28 positions with the
    meta tokens), on caches of 48 slots: the whole context fits the window,
    where JAX's linear cache and the port's ring are the same."""
    jcfg, tcfg, tree, rng = _tree(4)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, "cpu")
    M, B, Sc = jcfg.num_meta_tokens, 2, 48
    jzero, tzero = jax_init_cache(jcfg, B, Sc), init_cache(tcfg, B, Sc, "cpu")
    for name, a in jzero[0].items():
        assert tuple(tzero[0][name].shape) == a.shape and not tzero[0][name].any(), name
    assert tzero[0]["h"].dtype == torch.float32
    # past the window the port's ring has window slots; JAX's linear cache S
    assert init_cache(tcfg, B, 200, "cpu")[0]["k"].shape[2] == jcfg.window
    tokens = rng.integers(0, jcfg.vocab_size, (B, 20)).astype(np.int32)
    _, jc = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    _, tc = prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    jcache = ({n: jnp.asarray(_pad_slots(np.asarray(a), Sc) if n in ("k", "v") else a)
               for n, a in jc[0].items()},)
    tcache = init_cache(tcfg, B, Sc, "cpu")
    for n in ("k", "v"):
        tcache[0][n][:, :, :tc[0][n].shape[2]] = tc[0][n]
    for n in ("conv", "h"):
        tcache[0][n].copy_(tc[0][n])
    for i in range(3):
        toks1 = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B,), M + 20 + i, np.int32)
        jl, jcache = jax_decode_step(jcfg, jp, jcache, jnp.asarray(toks1), jnp.asarray(pos))
        tl, out = decode_step(tcfg, tp, tcache, torch.from_numpy(toks1), torch.from_numpy(pos))
        assert out is tcache                                  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    for n in ("k", "v", "conv", "h"):
        np.testing.assert_allclose(tcache[0][n].numpy(), np.asarray(jcache[0][n]), **OUT_TOL)


def _pad_slots(a, Sc):
    """A K/V cache (G, B, S, ...) zero-padded to Sc slots."""
    pad = [(0, 0)] * a.ndim
    pad[2] = (0, Sc - a.shape[2])
    return np.pad(a, pad)


def test_decode_step_masks_pad_logits():
    """vocab 500 pads to 512: ``decode_step`` masks the 12 pad logits, as
    ``forward`` does."""
    tcfg = smoke_variant(get_arch(ARCH)).replace(vocab_size=500)
    tp = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tp["embed"]["table"][500:] += 5.0              # pad rows that would win the argmax
    if "lm_head" in tp:
        tp["lm_head"]["w"][:, 500:] += 5.0
    cache = init_cache(tcfg, 2, 32, "cpu")
    logits, _ = decode_step(tcfg, tp, cache, torch.tensor([[3], [7]]),
                            torch.tensor([8, 9], dtype=torch.int32))
    assert tuple(logits.shape) == (2, 512)
    assert bool((logits[:, 500:] <= -1e29).all()) and bool((logits.argmax(-1) < 500).all())
    fl, _ = forward(tcfg, tp, {"tokens": torch.tensor([[3, 7]])})
    assert bool((fl[..., 500:] <= -1e29).all())


@pytest.mark.xfail(strict=True, reason="reference fault (ROADMAP §3): JAX decode_step "
                   "(models/model.py:317-330) applies no pad-vocab bias, while forward does")
def test_jax_decode_step_masks_pad_logits():
    jcfg = jax_smoke(jax_get_arch(ARCH)).replace(vocab_size=500)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    _, cache = jax_prefill(jcfg, jp, {"tokens": jnp.asarray([[3, 7]], jnp.int32)})
    logits, _ = jax_decode_step(jcfg, jp, cache, jnp.asarray([[5]], jnp.int32),
                                jnp.asarray([10], jnp.int32))
    assert bool((np.asarray(logits)[:, 500:] <= -1e29).all())


# ---------------------------------------------------------------------------
# engine against the no-cache oracle
# ---------------------------------------------------------------------------

N_NEW, MAX_SEQ = 8, 128
LENGTHS = (1, 5, 16, 40, 52, 70)   # 52 and 70 cross the 64-token window


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke(jax_get_arch(ARCH))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch(ARCH))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


def _prompts(lengths, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def oracle(weights):
    """``oracle(prompt, tokens)``: how many leading ``tokens`` are the greedy
    tokens of the model's own definition with no cache, JAX ``forward`` on
    the prompt plus the tokens so far (it strips the meta prefix and applies
    the SWA mask itself). One ``forward`` of the prompt and all but the last
    token gives, at the prompt's last position and after, the logits that
    each step of that loop would see while the tokens agree."""
    jcfg, jparams, _, _ = weights
    fwd = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t})[0])

    def agree(prompt, tokens):
        seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
        logits = np.asarray(fwd(jparams, jnp.asarray(seq[None])))[0]
        greedy = logits[len(prompt) - 1:].argmax(-1)
        same = [int(a) == int(b) for a, b in zip(greedy, tokens)]
        return same.index(False) if False in same else len(same)

    return agree


def _serve(eng, prompts, max_new=N_NEW):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run_until_done()
    assert all(r.done for r in reqs) and not any(eng.slots)
    return [r.out_tokens for r in reqs]


def test_engine_matches_no_cache_oracle(weights, oracle):
    """Six prompts through two slots (slots reused), ``backend="paged"``
    falling back; the last two cross the window while decoding (8 meta +
    52 or 70 text tokens), so their K/V rings wrap."""
    jcfg, _, tcfg, tparams = weights
    prompts = _prompts(LENGTHS, jcfg.vocab_size)
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2, max_seq=MAX_SEQ)
    st = eng.stats()
    assert (st["backend"], st["interleave"], st["kernel"]) == ("dense", False, "plain")
    assert eng.cache[0]["k"].shape[2] == jcfg.window      # min(128 + 8, 64)
    got = _serve(eng, prompts)
    assert all(len(g) == N_NEW for g in got)
    for p, g in zip(prompts, got):
        assert oracle(p, g) == N_NEW, len(p)
    assert eng.stats()["prefill_tokens"] == sum(map(len, prompts))   # unpadded


def test_engine_batch_with_idle_rows_matches_oracle(weights, oracle):
    """Four slots, five requests of different lengths and budgets: rows go
    idle (decoding token 0 at position 0) while others decode, and a freed
    row is refilled."""
    jcfg, _, tcfg, tparams = weights
    prompts = _prompts((9, 33, 3, 61, 20), jcfg.vocab_size, seed=1)
    budgets = (3, 8, 5, 8, 6)
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=4, max_seq=MAX_SEQ)
    reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run_until_done()
    for p, n, r in zip(prompts, budgets, reqs):
        assert len(r.out_tokens) == n and oracle(p, r.out_tokens) == n, len(p)


def test_engine_truncated_prompt_matches_oracle(weights, oracle):
    """A 90-token prompt on ``max_seq=64`` enters the cache truncated to 64
    tokens (72 positions with the meta tokens: the prefill ring wraps); its
    one token is the oracle's on the truncated prompt."""
    jcfg, _, tcfg, tparams = weights
    prompt = _prompts((90,), jcfg.vocab_size, seed=2)[0]
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=1, max_seq=64)
    req = eng.submit(prompt, max_new=4)
    eng.run_until_done()
    assert req.truncated and req.pos == 64 and len(req.out_tokens) == 1
    assert oracle(prompt[:64], req.out_tokens) == 1
    assert dense_cache_supported(tcfg)


@pytest.mark.xfail(strict=True, reason="reference faults (ROADMAP §3): the JAX dense engine "
                   "resumes decode at the text position, not after the meta tokens, and pads "
                   "the prompt to its bucket inside the SSM state")
@pytest.mark.parametrize("Lp", [5, 16, 23, 70])
def test_jax_dense_engine_matches_no_cache_oracle(weights, oracle, Lp):
    jcfg, jparams, _, _ = weights
    prompt = _prompts((Lp,), jcfg.vocab_size, seed=3)[0]
    jeng = JaxEngine(jcfg, params=jparams, backend="dense", max_batch=2, max_seq=MAX_SEQ)
    agree = oracle(prompt, _serve(jeng, [prompt])[0])
    assert agree == N_NEW, f"Lp {Lp}: the first {agree} of {N_NEW} greedy tokens agree"


def _jax_decode(weights, logits_at, cache, first_pos):
    """Greedy tokens from a JAX prefill's logits and cache (K/V padded to 256
    slots), decoding at absolute positions ``first_pos``, +1, ..."""
    jcfg, jparams, _, _ = weights
    dec = jax.jit(lambda p, c, t, pos: jax_decode_step(jcfg, p, c, t, pos))
    cache = ({n: jnp.asarray(_pad_slots(np.asarray(a), 256)) if n in ("k", "v") else a
              for n, a in cache[0].items()},)
    out = [int(np.argmax(np.asarray(logits_at)))]
    for i in range(N_NEW - 1):
        logits, cache = dec(jparams, cache, jnp.asarray([[out[-1]]], jnp.int32),
                            jnp.asarray([first_pos + i], jnp.int32))
        out.append(int(np.argmax(np.asarray(logits)[0])))
    return out


@pytest.mark.xfail(strict=True, reason="reference fault (ROADMAP §3): a prompt padded to its "
                   "bucket leaves the pad tokens in the SSM state and conv tail "
                   "(models/ssm.py:37, :97), even at the right decode positions")
@pytest.mark.parametrize("Lp", [5, 23])
def test_jax_bucket_padded_prefill_matches_no_cache_oracle(weights, oracle, Lp):
    jcfg, jparams, _, _ = weights
    prompt = _prompts((Lp,), jcfg.vocab_size, seed=3)[0]
    toks = np.zeros((1, _bucket(Lp)), np.int32)
    toks[0, :Lp] = prompt
    logits, _, cache = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, want_cache=True)
    assert jcfg.num_meta_tokens + toks.shape[1] + N_NEW <= jcfg.window   # no window fault
    out = _jax_decode(weights, logits[0, Lp - 1], cache, jcfg.num_meta_tokens + Lp)
    agree = oracle(prompt, out)
    assert agree == N_NEW, f"Lp {Lp}: the first {agree} of {N_NEW} greedy tokens agree"


@pytest.mark.xfail(strict=True, reason="reference fault (ROADMAP §3): a hybrid layer's JAX "
                   "cache is linear and max_seq long, so decode past the window neither keeps "
                   "the window's keys in ring order nor narrows its mask to the window")
@pytest.mark.parametrize("Lp", [70])
def test_jax_unpadded_prefill_past_the_window_matches_no_cache_oracle(weights, oracle, Lp):
    jcfg, jparams, _, _ = weights
    prompt = _prompts((Lp,), jcfg.vocab_size, seed=3)[0]
    logits, cache = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt[None])})
    out = _jax_decode(weights, logits[0], cache, jcfg.num_meta_tokens + Lp)
    agree = oracle(prompt, out)
    assert agree == N_NEW, f"Lp {Lp}: the first {agree} of {N_NEW} greedy tokens agree"


def test_jax_unpadded_prefill_within_the_window_matches_no_cache_oracle(weights, oracle):
    """The control of the three xfails above: unpadded, at the right
    positions and inside the window, JAX's own functions give the oracle's
    tokens."""
    jcfg, jparams, _, _ = weights
    prompt = _prompts((23,), jcfg.vocab_size, seed=3)[0]
    logits, cache = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt[None])})
    out = _jax_decode(weights, logits[0], cache, jcfg.num_meta_tokens + 23)
    assert oracle(prompt, out) == N_NEW


def test_launcher_serves_hymba_smoke_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n-requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "hymba-1.5b-smoke: device=cpu backend=dense mode=sync kernel=plain" in out
    assert out.count("4 tokens") == 3
