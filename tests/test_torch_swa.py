"""Sliding-window stacks on the port's dense backend against the JAX package
on the CPU: qwen2.5-3b-swa (dense SwiGLU) and mixtral-8x22b (the same
window with MoE layers), smoke width (2 layers, d 256, window 64; mixtral 4
experts, top-2) in float32, on the same numpy inputs and weights.

- A sliding-window layer over a sequence against JAX ``apply_layer_seq``
  below, at and past the window: x at ``OUT_TOL`` (two float32 stacks in
  other summation orders), its K/V ring JAX's cache rolled by S % Sc.
- ``forward`` (logits, the ring, the MoE aux loss summed over the layers),
  ``prefill``, ``init_cache`` and ``decode_step`` against JAX below the
  window; and past it, JAX ``decode_step`` on the port's ring (rolled into
  ring order) against the port's ``decode_step``, steps that wrap the ring
  included.
- The engine: the port's dense backend against the JAX dense engine where
  the reference is right (Lp 5, 23, 40, ``max_seq=128``), and against the
  no-cache oracle (JAX ``forward`` on the prompt plus the tokens so far,
  teacher-forced as ``tests/test_torch_hymba.py::oracle``) at every tested
  Lp, 60-100 wrapping the ring; Lp + 8 <= 256, so the MoE is dropless on
  both sides. Strict xfails show the reference's fault past the window
  (ROADMAP §3, reference entry 4): the JAX dense engine keeps the window's
  keys in linear order where the ring needs them rolled.
- ``serve_real(..., smoke=True, device="cpu")`` for both archs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.configs.base import ATTN_SWA as JAX_ATTN_SWA
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tfm
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (
    decode_step,
    dense_cache_supported,
    forward,
    init_cache,
    prefill,
    prefills_unpadded,
)
from repro_torch.configs.base import ATTN_SWA
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

torch.set_num_threads(1)

OUT_TOL = dict(rtol=1e-4, atol=1e-4)      # two f32 stacks, other summation orders
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
ARCHS = ("qwen2.5-3b-swa", "mixtral-8x22b")


def _tree(arch, seed):
    """The JAX smoke model's init tree as numpy, QKV biases (qwen) and the
    norm scales given seeded noise (JAX initialises them to constants,
    which would hide those paths)."""
    jcfg = jax_smoke(jax_get_arch(arch))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    blk = tree["blocks"][0]
    for name in ("bq", "bk", "bv"):
        if name in blk["attn"]:
            blk["attn"][name] = (0.5 * rng.standard_normal(blk["attn"][name].shape)
                                 ).astype(np.float32)
    for norm in ("norm1", "norm2"):
        blk[norm]["scale"] = (blk[norm]["scale"]
                              + 0.1 * rng.standard_normal(blk[norm]["scale"].shape)
                              ).astype(np.float32)
    return jcfg, smoke_variant(get_arch(arch)), tree, rng


def _ring(a, S, axis):
    """JAX's linear K/V cache of an S-token sequence as the port's ring:
    position p at slot p % Sc."""
    return np.roll(a, S % a.shape[axis], axis=axis)


def test_configs_match_jax():
    for arch in ARCHS:
        full, jfull = get_arch(arch), jax_get_arch(arch)
        small, jsmall = smoke_variant(full), jax_smoke(jfull)
        for t, j in ((full, jfull), (small, jsmall)):
            for name in ("name", "num_layers", "d_model", "num_heads", "num_kv_heads",
                         "head_dim", "d_ff", "vocab_size", "attn_type", "window",
                         "num_experts", "num_experts_per_tok", "qkv_bias", "rope_theta"):
                assert getattr(t, name) == getattr(j, name), (arch, name)
        assert dense_cache_supported(full) and prefills_unpadded(full)
    assert (smoke_variant(get_arch("mixtral-8x22b")).window,
            smoke_variant(get_arch("mixtral-8x22b")).num_experts) == (64, 4)


@pytest.mark.parametrize("Sc", [1, 24, 64])
def test_decode_lengths_are_the_swa_ring_mask(Sc):
    """For every position up to three wraps of the ring, the decode stacks'
    ``lengths = min(pos + 1, Sc)`` is JAX's SWA ``cache_validity`` mask,
    and the port's ``cache_validity`` gives it too."""
    pos = np.arange(3 * Sc + 2, dtype=np.int32)
    want = np.asarray(jax_attn.cache_validity(JAX_ATTN_SWA, Sc, jnp.asarray(pos)))
    lengths = np.minimum(pos + 1, Sc)
    np.testing.assert_array_equal(np.arange(Sc)[None] < lengths[:, None], want)
    np.testing.assert_array_equal(
        attn.cache_validity(ATTN_SWA, Sc, torch.from_numpy(pos)).numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [20, 64, 90])
def test_swa_layer_seq_matches_jax(arch, S):
    jcfg, tcfg, tree, rng = _tree(arch, 1)
    layer = jax.tree.map(lambda a: a[0], tree["blocks"][0])
    jp, tp = jax.tree.map(jnp.asarray, layer), params_from_numpy(tcfg, layer, "cpu")
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    kind = jax_tfm.layer_kind(jcfg, 0)
    jx, jc, jaux = jax_tfm.apply_layer_seq(jcfg, kind, jp, jnp.asarray(x), jnp.asarray(pos),
                                           True)
    tx, tc, taux = tfm.apply_layer_seq(tcfg, tp, torch.from_numpy(x),
                                       tfm._rope(tcfg, torch.from_numpy(pos)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **OUT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)
    assert set(tc) == set(jc) == {"k", "v"}
    for name in ("k", "v"):                               # (B, Sc, KVH, hd)
        assert tc[name].shape[1] == min(S, jcfg.window)
        np.testing.assert_allclose(tc[name].numpy(), _ring(np.asarray(jc[name]), S, 1),
                                   **OUT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [21, 60])
def test_forward_and_prefill_match_jax(arch, S):
    jcfg, tcfg, tree, rng = _tree(arch, 3)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, "cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jl, jaux, jc = jax_forward(jcfg, jp, {"tokens": jnp.asarray(tokens)}, want_cache=True)
    tl, taux, tc = forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)}, want_cache=True)
    assert tuple(tl.shape) == (2, S, jcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)
    assert (float(taux) > 0) == tcfg.is_moe              # the sum over the layers
    for name in ("k", "v"):
        assert tuple(tc[0][name].shape) == jc[0][name].shape   # S < window: no wrap
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]), **OUT_TOL)
    last, pc = prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **OUT_TOL)
    np.testing.assert_allclose(pc[0]["k"].numpy(), np.asarray(jc[0]["k"]), **OUT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_decode_step_match_jax(arch):
    """Three decode steps after a 20-token prompt on 48-slot caches: the
    context fits the window, where JAX's cache and the port's ring are the
    same."""
    jcfg, tcfg, tree, rng = _tree(arch, 4)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, "cpu")
    B, Sc = 2, 48
    jzero, tzero = jax_init_cache(jcfg, B, Sc), init_cache(tcfg, B, Sc, "cpu")
    assert set(tzero[0]) == set(jzero[0]) == {"k", "v"}
    for name, a in jzero[0].items():
        assert tuple(tzero[0][name].shape) == a.shape and not tzero[0][name].any(), name
    # past the window the ring has window slots, as JAX's cache_len_for
    assert init_cache(tcfg, B, 200, "cpu")[0]["k"].shape[2] == \
        jax_init_cache(jcfg, B, 200)[0]["k"].shape[2] == jcfg.window
    tokens = rng.integers(0, jcfg.vocab_size, (B, 20)).astype(np.int32)
    _, jc = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    _, tc = prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    jcache = ({n: jnp.zeros_like(jzero[0][n]).at[:, :, :20].set(a) for n, a in jc[0].items()},)
    tcache = init_cache(tcfg, B, Sc, "cpu")
    for n in ("k", "v"):
        tcache[0][n][:, :, :20] = tc[0][n]
    for i in range(3):
        toks1 = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B,), 20 + i, np.int32)
        jl, jcache = jax_decode_step(jcfg, jp, jcache, jnp.asarray(toks1), jnp.asarray(pos))
        tl, out = decode_step(tcfg, tp, tcache, torch.from_numpy(toks1), torch.from_numpy(pos))
        assert out is tcache                                  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[0][n].numpy(), np.asarray(jcache[0][n]), **OUT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [64, 90])
def test_ring_decode_past_the_window_matches_jax(arch, S):
    """A prompt of S >= window tokens: the port's prefill ring is JAX's
    cache rolled by S % Sc, and JAX ``decode_step`` on that ring (its
    ``_cache_update`` writes at pos % Sc and ``cache_validity`` opens every
    slot once wrapped) gives the port's logits and ring, step after step."""
    jcfg, tcfg, tree, rng = _tree(arch, 5)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, "cpu")
    B = 2
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    _, jc = jax_prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    _, tc = prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    for n in ("k", "v"):
        assert tc[0][n].shape[2] == jcfg.window
        np.testing.assert_allclose(tc[0][n].numpy(), _ring(np.asarray(jc[0][n]), S, 2),
                                   **OUT_TOL)
    jcache = ({n: jnp.asarray(tc[0][n].numpy()) for n in ("k", "v")},)
    for i in range(4):
        toks1 = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + i, np.int32)
        jl, jcache = jax_decode_step(jcfg, jp, jcache, jnp.asarray(toks1), jnp.asarray(pos))
        tl, _ = decode_step(tcfg, tp, tc, torch.from_numpy(toks1), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[0][n].numpy(), np.asarray(jcache[0][n]), **OUT_TOL)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

N_NEW, MAX_SEQ = 8, 128
ORACLE_LENGTHS = (5, 23, 40, 60, 64, 70, 100)   # 60 and 64 wrap while decoding, 70 and
JAX_RIGHT = (5, 23, 40)                         # 100 at the prefill


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    arch = request.param
    jcfg = jax_smoke(jax_get_arch(arch))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch(arch))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


def _prompts(lengths, vocab, seed=3):
    """Prompts drawn in turn from one generator (ROADMAP §3 entry 4's input)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def oracle(weights):
    """``oracle(prompt, tokens)``: how many leading ``tokens`` are the greedy
    tokens of JAX ``forward`` on the prompt plus the tokens so far (the
    model's own definition: the SWA mask over the whole sequence, no
    cache), taken teacher-forced from one ``forward`` of the prompt and all
    but the last token."""
    jcfg, jparams, _, _ = weights
    fwd = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t})[0])

    def agree(prompt, tokens):
        seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
        assert len(seq) <= 256                     # the MoE stays dropless
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
    """Seven prompts through two slots (slots reused), ``backend="paged"``
    falling back: 60 and 64 tokens wrap the 64-slot ring while decoding, 70
    and 100 at the prefill (S % window != 0)."""
    jcfg, _, tcfg, tparams = weights
    prompts = _prompts(ORACLE_LENGTHS, jcfg.vocab_size)
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2, max_seq=MAX_SEQ)
    st = eng.stats()
    assert (st["backend"], st["interleave"], st["kernel"]) == ("dense", False, "plain")
    assert eng.cache[0]["k"].shape[2] == jcfg.window          # min(128, 64)
    got = _serve(eng, prompts)
    assert all(len(g) == N_NEW for g in got)
    for p, g in zip(prompts, got):
        assert oracle(p, g) == N_NEW, len(p)
    assert eng.stats()["prefill_tokens"] == sum(map(len, prompts))   # unpadded


def test_engine_batch_with_idle_rows_and_truncation_match_oracle(weights, oracle):
    """Four slots, five requests of different lengths and budgets (rows go
    idle and are refilled), then a 90-token prompt truncated to
    ``max_seq=80`` (its 80-token prefill wraps the ring)."""
    jcfg, _, tcfg, tparams = weights
    prompts = _prompts((9, 33, 3, 61, 20), jcfg.vocab_size, seed=1)
    budgets = (3, 8, 5, 8, 6)
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=4, max_seq=MAX_SEQ)
    reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run_until_done()
    for p, n, r in zip(prompts, budgets, reqs):
        assert len(r.out_tokens) == n and oracle(p, r.out_tokens) == n, len(p)
    prompt = _prompts((90,), jcfg.vocab_size, seed=2)[0]
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=1, max_seq=80)
    req = eng.submit(prompt, max_new=4)
    eng.run_until_done()
    assert req.truncated and req.pos == 80 and len(req.out_tokens) == 1
    assert oracle(prompt[:80], req.out_tokens) == 1


@pytest.mark.parametrize("Lp", JAX_RIGHT)
def test_engine_matches_jax_dense_engine(weights, Lp):
    """Where the reference is right (the prompt and its decode stay inside
    the window), the port's engine gives the JAX dense engine's tokens."""
    jcfg, jparams, tcfg, tparams = weights
    prompt = _prompts((Lp,), jcfg.vocab_size)[0]
    jeng = JaxEngine(jcfg, params=jparams, backend="dense", max_batch=2, max_seq=MAX_SEQ)
    teng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2, max_seq=MAX_SEQ)
    assert _serve(teng, [prompt]) == _serve(jeng, [prompt])
    assert teng.steps == jeng.steps


@pytest.mark.xfail(strict=True, reason="reference fault (ROADMAP §3, reference entry 4): the "
                   "JAX dense engine pads the prompt to a bucket longer than the window and "
                   "keeps the ring's last keys in linear order (models/transformer.py:151-153), "
                   "where decode writes at pos % window")
@pytest.mark.parametrize("Lp", [70, 100])
def test_jax_dense_engine_matches_no_cache_oracle(weights, oracle, Lp):
    jcfg, jparams, _, _ = weights
    prompt = _prompts((Lp,), jcfg.vocab_size)[0]
    jeng = JaxEngine(jcfg, params=jparams, backend="dense", max_batch=2, max_seq=MAX_SEQ)
    agree = oracle(prompt, _serve(jeng, [prompt])[0])
    assert agree == N_NEW, f"Lp {Lp}: the first {agree} of {N_NEW} greedy tokens agree"


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_smoke_on_cpu(capsys, arch):
    serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--n-requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke: device=cpu backend=dense mode=sync kernel=plain" in out
    assert out.count("4 tokens") == 3
