"""llama4-scout-17b-a16e on the port's dense backend against the JAX package
on the CPU, at smoke width (2 layers of period 2: a chunked-local layer,
then a global one; d 256, chunk 64, 4 experts top-1 with a shared expert,
vocab 512) in float32, on the same numpy inputs and weights (JAX
``init_params`` through ``params_from_numpy``).

The JAX package is not right everywhere here (ROADMAP §3, reference entries
5-7), so the oracle of most checks is the chunk-aware one: JAX ``forward``
with ``repro.models.attention.blockwise_attention`` replaced, in this test
process only (pytest's ``MonkeyPatch``), by ``chunk_aware``, which cuts q,
k and v at the chunk boundaries and runs JAX's own full-causal
``blockwise_attention`` on each piece: the arm JAX itself takes where S %
chunk == 0. Nothing of the JAX package changes.

- The configs, the period-2 and period-2 G = 2 params trees, the plain
  chunked flash (``ref_flash_attention(chunk=...)``) against JAX
  ``blockwise_attention`` where JAX is right and against the chunk-aware
  pieces where it is not, ``cache_validity`` against JAX bit for bit and
  the decode stacks' ``lengths`` as its mask.
- A layer of each kind, ``forward`` and ``decode_step`` against JAX where
  JAX is right; past the chunk, the port's prefill against the chunk-aware
  oracle and JAX ``decode_step`` (right on any ring) on the port's caches.
- The engine against the chunk-aware no-cache oracle (teacher-forced, as
  ``tests/test_torch_swa.py::oracle``) at Lp 5-200 through two reused slots,
  idle rows, a truncated prompt; the launcher.
- Strict xfails hold the reference's three faults (entries 5-7) and must
  stay XFAIL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.configs.base import ATTN_CHUNKED_LOCAL as JAX_CHUNKED
from repro.configs.base import ATTN_FULL as JAX_FULL
from repro.models import attention as jax_attn
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import transformer as jax_tfm
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import ATTN_CHUNKED_LOCAL, ATTN_FULL
from repro_torch.kernels.flash_attention import flash_attention, ref_flash_attention
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

ARCH = "llama4-scout-17b-a16e"
CHUNK = 64                                  # the smoke variant's chunk
OUT_TOL = dict(rtol=1e-4, atol=1e-4)        # two f32 stacks, other summation orders
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = 1e-6                           # the patched forward where JAX is right
JAX_RIGHT_S = (40, 64, 128, 256)            # S <= chunk or S % chunk == 0
JAX_WRONG_S = (96, 100, 200, 600)


_jax_blockwise = jax_attn.blockwise_attention


def chunk_aware(q, k, v, *, attn_type=JAX_FULL, window=0, chunk=0, causal=True,
                block_q=512, scale=None):
    """JAX ``blockwise_attention`` with its chunked arm taken the way JAX
    takes it where S % chunk == 0: q, k and v cut at the chunk boundaries,
    full-causal ``blockwise_attention`` on each piece, concatenated."""
    S = q.shape[1]
    if attn_type != JAX_CHUNKED or not chunk or S <= chunk:
        return _jax_blockwise(q, k, v, attn_type=attn_type, window=window, chunk=chunk,
                              causal=causal, block_q=block_q, scale=scale)
    return jnp.concatenate(
        [_jax_blockwise(q[:, s:s + chunk], k[:, s:s + chunk], v[:, s:s + chunk],
                        attn_type=JAX_FULL, causal=causal, block_q=block_q, scale=scale)
         for s in range(0, S, chunk)], axis=1)


def _qkv(S, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, n, 16)).astype(np.float32) for n in (4, 2, 2)]


def _ring(a, S, axis):
    """JAX's linear K/V cache of an S-token sequence as the port's ring:
    position p at slot p % Sc."""
    return np.roll(a, S % a.shape[axis], axis=axis)


def test_configs_match_jax():
    full, jfull = get_arch(ARCH), jax_get_arch(ARCH)
    small, jsmall = smoke_variant(full), jax_smoke(jfull)
    for t, j in ((full, jfull), (small, jsmall)):
        for name in ("name", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
                     "d_ff", "vocab_size", "attn_type", "chunk_size", "global_layer_every",
                     "num_experts", "num_experts_per_tok", "n_shared_experts",
                     "moe_layer_every", "rope_theta", "use_rope", "padded_vocab"):
            assert getattr(t, name) == getattr(j, name), name
        assert [t.layer_attn_type(i) for i in range(8)] == \
            [j.layer_attn_type(i) for i in range(8)]
    assert (tfm.period(full), tfm.period(small)) == (4, 2)
    assert full.padded_vocab == 202112
    assert [tfm.layer_kind(full, i)["attn_type"] for i in range(4)] == \
        [ATTN_CHUNKED_LOCAL] * 3 + [ATTN_FULL]
    for cfg in (full, small):
        assert dense_cache_supported(cfg) and prefills_unpadded(cfg)
        assert not paged_cache_supported(cfg)


@pytest.mark.parametrize("num_layers", [2, 4])
def test_params_tree_matches_jax(num_layers):
    """The period-2 stack as JAX stacks it: a list of two trees (the chunked
    position, then the global one) whose leaves lead with G = L / 2; the
    port's ``init_params`` gives JAX's keys and shapes, and the JAX tree
    converts leaf for leaf."""
    jcfg = jax_smoke(jax_get_arch(ARCH)).replace(num_layers=num_layers)
    tcfg = smoke_variant(get_arch(ARCH)).replace(num_layers=num_layers)
    jtree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    ttree = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    conv = params_from_numpy(tcfg, jtree, "cpu")
    assert len(ttree["blocks"]) == len(jtree["blocks"]) == 2
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    for tree in (ttree, conv):
        tl = jax.tree_util.tree_leaves_with_path(tree)
        assert [jax.tree_util.keystr(p) for p, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
        assert [tuple(x.shape) for _, x in tl] == [x.shape for _, x in jl]
    for blk in ttree["blocks"]:
        assert blk["moe"]["w_gate"].shape == (num_layers // 2, 4, 256, 512)
        assert blk["moe"]["shared"]["w_gate"].shape == (num_layers // 2, 256, 512)


@pytest.mark.parametrize("S", JAX_RIGHT_S)
def test_chunked_flash_matches_jax_where_jax_is_right(S):
    q, k, v = _qkv(S)
    want = np.asarray(jax_attn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                                   attn_type=JAX_CHUNKED, chunk=CHUNK))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = ref_flash_attention(*t, chunk=CHUNK).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)
    np.testing.assert_array_equal(flash_attention(*t, chunk=CHUNK).numpy(), got)
    np.testing.assert_array_equal(
        attn.blockwise_attention(*t, attn_type=ATTN_CHUNKED_LOCAL, chunk=CHUNK).numpy(), got)
    np.testing.assert_allclose(np.asarray(chunk_aware(*map(jnp.asarray, (q, k, v)),
                                                      attn_type=JAX_CHUNKED, chunk=CHUNK)),
                               want, rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.mark.parametrize("S", JAX_WRONG_S)
def test_chunked_flash_matches_the_chunk_aware_pieces(S):
    """Past the chunk at S % chunk != 0 the port keeps the model's mask
    (``kpos // chunk == qpos // chunk``, causal): the chunk-aware pieces,
    and a plain masked softmax over the whole sequence."""
    q, k, v = _qkv(S)
    want = np.asarray(chunk_aware(*map(jnp.asarray, (q, k, v)), attn_type=JAX_CHUNKED,
                                  chunk=CHUNK))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = ref_flash_attention(*t, chunk=CHUNK)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    # the same mask spelt out: keys at or before the query, in its chunk
    i = torch.arange(S)
    mask = (i[None] <= i[:, None]) & (i[None] // CHUNK == i[:, None] // CHUNK)
    s = torch.einsum("bqkgh,bskh->bkgqs", t[0].reshape(1, S, 2, 2, 16), t[1]) / 4.0
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    plain = torch.einsum("bkgqs,bskh->bqkgh", p, t[2]).reshape(1, S, 4, 16)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **ATTN_TOL)


def test_window_and_chunk_together_are_refused():
    q, k, v = (torch.from_numpy(x) for x in _qkv(8))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=4, chunk=4)


@pytest.mark.parametrize("Sc,chunk", [(64, 64), (24, 64), (1, 1), (37, 37), (24, 8)])
def test_cache_validity_matches_jax_and_the_decode_lengths(Sc, chunk):
    """The chunked arm of ``cache_validity`` is JAX's bit for bit, on rings
    as the port sizes them (Sc = min(S, chunk)) and beyond (24 slots, chunk
    8); on the port's rings (Sc = chunk at any pos, Sc < chunk at pos < Sc)
    the decode stacks' ``lengths = pos % chunk + 1`` give the same mask."""
    pos = np.arange(3 * max(Sc, chunk) + 2, dtype=np.int32)
    want = np.asarray(jax_attn.cache_validity(JAX_CHUNKED, Sc, jnp.asarray(pos), chunk))
    got = attn.cache_validity(ATTN_CHUNKED_LOCAL, Sc, torch.from_numpy(pos), chunk).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        attn.cache_validity(ATTN_CHUNKED_LOCAL, Sc, torch.tensor(5), chunk).numpy(),
        np.asarray(jax_attn.cache_validity(JAX_CHUNKED, Sc, jnp.asarray(5), chunk)))
    if Sc > chunk:
        return
    cfg = smoke_variant(get_arch(ARCH)).replace(chunk_size=chunk)
    on_ring = pos if Sc == chunk else pos[pos < Sc]
    lengths = tfm.decode_lengths(cfg, {"attn_type": ATTN_CHUNKED_LOCAL}, Sc,
                                 torch.from_numpy(on_ring)).numpy()
    np.testing.assert_array_equal(np.arange(Sc)[None] < lengths[:, None],
                                  want[pos.searchsorted(on_ring)])


# ---------------------------------------------------------------------------
# layers and the model API
# ---------------------------------------------------------------------------


def _tree(seed):
    """The JAX smoke model's init tree as numpy, the norm scales given seeded
    noise (JAX initialises them to ones, which would hide those paths)."""
    jcfg = jax_smoke(jax_get_arch(ARCH))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    for blk in tree["blocks"]:
        for norm in ("norm1", "norm2"):
            blk[norm]["scale"] = (blk[norm]["scale"]
                                  + 0.1 * rng.standard_normal(blk[norm]["scale"].shape)
                                  ).astype(np.float32)
    return jcfg, smoke_variant(get_arch(ARCH)), tree, rng


@pytest.mark.parametrize("pos_in_period", [0, 1], ids=["chunked", "global"])
@pytest.mark.parametrize("S", [20, 64, 128])
def test_layer_seq_matches_jax(pos_in_period, S):
    jcfg, tcfg, tree, rng = _tree(1)
    layer = jax.tree.map(lambda a: a[0], tree["blocks"][pos_in_period])
    jp, tp = jax.tree.map(jnp.asarray, layer), params_from_numpy(tcfg, layer, "cpu")
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jkind, tkind = jax_tfm.layer_kind(jcfg, pos_in_period), tfm.layer_kind(tcfg, pos_in_period)
    assert jkind == tkind
    jx, jc, jaux = jax_tfm.apply_layer_seq(jcfg, jkind, jp, jnp.asarray(x), jnp.asarray(pos),
                                           True)
    tx, tc, taux = tfm.apply_layer_seq(tcfg, tp, torch.from_numpy(x),
                                       tfm._rope(tcfg, torch.from_numpy(pos)), tkind)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **OUT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)
    for name in ("k", "v"):
        Sc = jax_tfm.cache_len_for(jcfg, jkind, S)
        assert tc[name].shape[1] == Sc == tfm.cache_len_for(tcfg, tkind, S)
        np.testing.assert_allclose(tc[name].numpy(), _ring(np.asarray(jc[name]), S, 1),
                                   **OUT_TOL)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke(jax_get_arch(ARCH))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = smoke_variant(get_arch(ARCH))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


@pytest.fixture(scope="module")
def chunk_aware_forward(weights):
    """``fwd(tokens (B, S))``: the chunk-aware oracle's logits, JAX
    ``forward`` traced with ``chunk_aware`` in place of
    ``blockwise_attention`` (patched while each call traces and runs)."""
    jcfg, jparams, _, _ = weights
    jitted = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, want_cache=True))

    def fwd(tokens):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_attn, "blockwise_attention", chunk_aware)
            logits, aux, caches = jitted(jparams, jnp.asarray(tokens))
        return np.asarray(logits), float(aux), jax.tree.map(np.asarray, caches)

    return fwd


@pytest.mark.parametrize("S", [40, 128])
def test_chunk_aware_oracle_is_jax_forward_where_jax_is_right(weights, chunk_aware_forward, S):
    jcfg, jparams, _, _ = weights
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    logits, aux, caches = chunk_aware_forward(tokens)
    jl, jaux, jc = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, want_cache=True)
    np.testing.assert_allclose(logits, np.asarray(jl), rtol=ORACLE_TOL, atol=ORACLE_TOL)
    np.testing.assert_allclose(aux, float(jaux), rtol=ORACLE_TOL)
    for a, b in zip(jax.tree.leaves(caches), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.mark.parametrize("S", [21, 40, 64, 100, 128, 150])
def test_forward_matches_the_chunk_aware_oracle(weights, chunk_aware_forward, S):
    """Logits, the MoE aux loss summed over the layers, and the caches: the
    chunked layer's ring of min(S, 64) slots (JAX's last keys rolled by S %
    64), the global layer's S slots; ``prefill`` gives the last logits."""
    jcfg, _, tcfg, tparams = weights
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    want, waux, wc = chunk_aware_forward(tokens)
    tl, taux, tc = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, want_cache=True)
    np.testing.assert_allclose(tl.numpy(), want, **OUT_TOL)
    np.testing.assert_allclose(float(taux), waux, rtol=1e-5, atol=1e-6)
    assert len(tc) == 2 and float(taux) > 0
    for i in range(2):
        for name in ("k", "v"):
            assert tuple(tc[i][name].shape) == wc[i][name].shape      # (G, B, Sc, KVH, hd)
            np.testing.assert_allclose(tc[i][name].numpy(), _ring(wc[i][name], S, 2), **OUT_TOL)
    assert tc[0]["k"].shape[2] == min(S, CHUNK) and tc[1]["k"].shape[2] == S
    last, _ = prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), want[:, -1], **OUT_TOL)


def test_init_cache_matches_jax(weights):
    jcfg, _, tcfg, _ = weights
    for S in (48, 200):
        jz, tz = jax_init_cache(jcfg, 3, S), init_cache(tcfg, 3, S, "cpu")
        assert len(tz) == len(jz) == 2
        for je, te in zip(jz, tz):
            assert set(te) == set(je) == {"k", "v"}
            for name, a in je.items():
                assert tuple(te[name].shape) == a.shape and not te[name].any()
        assert tz[0]["k"].shape[2] == min(S, CHUNK) and tz[1]["k"].shape[2] == S


@pytest.mark.parametrize("S", [40, 128, 100, 150])
def test_decode_step_matches_jax_decode_step(weights, S):
    """A prompt of S tokens, prefilled by the port (held to the chunk-aware
    oracle above), its caches copied into caches of S + 8 slots (the chunk
    ring: min(S + 8, 64) slots), then four decode steps: JAX
    ``decode_step`` (its ``_cache_update`` writes at pos % Sc and its
    ``cache_validity`` keeps the query's chunk, right on any ring) on the
    same caches gives the port's logits and caches step for step; at S =
    128 the chunk ring starts a new chunk at the first step."""
    jcfg, jparams, tcfg, tparams = weights
    rng = np.random.default_rng(S + 1)
    B = 2
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    _, pc = prefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    tcache = init_cache(tcfg, B, S + 8, "cpu")
    for e, pe in zip(tcache, pc):
        for n in ("k", "v"):
            e[n][:, :, :pe[n].shape[2]] = pe[n]
    jcache = tuple({n: jnp.asarray(a.numpy()) for n, a in e.items()} for e in tcache)
    for i in range(4):
        toks1 = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + i, np.int32)
        jl, jcache = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(toks1), jnp.asarray(pos))
        tl, out = decode_step(tcfg, tparams, tcache, torch.from_numpy(toks1),
                              torch.from_numpy(pos))
        assert out is tcache                                  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    for je, te in zip(jcache, tcache):
        for n in ("k", "v"):
            np.testing.assert_allclose(te[n].numpy(), np.asarray(je[n]), **OUT_TOL)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

N_NEW, MAX_SEQ = 8, 256
ORACLE_LENGTHS = (5, 40, 60, 64, 100, 128, 150, 200)   # 60 crosses the chunk while decoding


def _prompts(lengths, vocab, seed=3):
    """Prompts drawn in turn from one generator (ROADMAP §3 entries 6-7)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def oracle(weights):
    """``oracle(prompt, tokens)``: how many leading ``tokens`` are the greedy
    tokens of the chunk-aware no-cache oracle on the prompt plus the tokens
    so far, teacher-forced from one forward of the prompt and all but the
    last token (its logits at each position are, by causality, those of the
    step-by-step oracle). Lp + 8 <= 256: the MoE is dropless on both
    sides."""
    jcfg, jparams, _, _ = weights
    fwd = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t})[0])

    def agree(prompt, tokens):
        seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
        assert len(seq) <= 256
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_attn, "blockwise_attention", chunk_aware)
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


def test_engine_matches_the_chunk_aware_oracle(weights, oracle):
    """Eight prompts through two slots (slots reused), ``backend="paged"``
    falling back to the dense backend: prompts short of, at, and past the
    chunk, at and off multiples of it; each prefilled at its own length."""
    jcfg, _, tcfg, tparams = weights
    prompts = _prompts(ORACLE_LENGTHS, jcfg.vocab_size)
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=2, max_seq=MAX_SEQ)
    st = eng.stats()
    assert (st["backend"], st["interleave"], st["kernel"]) == ("dense", False, "plain")
    assert [e["k"].shape[2] for e in eng.cache] == [CHUNK, MAX_SEQ]
    got = _serve(eng, prompts)
    assert all(len(g) == N_NEW for g in got)
    for p, g in zip(prompts, got):
        assert oracle(p, g) == N_NEW, len(p)
    assert eng.stats()["prefill_tokens"] == sum(map(len, prompts))   # unpadded


def test_engine_batch_with_idle_rows_and_truncation_match_oracle(weights, oracle):
    """Four slots, five requests of different lengths and budgets (rows go
    idle and are refilled), then a 150-token prompt truncated to
    ``max_seq=100`` (its 100-token prefill is past the chunk)."""
    jcfg, _, tcfg, tparams = weights
    prompts = _prompts((9, 70, 3, 130, 20), jcfg.vocab_size, seed=1)
    budgets = (3, 8, 5, 8, 6)
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=4, max_seq=MAX_SEQ)
    reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run_until_done()
    for p, n, r in zip(prompts, budgets, reqs):
        assert len(r.out_tokens) == n and oracle(p, r.out_tokens) == n, len(p)
    prompt = _prompts((150,), jcfg.vocab_size, seed=2)[0]
    eng = GenerationEngine(tcfg, params=tparams, device="cpu", max_batch=1, max_seq=100)
    req = eng.submit(prompt, max_new=4)
    eng.run_until_done()
    assert req.truncated and req.pos == 100 and len(req.out_tokens) == 1
    assert eng.stats()["prefill_tokens"] == 100
    assert oracle(prompt[:100], req.out_tokens) == 1


def test_launcher_serves_smoke_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n-requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke: device=cpu backend=dense mode=sync kernel=plain" in out
    assert out.count("4 tokens") == 3


# ---------------------------------------------------------------------------
# the reference's faults (ROADMAP §3, reference entries 5-7): strict xfails
# ---------------------------------------------------------------------------

@pytest.mark.xfail(strict=True, reason="reference fault (ROADMAP §3, reference entry 5): "
                   "blockwise_attention(ATTN_CHUNKED_LOCAL) builds its mask from the "
                   "chunk-aligned span start before dynamic_slice clamps the span "
                   "(models/attention.py:121-126, :171-176), wrong past the chunk when "
                   "S % chunk != 0")
@pytest.mark.parametrize("S", [96, 100, 160, 200, 600, 1100])
def test_jax_chunked_blockwise_matches_the_model_mask(S):
    q, k, v = _qkv(S)
    got = np.asarray(jax_attn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                                  attn_type=JAX_CHUNKED, chunk=CHUNK))
    want = ref_flash_attention(*map(torch.from_numpy, (q, k, v)), chunk=CHUNK).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)


@pytest.mark.xfail(strict=True, reason="reference fault (ROADMAP §3, reference entry 6): JAX "
                   "forward, the usual no-cache oracle, inherits entry 5 at S > chunk with S % "
                   "chunk != 0")
@pytest.mark.parametrize("Lp", [100, 128, 150])
def test_jax_forward_greedy_matches_the_chunk_aware_oracle(weights, oracle, Lp):
    """Greedy decoding by JAX ``forward`` over the whole sequence at each of
    8 steps (at Lp = 128 the first step is right, S % chunk = 0)."""
    jcfg, jparams, _, _ = weights
    prompt = _prompts(ORACLE_LENGTHS, jcfg.vocab_size)[ORACLE_LENGTHS.index(Lp)]
    last = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, logits_mode="last")[0])
    seq = list(prompt)
    for _ in range(N_NEW):
        seq.append(int(np.asarray(last(jparams, jnp.asarray([seq])))[0, -1].argmax()))
    agree = oracle(prompt, seq[Lp:])
    assert agree == N_NEW, f"Lp {Lp}: the first {agree} of {N_NEW} greedy tokens agree"


@pytest.mark.xfail(strict=True, reason="reference fault (ROADMAP §3, reference entry 7): the "
                   "JAX dense engine pads the prompt to its bucket and keeps the chunk ring's "
                   "last keys in linear order (models/transformer.py:151-152, serving/"
                   "engine.py:1342-1361): at Lp = 150 (bucket 256) the kept chunk 192-255 "
                   "holds only pads")
def test_jax_dense_engine_matches_the_chunk_aware_oracle(weights, oracle):
    jcfg, jparams, _, _ = weights
    prompt = _prompts(ORACLE_LENGTHS, jcfg.vocab_size)[ORACLE_LENGTHS.index(150)]
    jeng = JaxEngine(jcfg, params=jparams, backend="dense", max_batch=2, max_seq=MAX_SEQ)
    agree = oracle(prompt, _serve(jeng, [prompt])[0])
    assert agree == N_NEW, f"Lp 150: the first {agree} of {N_NEW} greedy tokens agree"
