"""internvl2-1b (a Qwen2 backbone behind a prefix of patch embeddings) on the
port against the JAX package on the CPU, at smoke width (2 layers, d 256, 4
heads over 2 KV heads, hd 64, 16 patch tokens, vocab 512) in float32, on
the same numpy inputs and weights (JAX ``init_params`` through
``params_from_numpy``, the QKV biases and ``patch_proj`` noised).

- The config and the params tree (``patch_proj``).
- ``forward``, ``prefill``, ``init_cache`` then ``decode_step`` with patch
  embeddings (the prefix stripped from the logits; decode at absolute
  positions, the prefix included), and without them (no prefix, as in
  JAX); teacher-forced decode after ``prefill`` against ``forward``.
- The dense engine, text only and padded to the bucket as the JAX dense
  engine serves it, against the JAX dense engine on
  ``torch_harness.bursty_workload``: identical greedy tokens; and the
  launcher.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_harness import bursty_workload

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
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
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

torch.set_num_threads(1)

ARCH = "internvl2-1b"
TOL = dict(rtol=2e-5, atol=2e-5)            # tests/test_kernel_conformance.py
OUT_TOL = dict(rtol=1e-4, atol=1e-4)        # two f32 stacks, other summation orders


def test_config_matches_jax():
    full, jfull = get_arch(ARCH), jax_get_arch(ARCH)
    small, jsmall = smoke_variant(full), jax_smoke(jfull)
    for t, j in ((full, jfull), (small, jsmall)):
        for name in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
                     "head_dim", "d_ff", "vocab_size", "attn_type", "qkv_bias", "rope_theta",
                     "num_patch_tokens", "tie_embeddings", "padded_vocab", "use_rope", "act"):
            assert getattr(t, name) == getattr(j, name), name
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.num_patch_tokens) == \
        (24, 896, 14, 2, 64, 4864, 151655, 256)
    assert full.padded_vocab == 151680 and small.num_patch_tokens == 16
    for cfg in (full, small):
        assert dense_cache_supported(cfg) and not paged_cache_supported(cfg)
        assert not prefills_unpadded(cfg)           # a linear cache: bucketed, as in JAX


def _tree(seed):
    """The JAX smoke model's tree as numpy, the QKV biases given seeded
    noise (JAX initialises them to zero, which would hide the bias path)."""
    jcfg = jax_smoke(jax_get_arch(ARCH))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    a = tree["blocks"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        a[name] = (0.5 * rng.standard_normal(a[name].shape)).astype(np.float32)
    return jcfg, smoke_variant(get_arch(ARCH)), tree, rng


def test_params_tree_matches_jax():
    jcfg, tcfg, tree, _ = _tree(0)
    ttree = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_leaves_with_path(tree)
    tl = jax.tree_util.tree_leaves_with_path(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    assert [tuple(x.shape) for _, x in tl] == [x.shape for _, x in jl]
    w = ttree["patch_proj"]["w"]
    assert tuple(w.shape) == (256, 256)
    assert abs(float(w.std()) - 1 / 16) < 0.005                # 1/sqrt(D)
    assert "lm_head" not in ttree                               # tied embeddings


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg, tree, _ = _tree(1)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tcfg, tree, "cpu")


def _batch(cfg, B, S, seed, patches=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("S,patches", [(5, True), (21, True), (21, False)])
def test_forward_and_prefill_match_jax(weights, S, patches):
    """The logits of the text positions (the prefix stripped), the cache of
    every position (prefix included) and ``prefill``'s last logits."""
    jcfg, jp, tcfg, tp = weights
    jb, tb = _both(_batch(jcfg, 2, S, S, patches))
    jl, _, jc = jax_forward(jcfg, jp, jb, want_cache=True)
    tl, aux, tc = forward(tcfg, tp, tb, want_cache=True)
    assert tuple(tl.shape) == (2, S, jcfg.padded_vocab) and float(aux) == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    n = S + (jcfg.num_patch_tokens if patches else 0)
    for name in ("k", "v"):
        assert tuple(tc[0][name].shape) == jc[0][name].shape == (2, 2, n, 2, 64)
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]), **OUT_TOL)
    last, _ = prefill(tcfg, tp, tb)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], **OUT_TOL)


def test_patch_prefix_changes_the_text_logits(weights):
    """The prefix reaches the text: other patch embeddings, other logits;
    a batch without them is the text alone."""
    _, _, tcfg, tp = weights
    b = _batch(tcfg, 1, 9, 4)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    a, _ = forward(tcfg, tp, t)
    other, _ = forward(tcfg, tp, {**t, "patch_embeds": t["patch_embeds"] + 1})
    text, _ = forward(tcfg, tp, {"tokens": t["tokens"]})
    assert float((a - other).abs().max()) > 1e-2 and float((a - text).abs().max()) > 1e-2


def test_init_cache_and_decode_step_match_jax(weights):
    """A 20-token prompt behind 16 patches prefilled into 48-slot caches,
    then five decode steps at absolute positions (prefix included), rows at
    different positions."""
    jcfg, jp, tcfg, tp = weights
    B, P, Sc = 2, jcfg.num_patch_tokens, 48
    jzero, tzero = jax_init_cache(jcfg, B, Sc), init_cache(tcfg, B, Sc, "cpu")
    assert set(tzero[0]) == set(jzero[0]) == {"k", "v"}
    for name, a in jzero[0].items():
        assert tuple(tzero[0][name].shape) == a.shape and not tzero[0][name].any()
    jb, tb = _both(_batch(jcfg, B, 20, 5))
    _, jc = jax_prefill(jcfg, jp, jb)
    _, tc = prefill(tcfg, tp, tb)
    n = P + 20
    jcache = ({k: jnp.zeros_like(jzero[0][k]).at[:, :, :n].set(a) for k, a in jc[0].items()},)
    tcache = init_cache(tcfg, B, Sc, "cpu")
    for k in ("k", "v"):
        tcache[0][k][:, :, :n] = tc[0][k]
    rng = np.random.default_rng(6)
    for i in range(5):
        toks = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.asarray([n + i, n + 2 * i], np.int32)
        jl, jcache = jax_decode_step(jcfg, jp, jcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, out = decode_step(tcfg, tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos))
        assert out is tcache                                   # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[0][k].numpy(), np.asarray(jcache[0][k]), **OUT_TOL)


def test_decode_after_prefill_matches_forward(weights):
    """Teacher-forced decode at ``pos + num_patch_tokens`` after ``prefill``
    gives ``forward``'s logits of the same sequence (as the JAX model API
    does, 1.8e-6 there): 8 tokens, 2 rows."""
    _, _, tcfg, tp = weights
    B, P, Lp, n_new = 2, tcfg.num_patch_tokens, 11, 8
    b = _batch(tcfg, B, Lp + n_new, 7)
    full = {k: torch.from_numpy(v) for k, v in b.items()}
    want, _ = forward(tcfg, tp, full)
    last, pc = prefill(tcfg, tp, {"tokens": full["tokens"][:, :Lp],
                                  "patch_embeds": full["patch_embeds"]})
    np.testing.assert_allclose(last.numpy(), want[:, Lp - 1].numpy(), **OUT_TOL)
    cache = init_cache(tcfg, B, P + Lp + n_new, "cpu")
    for k in ("k", "v"):
        cache[0][k][:, :, :P + Lp] = pc[0][k]
    for i in range(n_new - 1):
        pos = torch.full((B,), P + Lp + i, dtype=torch.int32)
        logits, _ = decode_step(tcfg, tp, cache, full["tokens"][:, Lp + i:Lp + i + 1], pos)
        np.testing.assert_allclose(logits.numpy(), want[:, Lp + i].numpy(), **OUT_TOL)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_engine_matches_jax_dense_engine(weights, seed):
    """The bursty harness workload (text only: the engine takes no image)
    through ``backend="paged"``, which falls back to the dense backend as
    in JAX: the JAX dense engine's greedy tokens, positions and steps."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(max_batch=3, max_seq=128)
    teng = GenerationEngine(tcfg, params=tparams, device="cpu", **kw)
    jeng = JaxEngine(jcfg, params=jparams, **kw)
    assert teng.backend == jeng.backend == "dense"
    assert teng.cache[0]["k"].shape[2] == 128                  # no prefix slots
    got = [(r.out_tokens, r.pos) for r in bursty_workload(teng, seed, long_decode=seed == 2)]
    want = [(r.out_tokens, r.pos) for r in bursty_workload(jeng, seed, long_decode=seed == 2)]
    assert got == want and teng.steps == jeng.steps
    assert teng.stats()["kernel"] == "plain"


def test_launcher_serves_smoke_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n-requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke: device=cpu backend=dense mode=sync kernel=plain" in out
    assert out.count("4 tokens") == 3
