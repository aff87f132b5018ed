"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's on the CPU, at mixtral-8x22b's smoke width (d 256, 4 experts,
top-2, expert d_ff 512) in float32, on the same numpy inputs and weights.

- ``apply_moe`` against ``repro.models.moe.apply_moe``: y at ``TOL`` (float32
  products in another summation order), the Switch aux loss at 1e-6, at T =
  8 (dropless) and T = 300 and 600 (capacity 1.25 T K / E); with the token
  chunking (``max_chunk_tokens=64`` at T = 300: five chunks of 60, each
  dropless); with one expert made to overflow (a constant added to its
  router column, inputs with a positive mean: the reference itself drops
  routes there, and random routing drops none); and with two equal router
  columns, where the top-k breaks every tie to the lower expert index, as
  ``jax.lax.top_k`` does.
- ``forward`` of mixtral's smoke variant past the dropless range (T = 300
  and 600): the model's own hidden states load the experts unevenly, so
  layers drop routes, and the logits are JAX's at ``OUT_TOL``.
- ``init_params`` of mixtral-8x22b at full width has JAX's tree and shapes
  (meta device against ``jax.eval_shape``), the init scales are JAX's, and
  ``params_from_numpy`` carries a JAX mixtral-smoke tree leaf for leaf.
- MoE on the paged backend: mixtral's smoke variant with full attention
  (``paged_cache_supported`` in both packages) through the port's paged
  engine and the JAX paged engine, ``kernel="pallas"`` on both sides, on the
  invariant harness's bursty workload: identical StepPlans and greedy
  tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.configs.base import ATTN_FULL as JAX_ATTN_FULL
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import ATTN_FULL
from repro_torch.models import forward, init_params, paged_cache_supported
from repro_torch.models import moe
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import GenerationEngine
from torch_harness import bursty_workload, record_plans

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)          # tests/test_kernel_conformance.py
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
OUT_TOL = dict(rtol=1e-4, atol=1e-4)      # two f32 stacks, other summation orders
ARCH = "mixtral-8x22b"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _moe_params(seed, bump=0.0, tie=False):
    """The JAX smoke model's MoE params as numpy: ``bump`` added to expert
    1's router column, or with ``tie`` expert 2's column made equal to
    expert 1's."""
    jcfg = jax_smoke(jax_get_arch(ARCH))
    p = jax.tree.map(np.array, jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    p["router"][:, 1] += bump
    if tie:
        p["router"][:, 2] = p["router"][:, 1]
    return jcfg, p


def _jax_drops(jcfg, p, x):
    """Routes past their expert's capacity in the reference's routing: each
    expert keeps its first C routes, so the drops are sum(max(n_e - C, 0))."""
    E, K = jcfg.num_experts, jcfg.num_experts_per_tok
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    _, idx = jax.lax.top_k((xt @ jnp.asarray(p["router"])).astype(jnp.float32), K)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=E)
    return int(np.maximum(counts - jax_moe.expert_capacity(xt.shape[0], E, K), 0).sum())


# (B, S, router bump, input offset, tie, max_chunk_tokens)
MOE_CASES = {
    "T8-dropless": (2, 4, 0.0, 0.0, False, 8192),
    "T300-capacity": (3, 100, 0.0, 0.0, False, 8192),
    "T600-capacity": (2, 300, 0.0, 0.0, False, 8192),
    "T300-overflow": (3, 100, 1.0, 0.3, False, 8192),
    "T300-chunked": (3, 100, 0.0, 0.0, False, 64),
    "T300-ties": (3, 100, 0.0, 0.0, True, 8192),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_jax(case):
    B, S, bump, offset, tie, chunk = MOE_CASES[case]
    jcfg, p = _moe_params(0, bump, tie)
    tcfg = smoke_variant(get_arch(ARCH))
    rng = np.random.default_rng(B * S)
    x = (rng.standard_normal((B, S, jcfg.d_model)) + offset).astype(np.float32)
    jy, jaux = jax_moe.apply_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                                 max_chunk_tokens=chunk)
    tp = params_from_numpy(tcfg, p, "cpu")
    ty, taux = moe.apply_moe(tp, torch.from_numpy(x), tcfg, max_chunk_tokens=chunk)
    assert tuple(ty.shape) == (B, S, jcfg.d_model) and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)
    # the routing itself, on the whole batch: the reference's experts and drops
    T, E, K = B * S, jcfg.num_experts, jcfg.num_experts_per_tok
    C = moe.expert_capacity(T, E, K)
    assert C == jax_moe.expert_capacity(T, E, K)
    xt = torch.from_numpy(x).reshape(T, -1)
    _, _, idx, gates, pos, keep = moe.route(tp, xt, tcfg, C)
    _, jidx = jax.lax.top_k((jnp.asarray(xt.numpy()) @ jnp.asarray(p["router"]))
                            .astype(jnp.float32), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    drops = _jax_drops(jcfg, p, x)
    assert int((~keep).sum()) == drops
    if case == "T300-overflow":
        assert drops > 0
    elif not tie:
        assert drops == 0, drops          # random routing stays within capacity
    else:
        tied = (idx == 1).any(1) ^ (idx == 2).any(1)  # the tie sits at the top-k's edge
        assert bool(tied.any()) and not bool((idx == 2).any(1)[tied].any())


def test_overflow_drops_change_the_output(monkeypatch):
    """The overflow case's drops are real: dropless routing (capacity T)
    gives another y for exactly the tokens whose routes were dropped."""
    B, S, bump, offset, _, _ = MOE_CASES["T300-overflow"]
    jcfg, p = _moe_params(0, bump)
    tcfg = smoke_variant(get_arch(ARCH))
    x = (np.random.default_rng(B * S).standard_normal((B, S, jcfg.d_model))
         + offset).astype(np.float32)
    tp = params_from_numpy(tcfg, p, "cpu")
    ty, _ = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    T = B * S
    *_, keep = moe.route(tp, torch.from_numpy(x).reshape(T, -1), tcfg,
                         moe.expert_capacity(T, 4, 2))
    monkeypatch.setattr(moe, "expert_capacity", lambda n, e, k: n)
    full, _ = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    hit = (~keep).any(1).numpy()
    d = (ty - full).reshape(T, -1).abs().amax(1).numpy()
    assert hit.any() and (d[hit] > 1e-3).all() and (d[~hit] < 1e-5).all()


@pytest.mark.parametrize("S", [300, 600])
def test_forward_with_capacity_drops_matches_jax(S, monkeypatch):
    jcfg = jax_smoke(jax_get_arch(ARCH))
    tcfg = smoke_variant(get_arch(ARCH))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab_size, (1, S)).astype(np.int32)
    route, drops = moe.route, []

    def counted(params, xt, cfg, capacity):
        out = route(params, xt, cfg, capacity)
        drops.append(int((~out[-1]).sum()))
        return out

    monkeypatch.setattr(moe, "route", counted)
    tl, taux = forward(tcfg, params_from_numpy(tcfg, tree, "cpu"),
                       {"tokens": torch.from_numpy(tokens)})
    jl, jaux = jax_forward(jcfg, jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)})
    assert len(drops) == tcfg.num_layers and sum(drops) > 0, drops
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


def test_init_params_and_bridge_match_jax():
    jshapes = dict(_leaves(jax.eval_shape(
        lambda: jax_init_params(jax_get_arch(ARCH), jax.random.PRNGKey(0)))))
    tshapes = dict(_leaves(init_params(get_arch(ARCH), torch.Generator(), "meta")))
    assert set(tshapes) == set(jshapes) and "/blocks/0/moe/w_down" in tshapes
    assert "/blocks/0/mlp/w_gate" not in tshapes
    for name, leaf in jshapes.items():
        assert tuple(tshapes[name].shape) == leaf.shape, name
    # the init scales of repro.models.moe.init_moe
    cfg = smoke_variant(get_arch(ARCH))
    small = init_params(cfg, torch.Generator().manual_seed(0), "cpu")["blocks"][0]["moe"]
    assert abs(float(small["router"].std()) - 0.02) < 2e-3
    for name, d_in in (("w_gate", cfg.d_model), ("w_up", cfg.d_model), ("w_down", cfg.d_ff)):
        assert abs(float(small[name].std()) * d_in ** 0.5 - 1.0) < 0.02, name
    # a shared expert (llama4's branch) has init_mlp's tree
    shared = moe.init_moe(torch.Generator().manual_seed(1), cfg.replace(n_shared_experts=1),
                          torch.float32, "cpu")
    jshared = jax_moe.init_moe(jax.random.PRNGKey(1), jax_smoke(jax_get_arch(ARCH))
                               .replace(n_shared_experts=1), jnp.float32)
    assert {k: tuple(v.shape) for k, v in _leaves(shared)} == \
        {k: v.shape for k, v in _leaves(jshared)}
    # the bridge carries every MoE leaf
    jcfg = jax_smoke(jax_get_arch(ARCH))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(2)))
    got, want = dict(_leaves(params_from_numpy(cfg, tree, "cpu"))), dict(_leaves(tree))
    assert set(got) == set(want) and "/blocks/0/moe/router" in got
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)


def test_shared_expert_matches_jax():
    jcfg = jax_smoke(jax_get_arch(ARCH)).replace(n_shared_experts=1)
    tcfg = smoke_variant(get_arch(ARCH)).replace(n_shared_experts=1)
    p = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32))
    x = np.random.default_rng(3).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax_moe.apply_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    ty, taux = moe.apply_moe(params_from_numpy(tcfg, p, "cpu"), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


# ---------------------------------------------------------------------------
# MoE on the paged backend
# ---------------------------------------------------------------------------

_FIELDS = ("tokens", "starts", "tables", "n_valid", "positions", "p_end", "s_start",
           "row_of", "slots", "decode_idx", "last_idx")


@pytest.mark.parametrize("seed", [0, 3])
def test_paged_moe_engine_matches_jax(seed):
    jcfg = jax_smoke(jax_get_arch(ARCH)).replace(attn_type=JAX_ATTN_FULL)
    tcfg = smoke_variant(get_arch(ARCH)).replace(attn_type=ATTN_FULL)
    assert paged_cache_supported(tcfg)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    kw = dict(max_batch=3, max_seq=96, prefill_chunk_size=16, token_budget=20,
              kernel="pallas")
    jeng = JaxEngine(jcfg, params=jax.tree.map(jnp.asarray, tree), **kw)
    teng = GenerationEngine(tcfg, params=params_from_numpy(tcfg, tree, "cpu"),
                            device="cpu", **kw)
    assert jeng.backend == teng.backend == "paged"
    jplans, tplans = record_plans(jeng), record_plans(teng)
    jreqs = bursty_workload(jeng, seed, long_decode=False)
    treqs = bursty_workload(teng, seed, long_decode=False)
    assert len(tplans) == len(jplans) > 0
    for jp, tp in zip(jplans, tplans):
        assert (tp.plan_id, tp.kind, tp.n_tokens) == (jp.plan_id, jp.kind, jp.n_tokens)
        for name in _FIELDS:
            a, b = getattr(jp, name), getattr(tp, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=f"plan {jp.plan_id} {name}")
    assert {p.kind for p in tplans} == {"ragged", "decode"}
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == r.max_new for r in treqs)
