"""The port's layer math against the JAX package on identical numpy inputs:
rms_norm (f32 and bf16), layer_norm, apply_rope, apply_mlp (silu and gelu),
qkv_project with the bias branch, embed_tokens/unembed (tied and untied),
and the weight bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import attention as jattn
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.params import params_from_numpy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def test_rms_norm_f32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(tl.rms_norm(_t(x), _t(scale)), jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


def test_rms_norm_bf16():
    """bf16 contract: variance in f32, product in bf16. Same inputs rounded
    once to bf16 on both sides; one bf16 ulp (2**-8 relative) of slack for a
    rounding flip of the inverse norm."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 128)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    got = tl.rms_norm(_t(x).bfloat16(), _t(scale).bfloat16())
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), rtol=8e-3, atol=8e-3)


def test_layer_norm():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    s, b = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    _close(tl.layer_norm(_t(x), _t(s), _t(b)),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("theta,pos_2d", [(1e4, True), (1e6, False)])
def test_apply_rope(theta, pos_2d):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4, 64)).astype(np.float32)
    pos = (rng.integers(0, 3000, (2, 6)) if pos_2d else rng.integers(0, 3000, 6)).astype(np.int32)
    _close(tl.apply_rope(_t(x), _t(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp(act):
    rng = np.random.default_rng(4)
    d, f = 32, 48
    names = (["w_gate", "w_up", "w_down"] if act == "silu"
             else ["w_up", "b_up", "w_down", "b_down"])
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d), "b_up": (f,), "b_down": (d,)}
    p = {n: (rng.standard_normal(shapes[n]) / np.sqrt(shapes[n][0])).astype(np.float32)
         for n in names}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    _close(tl.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act),
           jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act))


def test_qkv_project_with_bias():
    rng = np.random.default_rng(5)
    D, H, KVH, hd = 64, 4, 2, 16
    p = {"wq": rng.standard_normal((D, H * hd)), "wk": rng.standard_normal((D, KVH * hd)),
         "wv": rng.standard_normal((D, KVH * hd)), "bq": rng.standard_normal(H * hd),
         "bk": rng.standard_normal(KVH * hd), "bv": rng.standard_normal(KVH * hd)}
    p = {k: (v / 8).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    got = tattn.qkv_project({k: _t(v) for k, v in p.items()}, _t(x), H, KVH, hd)
    want = jattn.qkv_project({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), H, KVH, hd)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed(tied):
    rng = np.random.default_rng(6)
    V, D = 256, 32
    table = (rng.standard_normal((V, D)) * 0.02).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 0.02).astype(np.float32)
    toks = rng.integers(0, V, (2, 7)).astype(np.int32)
    x_t = tl.embed_tokens({"table": _t(table)}, _t(toks))
    x_j = jl.embed_tokens({"table": jnp.asarray(table)}, jnp.asarray(toks))
    _close(x_t, x_j)
    _close(tl.unembed({"table": _t(table)}, {"w": _t(head)}, x_t, tied),
           jl.unembed({"table": jnp.asarray(table)}, {"w": jnp.asarray(head)}, x_j, tied))


@pytest.mark.parametrize("arch,dtype", [("qwen2.5-3b", "float32"),
                                        ("smollm-135m", "bfloat16")])
def test_params_bridge_and_init_tree(arch, dtype):
    """params_from_numpy carries every leaf of the JAX tree across (bf16
    through float32, copied, not aliased), and the port's own init_params
    builds the same tree with the same shapes, dtypes and init scales."""
    from repro_torch.models import init_params

    jcfg = jax_smoke(jax_get_arch(arch)).replace(dtype=dtype)
    tcfg = smoke_variant(get_arch(arch)).replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    bridged = params_from_numpy(tcfg, tree, "cpu")
    own = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat_j, tdef = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat_j:
        keys = [p.key if hasattr(p, "key") else p.idx for p in path]
        b, o = bridged, own
        for k in keys:
            b, o = b[k], o[k]
        assert tuple(b.shape) == leaf.shape == tuple(o.shape), keys
        assert b.dtype == o.dtype == getattr(torch, dtype), keys
        np.testing.assert_array_equal(b.float().numpy(), leaf.astype(np.float32))
        if leaf.ndim >= 2 and leaf.size > 4096:  # same init scale, ±10%
            ratio = float(o.float().std()) / float(np.std(leaf.astype(np.float32)))
            assert 0.9 < ratio < 1.1, (keys, ratio)
    assert len(jax.tree.leaves(tree)) == len(jax.tree.leaves(
        jax.tree.map(lambda t: 0, own, is_leaf=lambda t: isinstance(t, torch.Tensor))))
