"""The backward of the two scans against JAX on the CPU, float32, on the
same numpy inputs.

- ``ref_rwkv6_chunked_backward`` (the plain version of the WKV kernel's
  backward) against ``jax.vjp`` of ``repro.models.rwkv6.wkv_scan``, which
  runs ``chunked_scan`` over its step (S 128 takes its remat branch), with a
  nonzero ``state0``, cotangents on y and on the final state, and decays
  that underflow (w = 0 entries).
- ``ref_ssm_scan_backward`` against ``torch.autograd`` through
  ``ref_ssm_scan``, and at the layer: JAX ``apply_ssm`` (every parameter, x
  and h0, through ``jax.vjp``) against the port's ``apply_ssm``, whose scan
  goes through the ``SelectiveScan`` Function under grad; likewise
  ``apply_rwkv6`` through ``WKV6``. The graphs hold the Functions' nodes.

JAX's gradient is autodiff of the sequential float32 recurrence (no JAX
caller routes training through its Pallas scans), so the tolerances are
float32 summation order: ``TOL`` (``train_harness.STEP_TOL``) beside
``SCALE`` of each gradient's largest entry.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jax_rwkv
from repro.models import ssm as jax_ssm
from repro_torch.kernels import rwkv6_scan as kw
from repro_torch.kernels import ssm_scan as ks
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models import ssm
from test_torch_hymba import _ssm_params
from test_torch_rwkv6 import _perturbed_tree
from train_harness import STEP_TOL

torch.set_num_threads(1)

TOL = STEP_TOL        # atol 2e-5, rtol 1e-4: two float32 computations, other summation orders
SCALE = 1e-5          # of a gradient's largest entry (its sums reach that size)


def assert_close(got, want, name):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] + SCALE * float(np.abs(want).max()),
                               err_msg=name)


def graph_nodes(t):
    """The class names of every node of ``t``'s autograd graph."""
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


# ---------------------------------------------------------------------------
# the WKV recurrence
# ---------------------------------------------------------------------------


def _wkv_case(seed, B, S, H, hd, underflow=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.2, 1.0, (B, S, H, hd)).astype(np.float32)
    if underflow:    # exp(-exp(x)) underflows to 0 in float32 for x > ~4.5
        w[:, ::3, :, ::2] = np.exp(-np.exp(np.float32(6.0)))
        assert (w == 0).sum() > 0
    u = rng.standard_normal((H, hd)).astype(np.float32)
    state0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dstate = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, state0, dy, dstate


def _jax_wkv_grads(r, k, v, w, u, state0, dy, dstate):
    _, vjp = jax.vjp(jax_rwkv.wkv_scan, *(jnp.asarray(a) for a in (r, k, v, w, u, state0)))
    return vjp((jnp.asarray(dy), jnp.asarray(dstate)))


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S", [1, 37, 128, 200])
def test_ref_wkv_backward_matches_jax_vjp(S, hd):
    """S 128 is a multiple of chunked_scan's 64: its remat branch."""
    case = _wkv_case(S + hd, 2, S, 2, hd)
    want = _jax_wkv_grads(*case)
    got = kw.ref_rwkv6_chunked_backward(*(torch.from_numpy(a) for a in case))
    for name, g, wt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == wt.shape, name
        assert_close(g, wt, name)


@pytest.mark.parametrize("S", [37, 128])
def test_ref_wkv_backward_where_decays_underflow(S):
    """w = 0 entries: the state's rows are dropped there, and every
    gradient stays finite and equal to JAX's."""
    case = _wkv_case(S, 2, S, 2, 32, underflow=True)
    want = _jax_wkv_grads(*case)
    got = kw.ref_rwkv6_chunked_backward(*(torch.from_numpy(a) for a in case))
    for name, g, wt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, want):
        assert_close(g, wt, name)


def test_wkv_function_matches_autograd_of_the_plain_version():
    """``trainable_rwkv6_chunked`` (the WKV6 Function, its backward the plain
    version on the CPU) against PyTorch autograd through
    ``ref_rwkv6_chunked``; without state0 its gradient is None."""
    case = [torch.from_numpy(a) for a in _wkv_case(5, 2, 23, 2, 32)]
    ins = [t.clone().requires_grad_() for t in case[:6]]
    y, st = kw.trainable_rwkv6_chunked(*ins)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    got = torch.autograd.grad((y * case[6]).sum() + (st * case[7]).sum(), ins)
    ref_ins = [t.clone().requires_grad_() for t in case[:6]]
    y_r, st_r = kw.ref_rwkv6_chunked(*ref_ins)
    want = torch.autograd.grad((y_r * case[6]).sum() + (st_r * case[7]).sum(), ref_ins)
    for name, g, wt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, want):
        assert_close(g, wt.numpy(), name)
    y, _ = kw.trainable_rwkv6_chunked(*ins[:5])
    grads = torch.autograd.grad(y.sum(), ins[:5])
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------


def _ssm_case(seed, B, S, Di, N, underflow=False):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.3, (B, S, Di)).astype(np.float32)
    x, dy = (rng.standard_normal((B, S, Di)).astype(np.float32) for _ in range(2))
    bm, cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    a_log = rng.standard_normal((Di, N)).astype(np.float32)
    if underflow:    # exp(dt A) = 0 exactly: dt 80, A = -exp(3)
        dt[:, ::4] = 80.0
        a_log[:, : N // 2] = 3.0
    h0, dh = (rng.standard_normal((B, Di, N)).astype(np.float32) for _ in range(2))
    return dt, x, bm, cm, a_log, h0, dy, dh


@pytest.mark.parametrize("underflow", [False, True])
@pytest.mark.parametrize("S", [1, 37, 128])
def test_ref_ssm_backward_matches_autograd(S, underflow):
    case = [torch.from_numpy(a) for a in _ssm_case(S, 2, S, 24, 8, underflow)]
    ins = [t.clone().requires_grad_() for t in case[:6]]
    y, h = ks.ref_ssm_scan(*ins)
    want = torch.autograd.grad((y * case[6]).sum() + (h * case[7]).sum(), ins)
    got = ks.ref_ssm_scan_backward(*case)
    for name, g, wt in zip(("ddt", "dx", "dbm", "dcm", "da_log", "dh0"), got, want):
        assert_close(g, wt.numpy(), name)
    # the Function on the CPU: its backward is the plain version
    y2, h2 = ks.trainable_ssm_scan(*ins)
    assert type(y2.grad_fn).__name__ == "SelectiveScanBackward"
    got2 = torch.autograd.grad((y2 * case[6]).sum() + (h2 * case[7]).sum(), ins)
    for name, g, wt in zip(("ddt", "dx", "dbm", "dcm", "da_log", "dh0"), got2, got):
        assert torch.equal(g, wt), name


def _jax_layer_grads(fn, params, x, state, d_out, d_state):
    """jax.vjp of fn(params, x, state) -> (out, state') for the cotangents."""
    _, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(state))
    return vjp((jnp.asarray(d_out), jnp.asarray(d_state)))


def _port_layer_grads(fn, params, x, state, d_out, d_state, function_name):
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    x, state = torch.from_numpy(x).requires_grad_(), torch.from_numpy(state).requires_grad_()
    out, new_state = fn(params, x, state)
    assert function_name in graph_nodes(out), graph_nodes(out)
    loss = (out * torch.from_numpy(d_out)).sum() + (new_state * torch.from_numpy(d_state)).sum()
    g = torch.autograd.grad(loss, [*params.values(), x, state])
    return dict(zip(params, g[:-2])), g[-2], g[-1]


def _compare_layer(got, want):
    (g_params, g_x, g_state), (w_params, w_x, w_state) = got, want
    assert set(g_params) == set(w_params)
    for name, g in g_params.items():
        assert_close(g, w_params[name], name)
    assert_close(g_x, w_x, "x")
    assert_close(g_state, w_state, "state")


@pytest.mark.parametrize("underflow", [False, True])
@pytest.mark.parametrize("S", [37, 128])
def test_apply_ssm_grads_match_jax(S, underflow):
    """Every parameter, x and h0 of the SSM branch, cotangents on its output
    and on the final h. ``underflow``: A_log 5 and dt_bias 10 give exp(dt A)
    = 0 exactly."""
    jcfg, tcfg, p, rng = _ssm_params(S)
    if underflow:
        p["A_log"] = np.full_like(p["A_log"], 5.0)
        p["dt_bias"] = np.full_like(p["dt_bias"], 10.0)
    B, D, N = 2, jcfg.d_model, jcfg.ssm_state
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32)
    d_out = rng.standard_normal((B, S, D)).astype(np.float32)
    d_h = rng.standard_normal((B, D, N)).astype(np.float32)
    want = _jax_layer_grads(
        lambda pp, xx, hh: (lambda o: (o[0], o[1][1]))(jax_ssm.apply_ssm(pp, xx, jcfg, h0=hh)),
        p, x, h0, d_out, d_h)
    got = _port_layer_grads(
        lambda pp, xx, hh: (lambda o: (o[0], o[1][1]))(ssm.apply_ssm(pp, xx, tcfg, h0=hh)),
        {k: torch.from_numpy(np.array(v)) for k, v in p.items()}, x, h0, d_out, d_h,
        "SelectiveScanBackward")
    _compare_layer(got, want)


@pytest.mark.parametrize("S", [37, 128])
def test_apply_rwkv6_grads_match_jax(S):
    """Every time-mixing parameter, x and the WKV state, cotangents on the
    output and on the final state."""
    jcfg, tcfg, tree, rng = _perturbed_tree(S)
    layer = jax.tree.map(lambda a: a[0], tree["blocks"][0])["rwkv"]
    B, D = 2, jcfg.d_model
    hd = jcfg.rwkv_head_dim
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    state = rng.standard_normal((B, D // hd, hd, hd)).astype(np.float32)
    d_out = rng.standard_normal((B, S, D)).astype(np.float32)
    d_state = rng.standard_normal(state.shape).astype(np.float32)
    want = _jax_layer_grads(
        lambda pp, xx, ss: (lambda o: (o[0], o[1][1]))(
            jax_rwkv.apply_rwkv6(pp, xx, jcfg, state=ss)),
        layer, x, state, d_out, d_state)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    got = _port_layer_grads(
        lambda pp, xx, ss: (lambda o: (o[0], o[1][1]))(rwkv.apply_rwkv6(pp, xx, tcfg, state=ss)),
        tp, x, state, d_out, d_state, "WKV6Backward")
    _compare_layer(got, want)


def test_direct_wrappers_stay_plain_on_the_cpu():
    """Without grad, or with a ``state_out`` / ``h_out``, the layers call the
    forward wrappers: no Function node in the graph."""
    jcfg, tcfg, p, rng = _ssm_params(3)
    params = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((1, 5, jcfg.d_model)).astype(np.float32))
    out, _ = ssm.apply_ssm(params, x, tcfg)
    assert out.grad_fn is None
    x.requires_grad_()
    h = torch.zeros((1, jcfg.d_model, jcfg.ssm_state))
    out, _ = ssm.apply_ssm(params, x, tcfg, h0=h, h_out=h)
    assert "SelectiveScanBackward" not in graph_nodes(out)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_plain_kernels_match_the_functions_on_the_cpu(arch):
    """``launch.grad_check.plain_kernels`` (the stack check's reference)
    takes the recurrences off the Functions and onto their plain forward
    versions under autograd, and puts them back; on the CPU the two
    stacks' gradients agree to float32 summation order, each leaf within
    1e-5 of its norm floored at 1e-3 of the global norm, as chip_smoke.py's
    stack check measures it (there, against a bound of 1e-3)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.launch.grad_check import cut_depth, leaf_paths, plain_kernels
    from repro_torch.models import init_params, loss_fn
    from repro_torch.params import tree_leaves

    cfg = cut_depth(smoke_variant(get_arch(arch)), 2).replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 24),
                                     generator=torch.Generator().manual_seed(5))}
    node = "WKV6Backward" if arch == "rwkv6-7b" else "SelectiveScanBackward"
    real = (rwkv.trainable_rwkv6_chunked, ssm.trainable_ssm_scan)

    def grads(plain):
        with plain_kernels() if plain else contextlib.nullcontext():
            total, _ = loss_fn(cfg, params, batch)
            assert (node in graph_nodes(total)) != plain, (arch, plain)
            return torch.autograd.grad(total, leaves)

    kern, ref = grads(False), grads(True)
    assert (rwkv.trainable_rwkv6_chunked, ssm.trainable_ssm_scan) == real
    assert len(leaf_paths(params)) == len(leaves)
    gnorm = float(torch.sqrt(sum(g.square().sum() for g in ref)))
    for path, a, b in zip(leaf_paths(params), kern, ref):
        assert torch.isfinite(a).all(), path
        err = float((a - b).norm()) / max(float(b.norm()), 1e-3 * gnorm)
        assert err < 1e-5, (arch, path, err)


@pytest.mark.parametrize("arch, layers, every", [
    ("llama4-scout-17b-a16e", 1, 0), ("llama4-scout-17b-a16e", 2, 0),
    ("llama4-scout-17b-a16e", 8, 4), ("qwen2.5-3b", 2, 0)])
def test_cut_depth(arch, layers, every):
    """``cut_depth`` cuts a stack to ``layers`` and drops a global layer
    period that the cut depth does not hold (llama4-scout's every 4th
    layer: its first three are chunked-local)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.grad_check import cut_depth

    cfg = cut_depth(get_arch(arch), layers)
    assert (cfg.num_layers, cfg.global_layer_every) == (layers, every)
    assert cfg.replace(num_layers=0, global_layer_every=0) == get_arch(arch).replace(
        num_layers=0, global_layer_every=0)
