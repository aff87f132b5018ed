"""The port's training path against the JAX package on the CPU, at smoke
width in float32, on the same numpy inputs and weights.

- The flash Function (``blockwise_attention`` with inputs that require
  grad, hence ``trainable_flash_attention``): forward and gradients against
  ``jax.grad`` of the JAX ``blockwise_attention`` (its ``custom_vjp``
  backward) over tests/test_attention.py's five mask cases and its cross
  case, at that file's tolerances (``FWD_TOL``, ``GRAD_TOL``); and
  ``ref_flash_attention_backward`` alone against the same gradients.
- ``loss_fn``; AdamW's update on equal gradients; three AdamW steps under
  ``cosine_schedule`` on smollm-135m's and qwen2.5-3b's smoke variants with
  1 and 2 microbatches (losses, grad norms, moments, parameters).
  ``STEP_TOL`` (tests/train_harness.py): two float32 stacks in different
  summation orders, through an update. One ``sgd_momentum`` step for every
  arch of ``ARCHS`` is in tests/test_torch_train_archs.py.
- ``TokenDataset`` batches bit for bit; checkpoints written by either
  package and read by the other, float32 and bfloat16 (the JAX reader's own
  bfloat16 gap is a strict xfail: ROADMAP §3).
- The training stack: each layer group recomputed once in the backward,
  the launcher's CPU smoke, and the grad guards of the CUDA wrappers.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.data.workload import TokenDataset as JaxTokenDataset
from repro.models import attention as jax_attn
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import make_train_step as jax_make_train_step
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import ATTN_CHUNKED_LOCAL, ATTN_FULL, ATTN_SWA
from repro_torch.data.workload import TokenDataset
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels.decode_attention import refuse_grad
from repro_torch.models import attention as attn
from repro_torch.models import loss_fn, make_train_step
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.params import params_from_numpy, tree_leaves
from train_harness import (
    STEP_TOL,
    assert_trees_close,
    batches,
    flat_jax,
    flat_port,
    setup,
    torch_batch,
)

torch.set_num_threads(1)

FWD_TOL = dict(atol=2e-5, rtol=2e-5)      # tests/test_attention.py
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)     # tests/test_attention.py
NOISE_SHARE = 1e-4       # of the parameters: see test_adamw_steps_against_jax

# tests/test_attention.py's CASES, then its cross case (S 256 over 100 keys)
ATTN_CASES = [
    (ATTN_FULL, 0, 0),
    (ATTN_SWA, 128, 0),
    (ATTN_SWA, 64, 0),
    (ATTN_CHUNKED_LOCAL, 0, 256),
    (ATTN_CHUNKED_LOCAL, 0, 128),
    "cross",
]
# MLA's head dims (96 query/key, 64 value: minicpm3's), causal
REF_CASES = ATTN_CASES + ["mla"]


@functools.lru_cache(maxsize=None)
def _attention_case(case):
    """numpy q, k, v, the JAX output and the JAX gradients of sum(sin(out))
    for one case."""
    rng = np.random.default_rng(0)
    hd_v = None
    if case == "cross":
        B, S, Skv, H, KVH, hd = 2, 256, 100, 4, 4, 32
        kw = dict(causal=False)
    elif case == "mla":
        B, S, Skv, H, KVH, hd, hd_v = 1, 320, 320, 4, 4, 96, 64
        kw = dict(attn_type=ATTN_FULL)
    else:
        B, S, Skv, H, KVH, hd = 2, 512, 512, 4, 2, 32
        kw = dict(attn_type=case[0], window=case[1], chunk=case[2])
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, hd_v or hd)).astype(np.float32)
    block_q = {"cross": 64, "mla": 64}.get(case, 128)
    f = lambda *a: jax_attn.blockwise_attention(*a, block_q=block_q, **kw)
    out = np.asarray(f(q, k, v))
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))), argnums=(0, 1, 2))(q, k, v)
    return (q, k, v), kw, out, tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_function_against_jax(case):
    inputs, kw, want_out, want_grads = _attention_case(case)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in inputs)
    out = attn.blockwise_attention(q, k, v, **kw)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
    torch.sin(out).sum().backward()
    for t, want in zip((q, k, v), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), want, **GRAD_TOL)


@pytest.mark.parametrize("case", REF_CASES)
def test_ref_backward_against_jax(case):
    inputs, kw, want_out, want_grads = _attention_case(case)
    q, k, v = (torch.from_numpy(a) for a in inputs)
    form = dict(causal=kw.get("causal", True))
    if kw.get("attn_type") == ATTN_SWA:
        form["window"] = kw["window"]
    if kw.get("attn_type") == ATTN_CHUNKED_LOCAL:
        form["chunk"] = kw["chunk"]
    out = kf.ref_flash_attention(q, k, v, **form)
    dout = torch.cos(out)                                # d sum(sin(out)) / d out
    got = kf.ref_flash_attention_backward(q, k, v, out, dout, **form)
    for g, want in zip(got, want_grads):
        np.testing.assert_allclose(g.numpy(), want, **GRAD_TOL)


# (S, S_kv, causal, window, chunk, head dims): every form the forward kernel
# takes, then those it does not (cross at (128, 128), causal cross, a
# window with a chunk, head dims (32, 32))
FORWARD_FORMS = [(128, 128, causal, window, chunk, dims)
                 for dims in kf.HEAD_DIMS for causal in (True, False)
                 for window, chunk in ((0, 0), (64, 0), (0, 64))] + [(128, 100, False, 0, 0, (64, 64))]
FOREIGN_FORMS = [(128, 100, False, 0, 0, (128, 128)), (128, 100, True, 0, 0, (64, 64)),
                 (128, 128, True, 64, 64, (64, 64)), (128, 128, True, 0, 0, (32, 32))]


@pytest.mark.parametrize("form", FORWARD_FORMS + FOREIGN_FORMS,
                         ids=lambda f: "S{}_Skv{}_causal{}_w{}_c{}_hd{}x{}".format(*f[:5], *f[5]))
def test_backward_forms_on_the_card_are_checked_before_the_forward(form):
    """The check runs on the shapes alone, before any launch: the forms the
    forward kernel takes pass, the others raise."""
    if form in FORWARD_FORMS:
        kf._check_backward_form(*form)
    else:
        with pytest.raises(NotImplementedError, match="backward on the card"):
            kf._check_backward_form(*form)


# (causal, window, chunk) of each self-attention form, and cross attention
# over 1, 37 and 1500 keys
TILE_FORMS = [(True, 0, 0), (False, 0, 0), (True, 1, 0), (True, 64, 0), (True, 100, 0),
              (True, 1024, 0), (False, 100, 0), (True, 0, 50), (True, 0, 64), (True, 0, 800),
              (False, 0, 50), (False, 0, 800)]


@pytest.mark.parametrize("S", [1, 37, 64, 1000, 2048])
@pytest.mark.parametrize("form", TILE_FORMS + ["cross"])
def test_tile_ranges_cover_exactly_the_visible_tiles(form, S):
    """``kv_tiles`` lists for each query tile, and ``q_tiles`` for each key
    tile, exactly the tiles that hold a pair the plain mask leaves visible
    (``hidden_mask``, the plain version's mask), at ragged S too."""
    forms = ([(S_kv, False, 0, 0) for S_kv in (1, 37, 1500)] if form == "cross"
             else [(S, *form)])
    for S_kv, causal, window, chunk in forms:
        visible = ~kf.hidden_mask(S, S_kv, causal, window, chunk)
        nq, nkv = -(-S // kf.TILE), -(-S_kv // kf.TILE)
        pad = torch.zeros((nq * kf.TILE, nkv * kf.TILE), dtype=torch.bool)
        pad[:S, :S_kv] = visible
        seen = pad.view(nq, kf.TILE, nkv, kf.TILE).any(3).any(1)       # (nq, nkv)
        for qt in range(nq):
            b, e = kf.kv_tiles(qt, S, S_kv, causal, window, chunk)
            assert list(range(b, e)) == seen[qt].nonzero().flatten().tolist(), (qt, S_kv)
        for kt in range(nkv):
            b, e = kf.q_tiles(kt, S, S_kv, causal, window, chunk)
            assert list(range(b, e)) == seen[:, kt].nonzero().flatten().tolist(), (kt, S_kv)


def test_refuse_grad():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        refuse_grad("kernel", torch.ones(2), x)
    with torch.no_grad():
        refuse_grad("kernel", x)
    refuse_grad("kernel", x.detach(), None, torch.ones(2, dtype=torch.int32))
    # the CPU plain versions stay differentiable
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    out = kf.flash_attention(q, q.detach()[:, :, :1], q.detach()[:, :, :1])
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


# ---------------------------------------------------------------------------
# loss, train steps, optimizers
# ---------------------------------------------------------------------------

def test_loss_fn_against_jax():
    """``loss_fn`` on mixtral's smoke variant (an MoE stack: the aux loss
    enters ``total``); every arch's loss and aux loss are held again by
    ``test_sgd_train_step_against_jax`` (tests/test_torch_train_archs.py)."""
    jcfg, tcfg, tree = setup("mixtral-8x22b")
    batch = batches(jcfg, np.random.default_rng(1))
    want_total, want = jax.jit(functools.partial(jax_loss_fn, jcfg))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    total, got = loss_fn(tcfg, params_from_numpy(tcfg, tree, "cpu"), torch_batch(batch))
    assert float(want["aux_loss"]) > 0
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    for key in ("loss", "aux_loss", "total"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("param_dtype,momentum_dtype", [("float32", "float32"),
                                                        ("float32", "bfloat16"),
                                                        ("bfloat16", "float32"),
                                                        ("bfloat16", "bfloat16")])
def test_adamw_update_against_jax(param_dtype, momentum_dtype):
    """Three AdamW updates under ``cosine_schedule`` on the same parameters
    and the same gradients (a clipped step and unclipped ones; elements
    near zero among them): parameters and moments as the JAX optimizer's,
    within float32 rounding (bf16 leaves: one bf16 rounding)."""
    rng = np.random.default_rng(8)
    shapes = {"w": (3, 40, 24), "b": (24,), "s": (2, 5)}
    tree = {k: rng.standard_normal(v).astype(np.float32) * 0.05 for k, v in shapes.items()}
    grads = [{k: rng.standard_normal(v).astype(np.float32) * scale
              * (rng.random(v) < 0.9) for k, v in shapes.items()}     # some exact zeros
             for scale in (1.0, 1e-3, 1e-9)]
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    jopt = JaxAdamW(lr=jax_cosine(1e-2, warmup=2, total=3), momentum_dtype=momentum_dtype)
    opt = AdamW(lr=cosine_schedule(1e-2, warmup=2, total=3), momentum_dtype=momentum_dtype)
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in tree.items()}
    # a copy: AdamW updates in place, and a float32 torch.from_numpy(v) would
    # write into the numpy buffer that jnp.asarray(v) may share (zero-copy)
    params = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in tree.items()}
    jstate, state = jopt.init(jparams), opt.init(params)
    for g in grads:
        jparams, jstate = jopt.update(jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        params, state = opt.update(params, {k: torch.from_numpy(v) for k, v in g.items()}, state)
    assert int(state["step"]) == int(jstate["step"]) == 3
    tol = dict(rtol=1e-5, atol=1e-7) if param_dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    mtol = dict(rtol=1e-5, atol=1e-9) if momentum_dtype == "float32" else dict(rtol=2 ** -7,
                                                                                atol=1e-9)
    for k in shapes:
        assert params[k].dtype == tdt
        np.testing.assert_allclose(params[k].float().numpy(),
                                   np.asarray(jparams[k], np.float32), err_msg=k, **tol)
        np.testing.assert_allclose(state["m"][k].float().numpy(),
                                   np.asarray(jstate["m"][k], np.float32), err_msg=k, **mtol)
        np.testing.assert_allclose(state["v"][k].numpy(), np.asarray(jstate["v"][k]),
                                   err_msg=k, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b"])
def test_adamw_steps_against_jax(arch, microbatches):
    """Three train steps under AdamW and ``cosine_schedule`` on the smoke
    variant, from the same weights on the same ``TokenDataset`` batches:
    each step's loss, total and grad norm (taken over the averaged
    microbatch gradients before the clip) and the moments as JAX's. The
    parameters: AdamW's first update is lr * g / (|g| + eps), about lr *
    sign(g), so an element whose gradient at a step is near zero (below
    the two float32 summation orders' noise, or exactly zero in real
    arithmetic, as qwen's key biases are: a bias shared by every key of a
    head shifts a row's scores by one constant, which the softmax cancels)
    can move by up to 2 lr apart in the two packages. So every element is
    held within 2 x the summed lr of JAX's, and all but ``NOISE_SHARE`` of
    them within ``STEP_TOL``; ``test_adamw_update_against_jax`` holds the
    update itself on equal gradients."""
    jcfg, tcfg, tree = setup(arch)
    steps, batch, seq = 3, 4, 32
    data = list(JaxTokenDataset(jcfg.vocab_size, seq, seed=3).batches(batch, steps))
    lr = cosine_schedule(3e-3, warmup=1, total=steps)
    jopt = JaxAdamW(lr=jax_cosine(3e-3, warmup=1, total=steps))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=microbatches))
    opt = AdamW(lr=lr)
    params = params_from_numpy(tcfg, tree, "cpu")
    state = opt.init(params)
    step = make_train_step(tcfg, opt, microbatches=microbatches)
    for tokens in data:
        jparams, jstate, want = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})
        params, state, got = step(params, state, {"tokens": torch.from_numpy(tokens)})
        for key in ("loss", "total", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=key)
    assert int(state["step"]) == int(jstate["step"]) == steps
    # the moments of steps 2 and 3 come from parameters that already differ
    # by the near-zero elements' updates: 1e-3 of each leaf's largest moment
    assert_trees_close(state["m"], jstate["m"], rtol=1e-4, atol=0, scale=1e-3)
    assert_trees_close(state["v"], jstate["v"], rtol=1e-3, atol=0, scale=1e-3)
    got, want = flat_port(params), flat_jax(jparams)
    assert got.keys() == want.keys()
    moved_apart = 2 * sum(lr(i + 1) for i in range(steps))
    n_off = n_all = 0
    for key, g in got.items():
        g, w = g.detach().numpy(), np.asarray(want[key])
        np.testing.assert_allclose(g, w, rtol=0, atol=moved_apart, err_msg=key)
        n_off += int((np.abs(g - w) > STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(w)).sum())
        n_all += g.size
    assert n_off <= NOISE_SHARE * n_all, (n_off, n_all)


@pytest.mark.parametrize("step", [1, 2, 3, 10, 50, 199, 200, 250])
def test_schedule_and_bias_corrections(step):
    want = float(jax_cosine(3e-4, warmup=10, total=200)(step))
    assert cosine_schedule(3e-4, warmup=10, total=200)(step) == pytest.approx(want, rel=2e-7)
    from repro_torch.optim.adamw import _pow_f32

    for b in (0.9, 0.95):
        assert _pow_f32(b, step) == float(jnp.float32(b) ** jnp.float32(step))


@pytest.mark.parametrize("vocab,seq,seed", [(512, 32, 0), (49152, 64, 3), (151936, 17, 7)])
def test_token_dataset_bit_for_bit(vocab, seq, seed):
    want = list(JaxTokenDataset(vocab, seq, seed=seed).batches(3, 2))
    got = list(TokenDataset(vocab, seq, seed=seed).batches(3, 2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _bits(x):
    """The raw bits of a float32 or bfloat16 leaf (numpy, JAX or torch)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x.view(np.int32)


@pytest.mark.parametrize("direction,dtype", [("jax_to_port", "float32"),
                                             ("port_to_jax", "float32"),
                                             ("port_to_port", "bfloat16"),
                                             ("jax_to_port", "bfloat16")])
def test_checkpoint_between_packages(tmp_path, direction, dtype):
    jcfg, tcfg, tree = setup("qwen2.5-3b", dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(4))
    like = params_from_numpy(tcfg, tree, "cpu")              # the structure, other values
    path = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        jax_save(path, jparams, step=7, metadata={"arch": jcfg.name})
        got, step, meta = load_checkpoint(path, like=like)
        got, want = flat_port(got), flat_jax(jparams)
    else:
        src = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
        save_checkpoint(path, src, step=7, metadata={"arch": jcfg.name})
        if direction == "port_to_jax":
            got, step, meta = jax_load(path, like=jax.tree.map(jnp.asarray, tree))
            got = flat_jax(got)
        else:
            got, step, meta = load_checkpoint(path, like=like)
            got = flat_port(got)
        want = flat_port(src)
    assert step == 7 and meta == {"arch": jcfg.name}
    assert got.keys() == want.keys() == flat_port(like).keys()
    for key, g in got.items():
        if isinstance(g, torch.Tensor):
            assert g.dtype == like_dtype(dtype), key
        np.testing.assert_array_equal(_bits(g), _bits(want[key]), err_msg=key)


def like_dtype(dtype):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


def test_checkpoint_flat_keys_and_bf16_records(tmp_path):
    _, tcfg, tree = setup("smollm-135m", "bfloat16")
    params = params_from_numpy(tcfg, tree, "cpu")
    path = str(tmp_path / "flat.npz")
    save_checkpoint(path, params, step=3)
    with np.load(path) as data:
        assert "blocks##0##attn##wq" in data.files and "embed##table" in data.files
        assert data["blocks##0##attn##wq"].dtype == np.dtype("V2")
        assert int(data["__step__"]) == 3
    flat, step, meta = load_checkpoint(path)
    assert step == 3 and meta == {}
    assert flat["embed##table"].dtype == torch.bfloat16
    assert torch.equal(flat["embed##table"], params["embed"]["table"])


@pytest.mark.xfail(strict=True, raises=ValueError,
                   reason="the JAX load_checkpoint cannot cast its own |V2 (bfloat16) records "
                          "back with like= (ROADMAP §3)")
def test_jax_load_checkpoint_bf16_like(tmp_path):
    jcfg, _, tree = setup("smollm-135m", "bfloat16")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(5))
    path = str(tmp_path / "jax_bf16")
    jax_save(path, jparams)
    got, _, _ = jax_load(path, like=jparams)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


# ---------------------------------------------------------------------------
# the training stack and the launcher
# ---------------------------------------------------------------------------


def test_training_recomputes_each_layer_group_once(monkeypatch):
    """With parameters that require grad the stack runs each layer once
    forward and once more in the backward (remat), and the gradients equal
    those of the stack without remat (the layers sliced per group, nothing
    recomputed)."""
    jcfg = jax_smoke(jax_get_arch("qwen2.5-3b")).replace(num_layers=3)
    tcfg = smoke_variant(get_arch("qwen2.5-3b")).replace(num_layers=3)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    batch = torch_batch(batches(tcfg, np.random.default_rng(6), B=2, S=24))
    calls = []
    real = tfm.apply_layer_seq
    monkeypatch.setattr(tfm, "apply_layer_seq", lambda *a, **k: calls.append(1) or real(*a, **k))
    params = params_from_numpy(tcfg, tree, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = loss_fn(tcfg, params, batch)
    assert len(calls) == 3
    grads = torch.autograd.grad(total, leaves)
    assert len(calls) == 6
    monkeypatch.setattr(tfm, "_training", lambda x, blocks: False)   # the serving loop
    total2, _ = loss_fn(tcfg, params, batch)
    grads2 = torch.autograd.grad(total2, leaves)
    assert len(calls) == 9
    assert float(total.detach()) == float(total2.detach())
    for g, g2 in zip(grads, grads2):
        torch.testing.assert_close(g, g2, rtol=1e-6, atol=1e-7)


def test_unbind_groups_matches_layer_slice():
    stacked = {"a": torch.arange(12.).reshape(3, 4), "b": {"c": torch.arange(6.).reshape(3, 2)}}
    groups = tfm.unbind_groups(stacked, 3)
    for g in range(3):
        want = tfm.layer_slice(stacked, g)
        assert torch.equal(groups[g]["a"], want["a"])
        assert torch.equal(groups[g]["b"]["c"], want["b"]["c"])


def test_train_launcher_cpu_smoke(capsys):
    from repro_torch.launch.train import main

    main(["--device", "cpu", "--smoke", "--steps", "3"])
    out = capsys.readouterr().out
    assert "[train] smollm-135m-smoke" in out and "on cpu" in out
    first, last = (float(x) for x in out.strip().splitlines()[-1].split("loss ")[1].split(" -> "))
    assert math.isfinite(first) and last < first
