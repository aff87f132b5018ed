"""The port's paged step programs against the JAX package on identical plan
arrays and weights: ``prefill_packed`` (ragged mixed batch: decode rows,
plain and segmented prefill chunks, pad tokens, a RAW -1 table tail) and
``decode_step_paged`` (with an inactive, scratch-filled row). The JAX side
runs its Pallas kernels in interpret mode; the port runs on the CPU, where
its wrappers take the plain versions. Logits at 1e-4 (two float32 stacks in
different summation orders), pools after the step at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import decode_step_paged as jax_decode
from repro.models import init_params as jax_init_params
from repro.models import prefill_packed as jax_prefill
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models import decode_step_paged, prefill_packed
from repro_torch.params import params_from_numpy

torch.set_num_threads(1)

BS, MB, NB, NULL = 16, 4, 14, 0
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(arch, seed):
    """JAX and torch params from one numpy tree (QKV biases randomised —
    JAX initialises them to zero, which would hide the bias path) and a
    random pool with prior contents."""
    jcfg = jax_smoke(jax_get_arch(arch))
    tcfg = smoke_variant(get_arch(arch))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    attn = tree["blocks"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.5 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tcfg, tree, "cpu")
    shape = (jcfg.num_layers, NB, BS, jcfg.num_kv_heads, jcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, k, v, rng


def _packed_plan(rng, vocab):
    tables = np.full((3, MB), -1, np.int32)
    tables[0, :2] = [3, 7]           # decode row at slot 20
    tables[1, :2] = [5, 1]           # segmented chunk, slots 8..17
    tables[2, :1] = [9]              # fresh prompt chunk, slots 0..5
    row_of, slots, positions, p_end, s_start = [0], [20], [20], [0], [0]
    for s in range(8, 18):           # doc segment [6, 24) after a 6-token prelude
        row_of.append(1)
        slots.append(s)
        positions.append(6 + s - 6)
        p_end.append(6)
        s_start.append(6)
    for s in range(0, 6):
        row_of.append(2)
        slots.append(s)
        positions.append(s)
        p_end.append(0)
        s_start.append(0)
    for _ in range(2):               # tail-alignment pads
        row_of.append(-1)
        slots.append(0)
        positions.append(0)
        p_end.append(0)
        s_start.append(0)
    mk = lambda xs: np.asarray(xs, np.int32)
    T = len(row_of)
    tokens = rng.integers(0, vocab, T).astype(np.int32)
    return tables, tokens, mk(row_of), mk(slots), mk(positions), mk(p_end), mk(s_start)


@pytest.mark.parametrize("arch,seed", [("qwen2.5-3b", 0), ("smollm-135m", 1)])
def test_prefill_packed_matches_jax(arch, seed):
    jcfg, tcfg, jp, tp, k, v, rng = _setup(arch, seed)
    plan = _packed_plan(rng, jcfg.vocab_size)
    tables, tokens, row_of, slots, positions, p_end, s_start = plan
    jl, jk, jv, _, _ = jax_prefill(
        jcfg, jp, jnp.asarray(k), jnp.asarray(v), *map(jnp.asarray, plan),
        block_size=BS, null_block=NULL, impl="pallas", interpret=True)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl = prefill_packed(tcfg, tp, tk, tv, *map(torch.from_numpy, plan),
                        block_size=BS, null_block=NULL)
    valid = row_of >= 0
    assert tuple(tl.shape) == (len(tokens), jcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **LOGIT_TOL)
    # the pools were updated in place; the scratch block takes racy pad writes
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **POOL_TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **POOL_TOL)
    assert not np.allclose(tk.numpy()[:, 1:], k[:, 1:])  # it did write


@pytest.mark.parametrize("arch,seed", [("qwen2.5-3b", 2), ("smollm-135m", 3)])
def test_decode_step_paged_matches_jax(arch, seed):
    jcfg, tcfg, jp, tp, k, v, rng = _setup(arch, seed)
    tables = np.full((3, MB), NULL, np.int32)   # decode plans: scratch-filled
    tables[0, :3] = [3, 7, 11]
    tables[1, :2] = [5, 1]
    pos = np.asarray([37, 16, 0], np.int32)     # row 2 inactive
    tokens = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    jl, jk, jv, _, _ = jax_decode(
        jcfg, jp, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(tokens), jnp.asarray(pos), block_size=BS, null_block=NULL,
        interpret=True)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl = decode_step_paged(tcfg, tp, tk, tv, torch.from_numpy(tables),
                           torch.from_numpy(tokens), torch.from_numpy(pos),
                           block_size=BS, null_block=NULL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **POOL_TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **POOL_TOL)
