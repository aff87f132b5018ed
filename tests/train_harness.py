"""Shared helpers of the training tests (tests/test_torch_train.py,
tests/test_torch_train_archs.py): the JAX and port smoke configs with the
JAX weights as numpy, batches, and tree comparisons by path. Not collected
(no ``test_`` prefix)."""
import functools

import jax
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_arch, smoke_variant

STEP_TOL = dict(atol=2e-5, rtol=1e-4)
LEAF_SCALE = 1e-4        # of a leaf's largest entry: see assert_trees_close

B, S = 2, 64


def setup(arch, dtype="float32"):
    """The JAX and port smoke configs and the JAX ``init_params`` tree as
    numpy (drawn once per arch and dtype)."""
    jcfg = jax_smoke(jax_get_arch(arch)).replace(dtype=dtype)
    tcfg = smoke_variant(get_arch(arch)).replace(dtype=dtype)
    return jcfg, tcfg, jax_tree(arch, dtype)


@functools.lru_cache(maxsize=None)
def jax_tree(arch, dtype):
    jcfg = jax_smoke(jax_get_arch(arch)).replace(dtype=dtype)
    return jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))


def batches(cfg, rng, B=B, S=S):
    """The numpy batch of tests/test_arch_smoke.py's shapes, random tokens."""
    n_text = S - (cfg.num_patch_tokens or 0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_text)).astype(np.int32)}
    if cfg.num_patch_tokens:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_trees_close(got, want, rtol, atol, scale=LEAF_SCALE):
    """Leaf by leaf, matched by path (JAX flattens dicts in key order, the
    port in insertion order): |got - want| <= atol + scale * max|want| +
    rtol * |want|, the max taken over the leaf (float32 summation noise is
    relative to a leaf's largest terms, not to each entry)."""
    got, want = flat_port(got), flat_jax(want)
    assert got.keys() == want.keys()
    for key, g in got.items():
        w = np.asarray(want[key], np.float32)
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=rtol,
                                   atol=atol + scale * float(np.abs(w).max()), err_msg=key)


def flat_jax(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_port(tree, path=""):
    """A port tree flattened to ``jax.tree_util.keystr``-style paths."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat_port(sub, f"{path}[{key!r}]").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat_port(sub, f"{path}[{i}]").items()}
    return {path: tree}
