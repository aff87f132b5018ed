"""One ``sgd_momentum`` train step for every arch of ``ARCHS`` against the
JAX package on the CPU, at smoke width in float32, on the same numpy
weights and batch, as tests/test_arch_smoke.py's ``test_train_step`` runs
it: the loss, aux loss and total of ``loss_fn``, the grad norm, the moved
parameters and the momentum (``STEP_TOL``, beside each leaf's largest
entry: two float32 stacks in different summation orders). On the CPU the
port's wrappers run their plain versions, so every stack of the zoo trains
here (on the card only the forms with a backward kernel do). Apart from
tests/test_torch_train.py so that the two share the workers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import make_train_step as jax_make_train_step
from repro.optim import sgd_momentum as jax_sgd
from repro_torch.models import make_train_step
from repro_torch.optim import sgd_momentum
from repro_torch.params import params_from_numpy, tree_leaves
from train_harness import STEP_TOL, assert_trees_close, batches, setup, torch_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sgd_train_step_against_jax(arch):
    jcfg, tcfg, tree = setup(arch)
    batch = batches(jcfg, np.random.default_rng(2))
    jopt = jax_sgd(lr=1e-2)
    jparams = jax.tree.map(jnp.asarray, tree)
    want_params, want_state, want = jax.jit(jax_make_train_step(jcfg, jopt))(
        jparams, jopt.init(jparams), jax.tree.map(jnp.asarray, batch))
    opt = sgd_momentum(lr=1e-2)
    params = params_from_numpy(tcfg, tree, "cpu")
    params, state, got = make_train_step(tcfg, opt)(params, opt.init(params),
                                                    torch_batch(batch))
    for key in ("loss", "aux_loss", "total"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
    assert any(not torch.equal(p0, p.detach())           # the parameters moved
               for p0, p in zip(tree_leaves(params_from_numpy(tcfg, tree, "cpu")),
                                tree_leaves(params)))
    assert_trees_close(params, want_params, **STEP_TOL)
    assert_trees_close(state["m"], want_state["m"], **STEP_TOL)
