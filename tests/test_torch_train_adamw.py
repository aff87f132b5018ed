"""Three AdamW train steps for every arch of ``ARCHS`` against the JAX
package on the CPU, at smoke width in float32, on the same numpy weights
and batches (frames and patches where the arch takes them, built as
tests/test_torch_train_archs.py builds them), in one microbatch, under
``cosine_schedule`` at two schedules: tests/test_torch_train.py's (lr 3e-3,
warmup 1) and the one ``chip_smoke.py``'s phases 18f and 18i train with
(lr 3e-4, warmup 1). Each step's loss, total and grad norm and the moments
are JAX's, and the parameters are held as ``test_adamw_steps_against_jax``
holds them (AdamW's first update is about lr * sign(g), so an element whose
gradient is below the two float32 summation orders' noise can move by up
to 2 lr apart). One case is a strict xfail: rwkv6-7b at lr 3e-3, whose
grad norm follows that split past the bound (ROADMAP §3). Apart from the
other training tests so that the three share the workers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import make_train_step as jax_make_train_step
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro_torch.models import make_train_step
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.params import params_from_numpy
from train_harness import STEP_TOL, assert_trees_close, batches, flat_jax, flat_port, setup, \
    torch_batch

torch.set_num_threads(1)

STEPS = 3
NOISE_SHARE = 1e-4       # of the parameters, as in tests/test_torch_train.py
SCHEDULES = {"lr3e-3": 3e-3, "lr3e-4": 3e-4}       # warmup 1, total STEPS
# ROADMAP §3: rwkv6-7b's f32 stack at lr 3e-3. The first update moves the
# near-zero-gradient elements up to 2 lr apart (both packages right), and
# step 2's grad norm follows them 1.8e-4 apart (bound 1e-4; from JAX's own
# parameters the port's is 9e-7 apart); at step 3's parameters the port's
# f32 grad norm is 4.9e-5 from a float64 reference, JAX's 5.7e-6
GAPS = {("rwkv6-7b", "lr3e-3"): "ROADMAP §3: rwkv6-7b's grad norm at lr 3e-3 follows its "
                                "parameters' near-zero-gradient split past 1e-4 at step 2"}
CASES = [pytest.param(a, s, marks=pytest.mark.xfail(strict=True, reason=GAPS[a, s]))
         if (a, s) in GAPS else (a, s) for a in sorted(ARCHS) for s in sorted(SCHEDULES)]


@pytest.mark.parametrize("arch,schedule", CASES)
def test_adamw_steps_every_arch_against_jax(arch, schedule):
    jcfg, tcfg, tree = setup(arch)
    peak = SCHEDULES[schedule]
    rng = np.random.default_rng(5)
    data = [batches(jcfg, rng) for _ in range(STEPS)]
    lr = cosine_schedule(peak, warmup=1, total=STEPS)
    jopt = JaxAdamW(lr=jax_cosine(peak, warmup=1, total=STEPS))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=1))
    opt = AdamW(lr=lr)
    params = params_from_numpy(tcfg, tree, "cpu")
    state = opt.init(params)
    step = make_train_step(tcfg, opt, microbatches=1)
    for batch in data:
        jparams, jstate, want = jstep(jparams, jstate, jax.tree.map(jnp.asarray, batch))
        params, state, got = step(params, state, torch_batch(batch))
        for key in ("loss", "total", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4,
                                       err_msg=key)
    assert int(state["step"]) == int(jstate["step"]) == STEPS
    assert_trees_close(state["m"], jstate["m"], rtol=1e-4, atol=0, scale=1e-3)
    assert_trees_close(state["v"], jstate["v"], rtol=1e-3, atol=0, scale=1e-3)
    got, want = flat_port(params), flat_jax(jparams)
    assert got.keys() == want.keys()
    moved_apart = 2 * sum(lr(i + 1) for i in range(STEPS))
    n_off = n_all = 0
    for key, g in got.items():
        g, w = g.detach().numpy(), np.asarray(want[key])
        np.testing.assert_allclose(g, w, rtol=0, atol=moved_apart, err_msg=key)
        n_off += int((np.abs(g - w) > STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(w)).sum())
        n_all += g.size
    assert n_off <= NOISE_SHARE * n_all, (n_off, n_all)
