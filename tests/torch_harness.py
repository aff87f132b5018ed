"""Pieces the port's engine tests share (imported, not collected).

* ``bursty_workload``: the invariant harness's seeded workload
  (``tests/test_engine_invariants.py::_run_workload``, greedy) on an engine
  the caller builds, so the JAX engine and the port's take the same
  requests in the same order.
* ``record_plans``: the StepPlans an engine builds, in build order.

Nothing here imports JAX at import time: a test that runs without JAX can
use it.
"""
import numpy as np


def bursty_workload(eng, seed, long_decode):
    """Waves of submits with engine steps between them, then a drain.
    Prompts mix fresh sequences with a shared 32-token context;
    ``long_decode`` gives short prompts long decodes, which outgrow
    admission's slack block and run small pools dry. Returns the requests."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, 90, size=32).astype(np.int32)
    reqs = []
    for _ in range(4):
        for _ in range(int(rng.integers(1, 4))):
            if long_decode:
                prompt = rng.integers(0, 90, size=int(rng.integers(3, 13)))
                max_new = int(rng.integers(28, 39))
            else:
                if rng.random() < 0.4:
                    tail = rng.integers(0, 90, size=int(rng.integers(1, 12)))
                    prompt = np.concatenate([ctx, tail])
                else:
                    prompt = rng.integers(0, 90, size=int(rng.integers(3, 45)))
                max_new = int(rng.integers(2, 9))
            reqs.append(eng.submit(prompt, max_new=max_new, temperature=0.0,
                                   priority=float(rng.random())))
        for _ in range(int(rng.integers(0, 4))):
            eng.step()
    eng.run_until_done(max_steps=2000)
    return reqs


def record_plans(eng):
    """A list that collects the StepPlans ``eng`` builds from now on. The
    port's control plane keeps them itself (``ControlPlane.recorded``); a
    JAX engine's are taken by the JAX harness's own wrapper."""
    if hasattr(eng.control, "recorded"):
        eng.control.recorded = []
        return eng.control.recorded
    from test_engine_invariants import _capture_plans

    return _capture_plans(eng)
