"""Arrival and SLO-class arithmetic of the traffic mixes.

Frozen copy of ``src/repro_torch/core/workload.py`` as of this benchmark's
first version: ``poisson_gaps`` is ``_poisson_arrivals`` written as
gaps and ``choose_classes`` the class mixture draw of ``generate``. The
benchmark reads these and not the program's module, so a change to the
program cannot move the yardstick.

Against the seed's pull on the work done, a mix draws its sizes and its
arrival trace once from its own ``pool_seed``; a run's ``--seed`` only
orders the sizes, so every seed offers the same work.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def poisson_gaps(rng: np.random.Generator, rate: float, n: int) -> np.ndarray:
    """``n`` inter-arrival gaps of a homogeneous Poisson process at ``rate``."""
    return rng.exponential(1.0 / rate, n)


def choose_classes(rng: np.random.Generator, weights: Sequence[float], n: int) -> np.ndarray:
    """``n`` class indices drawn from the (unnormalized) mixture ``weights``."""
    w = np.asarray(weights, float)
    return np.asarray([int(rng.choice(len(w), p=w / w.sum())) for _ in range(n)])


def log_uniform_ints(rng: np.random.Generator, lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integers in [lo, hi] whose logarithm is uniform."""
    x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), n))
    return np.clip(np.floor(x).astype(np.int64), lo, hi)
