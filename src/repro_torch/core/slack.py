"""Online slack prediction: per-component linear latency models.

The paper's key SLO insight: individual component latencies correlate
strongly with upstream features (docs retrieved, token counts, iteration),
so the controller keeps lightweight online linear regressions per component
and refines each in-flight request's remaining-time estimate at every stage
boundary. slack = deadline - (now + predicted_remaining).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

FEATURES = ("tokens_in", "tokens_out", "k_docs", "docs_tokens", "iteration")


class OnlineLinearRegression:
    """Recursive least squares with forgetting (tracks workload drift)."""

    def __init__(self, n_features: int, lam: float = 0.995, ridge: float = 1e3):
        self.w = np.zeros(n_features + 1)
        self.P = np.eye(n_features + 1) * ridge
        self.lam = lam
        self.n_obs = 0

    def _x(self, feats: Sequence[float]) -> np.ndarray:
        return np.concatenate([[1.0], np.asarray(feats, dtype=np.float64)])

    def update(self, feats: Sequence[float], y: float):
        x = self._x(feats)
        Px = self.P @ x
        k = Px / (self.lam + x @ Px)
        self.w += k * (y - x @ self.w)
        self.P = (self.P - np.outer(k, Px)) / self.lam
        self.n_obs += 1

    def predict(self, feats: Sequence[float]) -> float:
        return float(max(self._x(feats) @ self.w, 0.0))


class SlackModel:
    """Predicts remaining execution time for a request given its current
    stage and the expected downstream path."""

    def __init__(self):
        self.models: Dict[str, OnlineLinearRegression] = {}
        self.fallback_mean: Dict[str, float] = {}

    def _vec(self, features: Dict[str, float]) -> List[float]:
        return [float(features.get(f, 0.0)) / 1000.0 for f in FEATURES]

    def observe(self, comp: str, features: Dict[str, float], latency_s: float):
        m = self.models.setdefault(comp, OnlineLinearRegression(len(FEATURES)))
        m.update(self._vec(features), latency_s)
        mu = self.fallback_mean.get(comp, latency_s)
        self.fallback_mean[comp] = 0.95 * mu + 0.05 * latency_s

    def predict_stage(self, comp: str, features: Dict[str, float]) -> float:
        m = self.models.get(comp)
        if m is None or m.n_obs < 8:
            return self.fallback_mean.get(comp, 0.02)
        return m.predict(self._vec(features))

    def predict_remaining(self, path: List[str], features: Dict[str, float]) -> float:
        return sum(self.predict_stage(c, features) for c in path)

    def slack(self, now: float, deadline: float, path: List[str],
              features: Dict[str, float]) -> float:
        return deadline - now - self.predict_remaining(path, features)
