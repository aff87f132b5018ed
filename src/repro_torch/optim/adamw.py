"""Optimizers of the training path, ported from ``repro.optim.adamw``:
``cosine_schedule``, ``AdamW`` and ``sgd_momentum`` over the port's
parameter trees (dicts and lists of tensors).

The JAX optimizers return new trees; these update the parameters and the
moments IN PLACE and return the same trees (with a new state dict), because
a full-width model has no room for a second copy: qwen2.5-3b's stacked MLP
weight alone is 812 M elements, 3.2 GB per float32 temporary, beside some
54 GB of parameters, gradients, accumulator and moments. Each leaf is
updated in chunks along its leading axis (``CHUNK_ELEMENTS`` at most), with
the reference's arithmetic in float32 and the result cast back to the
parameter's dtype. The step counter, the schedule and the bias corrections
are host scalars, so an update reads nothing back from the device; the
gradient clip stays a device scalar.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Union

import numpy as np
import torch

from repro_torch.params import tree_leaves, tree_map

# elements of the largest slice updated at once (256 MB of float32)
CHUNK_ELEMENTS = 1 << 26
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable[[int], float]:
    """lr(step): linear warmup over ``warmup`` steps, then a cosine decay to
    0 at ``total``; float32 arithmetic, as the reference's, returned as a
    Python float."""
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        warm = f32(base_lr) * step / f32(max(warmup, 1))
        progress = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)), f32(0), f32(1))
        cos = f32(0.5 * base_lr) * (f32(1) + np.cos(f32(math.pi) * progress))
        return float(warm if step < warmup else cos)

    return lr


def _chunks(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of t along its leading axis, each of at most CHUNK_ELEMENTS
    elements (t itself when it is small or 0-d)."""
    if t.dim() == 0 or t.numel() <= CHUNK_ELEMENTS:
        return [t]
    rows = max(1, CHUNK_ELEMENTS // (t.numel() // t.shape[0]))
    return list(torch.split(t, rows, dim=0))


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum over the leaves of sum(g.float()**2)), a float32 device
    scalar; each leaf squared chunk by chunk."""
    total = None
    for g in tree_leaves(grads):
        for c in _chunks(g):
            sq = c.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _pow_f32(base: float, step: int) -> float:
    """float32(base) ** step correctly rounded to float32 (JAX's float32
    ``pow`` is; torch's is not): taken in float64, then rounded."""
    return float(np.float32(float(np.float32(base)) ** step))


@dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    momentum_dtype: str = "float32"  # "bfloat16" halves first-moment memory

    def init(self, params) -> Dict[str, Any]:
        """{step: 0 (a host int32 scalar), m: zeros in momentum_dtype, v:
        float32 zeros}, m and v shaped and placed as the parameters."""
        mdt = _DTYPES[self.momentum_dtype]
        return {
            "step": torch.zeros((), dtype=torch.int32),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
        }

    @torch.no_grad()
    def update(self, params, grads, state):
        """One step, in place: grads clipped to a global norm of
        ``grad_clip``, the moments updated, bias-corrected, and the
        parameters moved by lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
        Returns (params, {step + 1, m, v}), the same tensors updated."""
        step = int(state["step"]) + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        clip = torch.clamp(self.grad_clip / (global_norm(grads) + 1e-9), max=1.0)
        bc1 = float(np.float32(1) - np.float32(_pow_f32(self.b1, step)))
        bc2 = float(np.float32(1) - np.float32(_pow_f32(self.b2, step)))
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m), _chunks(v)):
                self._update_chunk(pc, gc, mc, vc, clip, lr, bc1, bc2)
        return params, {"step": torch.tensor(step, dtype=torch.int32), "m": state["m"],
                        "v": state["v"]}

    def _update_chunk(self, p, g, m, v, clip, lr, bc1, bc2):
        g32 = g.float() * clip
        if m.dtype == torch.float32:
            m.mul_(self.b1).add_(g32, alpha=1 - self.b1)
        else:
            m.copy_(m.float().mul_(self.b1).add_(g32, alpha=1 - self.b1))
        v.mul_(self.b2).addcmul_(g32, g32, value=1 - self.b2)
        del g32
        denom = v.div(bc2).sqrt_().add_(self.eps)            # sqrt(v_hat) + eps
        delta = m.float().div(bc1).div_(denom)               # m_hat / denom
        del denom
        p32 = p.float()                                      # p itself when float32
        delta.add_(p32, alpha=self.weight_decay)
        if p32 is p:
            p.sub_(delta, alpha=lr)
        else:
            p.copy_(p32.sub_(delta, alpha=lr))


@dataclass(frozen=True)
class sgd_momentum:
    lr: float = 1e-2
    momentum: float = 0.9

    def init(self, params) -> Dict[str, Any]:
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)}

    @torch.no_grad()
    def update(self, params, grads, state):
        """m = momentum * m + g (float32), p -= lr * m, in place. Returns
        (params, {m})."""
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"])):
            for pc, gc, mc in zip(_chunks(p), _chunks(g), _chunks(m)):
                mc.mul_(self.momentum).add_(gc.float())
                if pc.dtype == torch.float32:
                    pc.sub_(mc, alpha=self.lr)
                else:
                    pc.copy_(pc.float().sub_(mc, alpha=self.lr))
        return params, {"m": state["m"]}
