"""The control of the served-model comparison: the plain reference put in
the program's place and computed one precision below the configuration's
bfloat16, in fp8 (e4m3, the H100's own 8-bit float): every linear layer's
weight rounded to e4m3 with a scale per output column, its input to e4m3
with a scale per row, the product accumulated in float32. Attention and
the norms stay in float32.

It does not decode: at each position of the same prompts and served
tokens, the token the control puts first is read against the float32
reference (``control_gap``). A sound comparison has to find that gap above
its limit.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ragbench.reference import decoder

E4M3_MAX = 448.0


def _round_e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale along ``dim`` (its absolute
    maximum maps to 448), returned in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _round_e4m3(x, -1) @ _round_e4m3(w, 0)


def control_gap(m: dict, weights, served: Sequence[decoder.Served], device) -> float:
    """The widest gap, below the float32 reference's best, of the token the
    fp8 control ranks first at each answer position."""
    ref = decoder.logits(m, weights, served, device)
    low = decoder.logits(m, weights, served, device, linear=fp8_linear)
    worst = 0.0
    for r, lo in zip(ref, low):
        pick = lo.argmax(dim=1)
        gap = r.max(dim=1).values - r.gather(1, pick[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst
