"""Token sampling for the generation engine, ported from
``repro.serving.sampler``."""
from __future__ import annotations

import numpy as np
import torch


def sample_tokens(generator, logits, temperature=0.0, top_k: int = 0):
    """logits: (B, V) -> (B,) int32 on the logits' device.

    ``temperature`` is a python scalar or a (B,) host array of per-row
    temperatures; rows with temperature <= 0 decode greedily (``argmax``,
    first index on ties, as JAX). Rows above 0 draw from the softmax of
    ``logits / t`` with Gumbel noise from ``generator`` (a ``torch.Generator``
    on the logits' device): they match JAX in distribution, not bit for bit.
    The greedy/sampled choice is made on the host, so a greedy batch costs
    no random draws."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = np.asarray(temperature, np.float32)
    if not (t > 0.0).any():
        return greedy
    tt = torch.as_tensor(np.maximum(t, 1e-6), device=logits.device)
    scaled = logits.float() / (tt if tt.dim() == 0 else tt[:, None])
    if top_k:
        vals, _ = torch.topk(scaled, top_k, dim=-1)
        scaled = torch.where(scaled >= vals[:, -1:], scaled,
                             torch.full_like(scaled, -1e30))
    u = torch.rand(scaled.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    if t.ndim == 0:
        return sampled
    return torch.where(torch.as_tensor(t > 0.0, device=logits.device),
                       sampled, greedy)
