"""Selective SSM (Mamba-style) branch of Hymba's hybrid heads, ported from
``repro.models.ssm``.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,    y_t = C_t . h_t + D x_t

with input-dependent dt, B and C and a causal depthwise convolution in
front. The serve state is the convolution's tail (B, K-1, Di) and h (B, Di,
N) float32. The recurrence always runs through the kernel wrappers of
``kernels.ssm_scan``: ``ssm_scan`` (the CUDA kernel on the card, its plain
sequential version on the CPU, from the carried h), or under grad its
autograd Function ``trainable_ssm_scan``, whose backward is a CUDA kernel
too. Parameters carry an optional leading layer-group axis
(``lead``), as in ``transformer.init_layer``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan, trainable_ssm_scan
from repro_torch.models.layers import dense_init


def init_ssm(generator, cfg, dtype, device, lead=()):
    """SSM params with the JAX tree, shapes and init scales: projections at
    1/sqrt(d_in), ``conv_w`` N(0, 0.1), ``conv_b`` zero, ``dt_bias`` -4.6
    (softplus^-1(0.01)), ``A_log`` = log(1..N) for every channel, ``D``
    one. The inner width is d_model."""
    d = cfg.d_model
    di = d
    n = cfg.ssm_state
    dt_rank = max(1, di // 64)
    mk = lambda *shape, scale=None: dense_init(generator, (*lead, *shape), dtype, device,
                                               scale=scale)
    full = lambda value, *shape: torch.full((*lead, *shape), value, dtype=dtype, device=device)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    return {
        "w_in": mk(d, 2 * di),
        "conv_w": mk(cfg.ssm_conv, di, scale=0.1),
        "conv_b": full(0.0, di),
        "w_x": mk(di, dt_rank + 2 * n),
        "w_dt": mk(dt_rank, di),
        "dt_bias": full(-4.6, di),
        "A_log": a_log.expand(*lead, di, n).to(dtype).contiguous(),
        "D": full(1.0, di),
        "w_out": mk(di, d),
    }


def _causal_depthwise_conv(x, w, b, conv_tail=None):
    """x: (B, S, Di); w: (K, Di); ``conv_tail`` (B, K-1, Di) carries the
    previous inputs (zeros: a prompt's start). Returns (y, new tail)."""
    K = w.shape[0]
    if conv_tail is None:
        conv_tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_tail, x], dim=1)   # (B, S + K - 1, Di)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(K)) + b
    return y, xp[:, -(K - 1):, :]


def apply_ssm(params, x, cfg, conv_tail=None, h0=None, h_out=None):
    """x: (B, S, D) -> (out, (new conv tail, h)). ``conv_tail`` (B, K-1, D)
    and ``h0`` (B, D, N) float32 carry the state (zeros when absent);
    ``h_out`` receives the new h (it may be ``h0``: the decode step updates
    its cache slice in place). The JAX function's default path: y cast to
    the model dtype, plus D x, times silu(z), then the output projection.
    Under grad mode with an input or parameter that requires grad (and no
    ``h_out``), the scan goes through ``trainable_ssm_scan``."""
    n = cfg.ssm_state
    dt_rank = max(1, x.shape[2] // 64)
    xz = x @ params["w_in"]
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_c, new_tail = _causal_depthwise_conv(x_in, params["conv_w"], params["conv_b"], conv_tail)
    x_c = F.silu(x_c)
    dbc = x_c @ params["w_x"]                                   # (B, S, dt_rank + 2n)
    dt = F.softplus(dbc[..., :dt_rank] @ params["w_dt"] + params["dt_bias"])
    bm = dbc[..., dt_rank:dt_rank + n].contiguous()
    cm = dbc[..., dt_rank + n:].contiguous()
    scan_in = (dt, x_c, bm, cm, params["A_log"], h0)
    if h_out is None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in scan_in):
        y, h = trainable_ssm_scan(*scan_in)
    else:
        y, h = ssm_scan(*scan_in, h_out=h_out)
    y = y.to(x.dtype) + params["D"] * x_c
    y = y * F.silu(z)
    return y @ params["w_out"], (new_tail, h)

