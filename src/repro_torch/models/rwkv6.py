"""RWKV-6 (Finch) time mixing and channel mixing, ported from
``repro.models.rwkv6``.

Data-dependent decay linear attention [arXiv:2404.05892]:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T            (per head, S in R^{hd x hd})
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with w_t = exp(-exp(decay(x_t))) from a low-rank MLP. The recurrence always
runs through the kernel wrappers of ``kernels.rwkv6_scan``:
``rwkv6_chunked`` (the CUDA kernel on the card, its plain sequential
version, the JAX package's ``wkv_scan``, on the CPU), or under grad its
autograd Function ``trainable_rwkv6_chunked``, whose backward is a CUDA
kernel too. Parameters carry an optional leading layer-group axis (``lead``), as
in ``transformer.init_layer``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import rwkv6_chunked, trainable_rwkv6_chunked
from repro_torch.models.layers import dense_init, group_norm

MIX_LORA = 32      # ddlerp low-rank dim (TIME_MIX_EXTRA_DIM)
DECAY_LORA = 64    # decay low-rank dim (TIME_DECAY_EXTRA_DIM)
N_MIX = 5          # w, k, v, r, g


def init_rwkv6(generator, cfg, dtype, device, lead=()):
    """Time-mixing params with the JAX tree, shapes and init scales: the
    LoRAs at 0.01, the projections at 1/sqrt(d_in), ``mu_*``,
    ``decay_base`` and ``u`` zero, ``ln_x`` one."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    zeros = lambda *shape: torch.zeros((*lead, *shape), dtype=dtype, device=device)
    mk = lambda *shape, scale=None: dense_init(generator, (*lead, *shape), dtype, device,
                                               scale=scale)
    return {
        "mu_first": zeros(d),
        "mix_w1": mk(d, N_MIX * MIX_LORA, scale=0.01),
        "mix_w2": mk(N_MIX, MIX_LORA, d, scale=0.01),
        "mu_base": zeros(N_MIX, d),
        "wr": mk(d, d),
        "wk": mk(d, d),
        "wv": mk(d, d),
        "wg": mk(d, d),
        "wo": mk(d, d),
        "decay_base": zeros(d),
        "decay_w1": mk(d, DECAY_LORA, scale=0.01),
        "decay_w2": mk(DECAY_LORA, d, scale=0.01),
        "u": zeros(h, hd),
        "ln_x": torch.ones((*lead, d), dtype=dtype, device=device),
    }


def init_rwkv6_ffn(generator, cfg, dtype, device, lead=()):
    """Channel-mixing params: ``mu_k``/``mu_r`` zero, projections at
    1/sqrt(d_in)."""
    d, f = cfg.d_model, cfg.d_ff
    zeros = lambda n: torch.zeros((*lead, n), dtype=dtype, device=device)
    mk = lambda d_in, d_out: dense_init(generator, (*lead, d_in, d_out), dtype, device)
    return {"mu_k": zeros(d), "mu_r": zeros(d), "wk": mk(d, f), "wv": mk(f, d),
            "wr": mk(d, d)}


def _shifted(x, x_prev_last):
    """The sequence shifted by one step: x_prev_last (B, D), or zeros, first."""
    if x_prev_last is None:
        x_prev_last = torch.zeros_like(x[:, 0])
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(params, x, x_prev):
    """Data-dependent lerp between x and the shifted sequence.
    x, x_prev: (B, S, D) -> five mixed streams (w, k, v, r, g)."""
    B, S, _ = x.shape
    xx = x_prev - x
    xxx = x + xx * params["mu_first"]
    lora = torch.tanh(xxx @ params["mix_w1"]).reshape(B, S, N_MIX, MIX_LORA)
    mu = params["mu_base"] + torch.einsum("bsnm,nmd->bsnd", lora, params["mix_w2"])
    mixed = x[:, :, None, :] + xx[:, :, None, :] * mu  # (B, S, 5, D)
    return [mixed[:, :, i, :] for i in range(N_MIX)]


def _decay(params, xw):
    """w = exp(-exp(decay(xw))) in float32, in (0, 1)."""
    w = params["decay_base"] + torch.tanh(xw @ params["decay_w1"]) @ params["decay_w2"]
    return torch.exp(-torch.exp(w.float()))


def apply_rwkv6(params, x, cfg, x_prev_last=None, state=None, state_out=None):
    """Time mixing. x: (B, S, D); ``x_prev_last`` (B, D) and ``state`` (B,
    H, hd, hd) float32 carry the previous token and the WKV state (zeros
    when absent: a prompt's start). ``state_out`` receives the new state
    (it may be ``state``: the decode step updates its cache slice in
    place). Returns (out, (new x_prev_last, new state)). Under grad mode
    with an input or parameter that requires grad (and no ``state_out``),
    the recurrence goes through ``trainable_rwkv6_chunked``."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    xw, xk, xv, xr, xg = _ddlerp(params, x, _shifted(x, x_prev_last))
    r = (xr @ params["wr"]).reshape(B, S, H, hd)
    k = (xk @ params["wk"]).reshape(B, S, H, hd)
    v = (xv @ params["wv"]).reshape(B, S, H, hd)
    g = F.silu(xg @ params["wg"])
    w = _decay(params, xw).reshape(B, S, H, hd)
    wkv_in = (r, k, v, w, params["u"], state)
    if state_out is None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in wkv_in):
        y, state = trainable_rwkv6_chunked(*wkv_in)
    else:
        y, state = rwkv6_chunked(r, k, v, w, params["u"].float(), state, state_out=state_out)
    y = group_norm(y.reshape(B, S, D).to(x.dtype), params["ln_x"], H, eps=64e-5)
    return (y * g) @ params["wo"], (x[:, -1, :], state)


def apply_rwkv6_ffn(params, x, x_prev_last=None):
    """Channel mixing. x: (B, S, D). Returns (out, new x_prev_last)."""
    xx = _shifted(x, x_prev_last) - x
    xk = x + xx * params["mu_k"]
    xr = x + xx * params["mu_r"]
    k = torch.square(torch.relu(xk @ params["wk"]))
    return torch.sigmoid(xr @ params["wr"]) * (k @ params["wv"]), x[:, -1, :]
