"""Mixture-of-Experts layer (Mixtral top-2, Llama-4 top-1 plus a shared
expert), ported from ``repro.models.moe`` in plain torch.

Dispatch is scatter-based, as in the JAX function: each (token, route)
takes the next slot of its expert's (C+1)-row buffer in (token, route)
order, routes past the capacity C land in the drop row C, the experts run
as three batched products over the (E, C, D) buffer, and the outputs come
back through a zero row. The JAX function's sharding constraints and its
expert-parallel arm are layouts across devices; one device computes the
tensor-parallel arm's arithmetic, which is what this module does.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp

CAPACITY_FACTOR = 1.25


def _expert_weights(generator, shape, dtype, device):
    """(..., E, d_in, d_out) weights at 1/sqrt(d_in), drawn one (d_in,
    d_out) matrix at a time: the float32 draw of a whole stack of
    mixtral's experts at once would take 26 GB of device memory."""
    if torch.device(device).type == "meta":
        return dense_init(generator, shape, dtype, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    for idx in itertools.product(*map(range, shape[:-2])):
        out[idx] = dense_init(generator, shape[-2:], dtype, device)
    return out


def init_moe(generator, cfg, dtype, device, lead=()):
    """MoE params with the JAX tree, shapes and init scales: ``router``
    (D, E) N(0, 0.02), expert ``w_gate``/``w_up`` (E, D, F) at 1/sqrt(D),
    ``w_down`` (E, F, D) at 1/sqrt(F), and with ``n_shared_experts`` a
    SwiGLU ``shared`` expert of width n_shared_experts * F. ``lead``
    prepends the stacked layer-group axis."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(generator, (*lead, d, e), dtype, device, scale=0.02),
        "w_gate": _expert_weights(generator, (*lead, e, d, f), dtype, device),
        "w_up": _expert_weights(generator, (*lead, e, d, f), dtype, device),
        "w_down": _expert_weights(generator, (*lead, e, f, d), dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d, cfg.n_shared_experts * f, dtype, device, lead)
    return p


def expert_capacity(num_tokens: int, num_experts: int, top_k: int) -> int:
    """Capacity-factor routing for large token counts; dropless for small
    ones (decode steps), where a dropped route would make serving outputs
    differ from the no-cache forward."""
    if num_tokens <= 256:
        return num_tokens  # worst case: every token routes to one expert
    return max(1, int(num_tokens * top_k / num_experts * CAPACITY_FACTOR))


def route(params, xt, cfg, capacity: int):
    """The router of one chunk: xt (T, D) -> (probs (T, E) float32, onehot
    (T, K, E) int64, expert_idx (T, K), gates (T, K) in xt's dtype, pos (T,
    K), keep (T, K) bool). The top K experts are taken on the float32
    logits, ties to the lower expert index as ``jax.lax.top_k`` breaks them
    (a stable descending sort); the rest is ``assign``."""
    logits = (xt @ params["router"]).float()
    expert_idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1]
    return assign(logits, expert_idx[:, :cfg.num_experts_per_tok], cfg, capacity, xt.dtype)


def assign(logits, expert_idx, cfg, capacity: int, dtype):
    """The routes to the chosen experts ``expert_idx`` (T, K) on the float32
    router ``logits`` (T, E), as ``route`` returns them: the gates are the
    softmax over the K chosen logits (in ``dtype``), ``pos`` is a route's
    slot in its expert's buffer, counted in (token, route) order, and
    ``keep = pos < capacity``."""
    T, K = expert_idx.shape
    probs = torch.softmax(logits, dim=-1)
    gates = torch.softmax(logits.gather(1, expert_idx), dim=-1).to(dtype)
    onehot = F.one_hot(expert_idx, cfg.num_experts)
    flat = onehot.reshape(T * K, cfg.num_experts)
    pos = ((torch.cumsum(flat, dim=0) - flat).reshape(T, K, cfg.num_experts) * onehot).sum(dim=-1)
    return probs, onehot, expert_idx, gates, pos, pos < capacity


def apply_moe(params, x, cfg, max_chunk_tokens: int = 8192):
    """x: (B, S, D) -> (y (B, S, D), aux): the routed experts' outputs and
    the Switch load-balance loss. More than ``max_chunk_tokens`` tokens are
    dispatched in equal chunks (the fewest at most that long that divide
    B * S), each with its own capacity, and aux is the chunks' mean."""
    B, S, D = x.shape
    T_all = B * S
    if T_all > max_chunk_tokens:
        n_chunks = -(-T_all // max_chunk_tokens)
        while T_all % n_chunks:
            n_chunks += 1
        xc = x.reshape(n_chunks, T_all // n_chunks, 1, D)
        ys, auxs = zip(*(_moe_chunk(params, xi, cfg) for xi in xc))
        return torch.stack(ys).reshape(B, S, D), torch.stack(auxs).mean()
    return _moe_chunk(params, x, cfg)


def _moe_chunk(params, x, cfg):
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = expert_capacity(T, E, K)
    xt = x.reshape(T, D)
    probs, onehot, expert_idx, gates, pos, keep = route(params, xt, cfg, C)

    # scatter the routes into (E, C + 1, D); row C takes the dropped ones
    e_flat = expert_idx.reshape(-1)
    p_flat = torch.where(keep, pos, C).reshape(-1)
    buf = x.new_zeros((E, C + 1, D))
    buf[e_flat, p_flat] = xt.repeat_interleave(K, dim=0) if K > 1 else xt
    dispatched = buf[:, :C]

    h = F.silu(torch.bmm(dispatched, params["w_gate"]))
    h = h * torch.bmm(dispatched, params["w_up"])
    out_buf = torch.bmm(h, params["w_down"])                         # (E, C, D)

    # gather back through a zero row and combine over the K routes
    out_buf = torch.cat([out_buf, out_buf.new_zeros((E, 1, D))], dim=1)
    gathered = out_buf[e_flat, p_flat].reshape(T, K, D)
    y = (gathered * gates[..., None]).sum(dim=1).reshape(B, S, D)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x, "silu")

    frac_tokens = onehot.float().mean(dim=(0, 1))                   # (E,)
    frac_probs = probs.mean(dim=0)
    return y, E * torch.sum(frac_tokens * frac_probs)
