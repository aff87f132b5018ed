"""Core building blocks, ported from ``repro.models.layers``.

Parameters are plain nested dicts of tensors with the JAX package's key
names. Every function keeps the layout of its JAX counterpart so the tests
compare like with like.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale) weights of ``shape`` (..., d_in, d_out), drawn in
    float32 from ``generator`` on its own device, then cast and moved.
    ``scale`` defaults to 1/sqrt(d_in), as ``repro``'s ``dense_init``. On
    the meta device (shapes only, as ``jax.eval_shape``) nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# normalization (accumulate in f32, cast back)
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-5):
    if x.dtype == torch.float32:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * scale
    # low-precision path: the variance accumulates in f32, the product is
    # taken in the input dtype (the bf16 contract of the JAX function)
    xf = x.float()
    var = torch.einsum("...d,...d->...", xf, xf) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * scale.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


def group_norm(x, scale, num_groups: int, eps: float = 1e-5):
    """Head-wise group norm (RWKV-6's ``ln_x``), in float32. x: (..., D)."""
    dtype = x.dtype
    *lead, d = x.shape
    x = x.float().reshape(*lead, num_groups, d // num_groups)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (x * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin), each (B, S, 1, head_dim/2) float32, for positions (B, S)
    or (S,). A step computes them once and every layer reuses them."""
    freqs = rope_frequencies(head_dim, theta, positions.device)   # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs                 # (B, S, hd/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope_tables(x, cos, sin):
    """Rotate x (B, S, H, hd) by precomputed ``rope_tables``."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,) integer."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# sinusoidal positions (whisper)
# ---------------------------------------------------------------------------


def _sinusoid(angle):
    """Interleave sin(angle) into the even and cos(angle) into the odd
    columns: angle (..., d_model / 2) -> (..., d_model) float32."""
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).flatten(-2)


def _timescales(d_model: int, device):
    """10000^(2i / d) in float32, rounded from float64: the correctly
    rounded power JAX takes (torch's float32 pow is an ulp off in about one
    entry in a hundred)."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device) / d_model
    return torch.pow(10000.0, dim.double()).float()


def sinusoidal_positions(seq_len: int, d_model: int, device=None):
    """Whisper-style sinusoidal position embeddings (seq_len, d_model)
    float32: column 2i of row p is sin(p / 10000^(2i / d)), column 2i + 1
    its cosine. The angles are divided by the timescales in float32, as the
    JAX function divides them."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    return _sinusoid(pos / _timescales(d_model, device)[None])


def sinusoidal_at(pos, d_model: int):
    """The sinusoidal embedding of each position in ``pos`` (any shape, int):
    (*pos.shape, d_model) float32, row for row ``sinusoidal_positions``."""
    angle = pos.float()[..., None] / _timescales(d_model, pos.device)
    return _sinusoid(angle)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model: int, d_ff: int, dtype, device, lead=(), act: str = "silu"):
    """SwiGLU weights (``w_gate``, ``w_up`` (d_model, d_ff), ``w_down``), or
    for ``act="gelu"`` (whisper) ``w_up``, a zero ``b_up``, ``w_down`` and a
    zero ``b_down``; weights at 1/sqrt(d_in); ``lead`` prepends the stacked
    layer-group axis."""
    mk = lambda d_in, d_out: dense_init(generator, (*lead, d_in, d_out), dtype, device)
    if act == "silu":
        return {"w_gate": mk(d_model, d_ff), "w_up": mk(d_model, d_ff),
                "w_down": mk(d_ff, d_model)}
    zeros = lambda n: torch.zeros((*lead, n), dtype=dtype, device=device)
    return {"w_up": mk(d_model, d_ff), "b_up": zeros(d_ff), "w_down": mk(d_ff, d_model),
            "b_down": zeros(d_model)}


def apply_mlp(params, x, act: str):
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return h @ params["w_down"] + params["b_down"]


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens):
    return params["table"][tokens.long()]


def unembed(params_embed, params_head, x, tied: bool):
    if tied:
        return x @ params_embed["table"].T
    return x @ params_head["w"]
