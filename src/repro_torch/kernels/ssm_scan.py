"""Selective scan (the Mamba heads of Hymba): a CUDA kernel for the dense
backend's hybrid stacks, and its plain PyTorch version.

``ssm_scan`` ports the Pallas kernel of ``repro.kernels.ssm_scan``: per
batch row, channel d and state index n, with h carried from ``h0`` and
A = -exp(a_log) in float32,

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,    y_t = C_t . h_t.

On CUDA tensors the wrapper launches the hand-written kernel in
``csrc/ssm_scan.cu`` (built on first use, see ``kernels._build``) on the
current stream and counts the launch in its ``launches`` attribute; on CPU
tensors it runs ``ref_ssm_scan``. There is no fallback from one to the
other: a CUDA input the kernel does not take raises. The kernel takes dt, x,
B and C in float32 or bfloat16 (one dtype), N = 16 or 8 and any S >= 1, and
honours ``h0`` (the Pallas kernel zeroes its state).

bf16: both versions widen dt and x to float32 and multiply them there, as the
Pallas kernel does. The JAX package's default path (``apply_ssm`` without
``use_kernel``) rounds dt * x to the model dtype before its scan; in float32
the two are the same.

``ref_ssm_scan`` is the contract of ``repro.kernels.ref.ssm_scan_ref``: the
sequential recurrence in float32, here continued from ``h0``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import _check, _raise_on_error

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STATES = (8, 16)   # the N instantiations in csrc/ssm_scan.cu


def ref_ssm_scan(dt, x, bm, cm, a_log, h0: Optional[torch.Tensor] = None):
    """Plain version of ``ssm_scan``. dt, x: (B, S, Di) with S >= 1; bm, cm:
    (B, S, N); a_log: (Di, N); h0: (B, Di, N) or None (zeros). Returns (y
    (B, S, Di) float32, final h (B, Di, N) float32)."""
    B, S, Di = dt.shape
    N = bm.shape[-1]
    a = -torch.exp(a_log.float())
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float())
    dt, x, bm, cm = (t.float() for t in (dt, x, bm, cm))
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * a[None])
        h = da * h + (dt[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    return torch.stack(ys, dim=1), h


def ssm_scan(dt, x, bm, cm, a_log, h0: Optional[torch.Tensor] = None, *,
             h_out: Optional[torch.Tensor] = None):
    """The selective scan over S steps. dt, x: (B, S, Di); bm, cm: (B, S,
    N); a_log: (Di, N); h0: (B, Di, N) float32 or None (zeros). Returns (y
    (B, S, Di) float32, final h (B, Di, N) float32). ``h_out``, if given,
    receives the final h and is returned; it may be ``h0`` itself (the
    decode step updates its cache slice in place). CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    if dt.device.type == "cpu":
        y, h = ref_ssm_scan(dt, x, bm, cm, a_log, h0)
        if h_out is None:
            return y, h
        h_out.copy_(h)
        return y, h_out
    name = "ssm_scan"
    _check(name, dt.is_cuda, f"unsupported device {dt.device}")
    _check(name, dt.dim() == 3 and bm.dim() == 3, "dt, x must be (B, S, Di), B, C (B, S, N)")
    B, S, Di = dt.shape
    N = bm.shape[-1]
    _check(name, B >= 1 and S >= 1, f"B and S must be >= 1, got {B} and {S}")
    _check(name, tuple(x.shape) == (B, S, Di), "x must have dt's shape")
    _check(name, tuple(bm.shape) == tuple(cm.shape) == (B, S, N), "B and C must be (B, S, N)")
    _check(name, N in _STATES, f"the state size must be one of {_STATES}, got {N}")
    _check(name, dt.dtype in _DTYPE_CODES and all(t.dtype == dt.dtype for t in (x, bm, cm)),
           f"dt, x, B and C must share float32 or bfloat16, got "
           f"{dt.dtype}/{x.dtype}/{bm.dtype}/{cm.dtype}")
    _check(name, tuple(a_log.shape) == (Di, N), "a_log must be (Di, N)")
    a_log = a_log.to(dtype=torch.float32).contiguous()
    for t, what in ((h0, "h0"), (h_out, "h_out")):
        if t is not None:
            _check(name, tuple(t.shape) == (B, Di, N) and t.dtype == torch.float32,
                   f"{what} must be (B, Di, N) float32")
    tensors = [dt, x, bm, cm, a_log] + [t for t in (h0, h_out) if t is not None]
    for t in tensors:
        _check(name, t.device == dt.device, "all tensors must be on dt's device")
        _check(name, t.is_contiguous(), "all tensors must be contiguous")
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dt.device)
    out = (h_out if h_out is not None
           else torch.empty((B, Di, N), dtype=torch.float32, device=dt.device))
    from repro_torch.kernels._build import load_library

    lib = load_library("ssm_scan").lib
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.ssm_selective_scan(
            _DTYPE_CODES[dt.dtype], dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a_log.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            out.data_ptr(), B, S, Di, N, stream,
        )
    _raise_on_error(name, err)
    ssm_scan.launches += 1
    return y, out


ssm_scan.launches = 0


def reset_launch_counts() -> None:
    """Zero the wrapper's launch counter."""
    ssm_scan.launches = 0
