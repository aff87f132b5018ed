"""Selective scan (the Mamba heads of Hymba): a CUDA kernel for the dense
backend's hybrid stacks, and its plain PyTorch version.

``ssm_scan`` ports the Pallas kernel of ``repro.kernels.ssm_scan``: per
batch row, channel d and state index n, with h carried from ``h0`` and
A = -exp(a_log) in float32,

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,    y_t = C_t . h_t.

On CUDA tensors the wrapper launches the hand-written kernels in
``csrc/ssm_scan.cu`` (built on first use, see ``kernels._build``) on the
current stream and counts the call in its ``launches`` attribute (one per
call, however many CUDA kernels it runs); on CPU tensors it runs
``ref_ssm_scan``. There is no fallback from one to the
other: a CUDA input the kernel does not take raises. The kernel takes dt, x,
B and C in float32 or bfloat16 (one dtype), N = 16 or 8 and any S >= 1, and
honours ``h0`` (the Pallas kernel zeroes its state).

bf16: both versions widen dt and x to float32 and multiply them there, as the
Pallas kernel does. The JAX package's default path (``apply_ssm`` without
``use_kernel``) rounds dt * x to the model dtype before its scan; in float32
the two are the same.

The kernel cuts the time axis into segments (``ssm_segments``), as the
WKV kernel does: a segment pass gives each segment's end state from a zero
state and its sum of dt, and an output pass rebuilds each segment's start
state from those and reruns the scan over it with y. Decode (a few steps)
runs one kernel without segments or shared memory.

``ref_ssm_scan`` is the contract of ``repro.kernels.ref.ssm_scan_ref``: the
sequential recurrence in float32, here continued from ``h0``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (
    _check,
    _raise_on_error,
    _scratch,
    _sm_count,
    refuse_grad,
)
from repro_torch.kernels.rwkv6_scan import even_segments

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STATES = (8, 16)   # the N instantiations in csrc/ssm_scan.cu

# the time axis, as for the WKV kernel: at most _DIRECT_MAX steps run as one
# segment in the kernel without shared memory (``kDirectMax`` in
# csrc/ssm_scan.cu); otherwise segments of at least _MIN_SEGMENT steps. An
# output-pass block holds 4 states of 2 channels a thread, 128 threads.
_DIRECT_MAX = 16
_MIN_SEGMENT = 32
_BLOCK_STATES = 128 * 2 * 4


def ssm_segments(slots: int, B: int, Di: int, N: int, S: int):
    """(n_seg, seg_len) of the scan kernel, from shapes alone: one segment
    when S <= _DIRECT_MAX (decode), else as many segments as let the
    ``n_seg * B * ceil(Di / channels)`` blocks of the output pass run in one
    wave of the card's ``slots`` (SMs times the blocks an SM holds), each
    at least _MIN_SEGMENT steps long."""
    if S <= _DIRECT_MAX:
        return 1, S
    blocks = B * -(-Di // (_BLOCK_STATES // N))
    return even_segments(S, min(slots // blocks, S // _MIN_SEGMENT))


@functools.lru_cache(maxsize=None)
def output_slots(device_index: int, dtype: torch.dtype, N: int) -> int:
    """Output-pass blocks the card holds at once: its SMs times the blocks
    an SM holds (the CUDA occupancy query)."""
    from repro_torch.kernels._build import load_library

    per_sm = load_library("ssm_scan").lib.ssm_output_blocks_per_sm(_DTYPE_CODES[dtype], N)
    _raise_on_error("ssm_scan", max(0, -per_sm))
    return _sm_count(device_index) * per_sm


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
    refuse_grad(name, dt, x, bm, cm, a_log, h0)
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
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dt.device)
    out = (h_out if h_out is not None
           else torch.empty((B, Di, N), dtype=torch.float32, device=dt.device))
    from repro_torch.kernels._build import load_library

    lib = load_library("ssm_scan").lib
    n_seg, seg_len = ssm_segments(output_slots(dt.device.index, dt.dtype, N), B, Di, N, S)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        seg_h = seg_dsum = None
        if n_seg > 1:   # the segments' end states and sums of dt
            seg_h = _scratch(dt.device, stream, "ssm_h", B * n_seg * Di * N).data_ptr()
            seg_dsum = _scratch(dt.device, stream, "ssm_dsum", B * n_seg * Di).data_ptr()
        err = lib.ssm_selective_scan(
            _DTYPE_CODES[dt.dtype], dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a_log.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            out.data_ptr(), seg_h, seg_dsum, B, S, Di, N, n_seg, seg_len, stream,
        )
    _raise_on_error(name, err)
    ssm_scan.launches += 1
    ssm_scan.segments = (n_seg, seg_len)
    return y, out


ssm_scan.launches = 0
ssm_scan.segments = None   # (n_seg, seg_len) of the last call on the card


def reset_launch_counts() -> None:
    """Zero the wrapper's launch counter."""
    ssm_scan.launches = 0
