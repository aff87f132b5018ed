"""RWKV-6 WKV recurrence: a CUDA kernel for the dense backend's RWKV-6
stacks, and its plain PyTorch version.

``rwkv6_chunked`` ports the Pallas kernel of ``repro.kernels.rwkv6_scan``:
per batch row and head, with a (hd x hd) state S carried from ``state0``,

    y_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T.

On CUDA tensors the wrapper launches the hand-written kernels in
``csrc/rwkv6_scan.cu`` (built on first use, see ``kernels._build``) on the
current stream and counts the call in its ``launches`` attribute (one per
call, however many CUDA kernels it runs); on CPU tensors it runs
``ref_rwkv6_chunked``. There is no fallback from one to the
other: a CUDA input the kernel does not take raises. The kernel takes r, k
and v in float32 or bfloat16 (one dtype), w in float32, head_dim 32 or 64
and any S >= 1, and honours ``state0`` (the Pallas kernel zeroes its state).

The kernel cuts the time axis into segments (``wkv_segments``): a
segment pass gives each segment's end state from a zero state and its
decay (chunk by chunk, its products on the tensor cores in split tf32),
and an output pass rebuilds each segment's start state from those (the
carry) and reruns the recurrence over it with y. Decode (a few steps) runs
one kernel without segments.

``ref_rwkv6_chunked`` is the contract of ``repro.kernels.ref.rwkv6_ref``
(and of ``repro.models.rwkv6.wkv_scan``): the sequential recurrence in
float32.
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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)   # the head_dim instantiations in csrc/rwkv6_scan.cu

# the time axis: at most this many steps run as one segment in the kernel
# without staging (``kDirectMax`` in csrc/rwkv6_scan.cu); segments of at
# least _MIN_SEGMENT steps otherwise
_DIRECT_MAX = 16
_MIN_SEGMENT = 32


def even_segments(S: int, n: int):
    """(n_seg, seg_len): S >= 1 steps cut into at most n segments of
    ``seg_len`` steps, the last one taking what remains; none is empty."""
    seg = -(-S // max(1, min(n, S)))
    return -(-S // seg), seg


def wkv_segments(slots: int, B: int, H: int, S: int):
    """(n_seg, seg_len) of the WKV kernel, from shapes alone: one segment
    when S <= _DIRECT_MAX (decode), else as many segments as let the
    ``n_seg * B * H`` blocks of the output pass (one a (row, head,
    segment)) run in one wave of the card's ``slots`` (SMs times the
    blocks an SM holds), each at least _MIN_SEGMENT steps long."""
    if S <= _DIRECT_MAX:
        return 1, S
    return even_segments(S, min(slots // (B * H), S // _MIN_SEGMENT))


@functools.lru_cache(maxsize=None)
def output_slots(device_index: int, dtype: torch.dtype, hd: int) -> int:
    """Output-pass blocks the card holds at once: its SMs times the blocks
    an SM holds (the CUDA occupancy query)."""
    from repro_torch.kernels._build import load_library

    per_sm = load_library("rwkv6_scan").lib.wkv_output_blocks_per_sm(_DTYPE_CODES[dtype], hd)
    _raise_on_error("rwkv6_chunked", max(0, -per_sm))
    return _sm_count(device_index) * per_sm


def ref_rwkv6_chunked(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """Plain version of ``rwkv6_chunked``. r, k, v, w: (B, S, H, hd) with
    S >= 1; u: (H, hd); state0: (B, H, hd, hd) or None (zeros). Returns (y
    (B, S, H, hd) float32, final state (B, H, hd, hd) float32)."""
    B, S, H, hd = r.shape
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def rwkv6_chunked(r, k, v, w, u, state0: Optional[torch.Tensor] = None, *,
                  state_out: Optional[torch.Tensor] = None):
    """The WKV recurrence over S steps. r, k, v, w: (B, S, H, hd); u: (H,
    hd); state0: (B, H, hd, hd) float32 or None (zeros). Returns (y (B, S,
    H, hd) float32, final state (B, H, hd, hd) float32). ``state_out``, if
    given, receives the final state and is returned; it may be ``state0``
    itself (the decode step updates its cache slice in place). CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    if r.device.type == "cpu":
        y, state = ref_rwkv6_chunked(r, k, v, w, u, state0)
        if state_out is None:
            return y, state
        state_out.copy_(state)
        return y, state_out
    name = "rwkv6_chunked"
    _check(name, r.is_cuda, f"unsupported device {r.device}")
    refuse_grad(name, r, k, v, w, u, state0)
    _check(name, r.dim() == 4, "r, k, v and w must be (B, S, H, hd)")
    B, S, H, hd = r.shape
    _check(name, B >= 1 and S >= 1, f"B and S must be >= 1, got {B} and {S}")
    for t in (k, v, w):
        _check(name, tuple(t.shape) == (B, S, H, hd), "r, k, v and w must share one shape")
    _check(name, r.dtype in _DTYPE_CODES and k.dtype == r.dtype and v.dtype == r.dtype,
           f"r, k and v must share float32 or bfloat16, got {r.dtype}/{k.dtype}/{v.dtype}")
    _check(name, w.dtype == torch.float32, f"w must be float32, got {w.dtype}")
    _check(name, hd in _HEAD_DIMS, f"head_dim must be one of {_HEAD_DIMS}, got {hd}")
    _check(name, tuple(u.shape) == (H, hd), "u must be (H, hd)")
    u = u.to(dtype=torch.float32).contiguous()
    for t, what in ((state0, "state0"), (state_out, "state_out")):
        if t is not None:
            _check(name, tuple(t.shape) == (B, H, hd, hd) and t.dtype == torch.float32,
                   f"{what} must be (B, H, hd, hd) float32")
    tensors = [r, k, v, w, u] + [t for t in (state0, state_out) if t is not None]
    for t in tensors:
        _check(name, t.device == r.device, "all tensors must be on r's device")
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    out = (state_out if state_out is not None
           else torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device))
    from repro_torch.kernels._build import load_library

    lib = load_library("rwkv6_scan").lib
    n_seg, seg_len = wkv_segments(output_slots(r.device.index, r.dtype, hd), B, H, S)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        seg_state = seg_decay = None
        if n_seg > 1:   # the segments' end states and decays
            seg_state = _scratch(r.device, stream, "wkv_state", B * H * n_seg * hd * hd).data_ptr()
            seg_decay = _scratch(r.device, stream, "wkv_decay", B * H * n_seg * hd).data_ptr()
        err = lib.wkv_rwkv6(
            _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state0.data_ptr() if state0 is not None else None, y.data_ptr(),
            out.data_ptr(), seg_state, seg_decay, B, S, H, hd, n_seg, seg_len, stream,
        )
    _raise_on_error(name, err)
    rwkv6_chunked.launches += 1
    rwkv6_chunked.segments = (n_seg, seg_len)
    return y, out


rwkv6_chunked.launches = 0
rwkv6_chunked.segments = None   # (n_seg, seg_len) of the last call on the card


def reset_launch_counts() -> None:
    """Zero the wrapper's launch counter."""
    rwkv6_chunked.launches = 0
