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
other: a CUDA input the kernel does not take raises. On ``meta`` tensors
(the dry run) both wrappers return outputs of their contract's shapes and
dtypes and count their contract work in ``kernels.work.META_WORK``; they
launch nothing and run no plain loop (``kernels.work``'s meta rule). The
kernel takes r, k and v in float32 or bfloat16 (one dtype), w in float32,
head_dim 32 or 64 and any S >= 1, and honours ``state0`` (the Pallas
kernel zeroes its state).

The kernel cuts the time axis into segments (``wkv_segments``): a
segment pass gives each segment's end state from a zero state and its
decay (chunk by chunk, its products on the tensor cores in split tf32),
and an output pass rebuilds each segment's start state from those (the
carry) and reruns the recurrence over it with y. Decode (a few steps) runs
one kernel without segments.

``ref_rwkv6_chunked`` is the contract of ``repro.kernels.ref.rwkv6_ref``
(and of ``repro.models.rwkv6.wkv_scan``): the sequential recurrence in
float32.

The backward. ``rwkv6_chunked`` is forward-only (its outputs are filled
through ctypes), so on CUDA it refuses an input that requires grad under
grad mode. ``trainable_rwkv6_chunked`` runs it inside the autograd Function
``WKV6``, whose backward is ``rwkv6_chunked_backward``: the exact gradient
of the sequential float32 recurrence, which is what JAX takes (autodiff of
``chunked_scan`` over the ``step`` of ``repro.models.rwkv6.wkv_scan``; no
JAX caller sets ``use_kernel``). With G_t = dL/dS_t (S_t the state after
step t), run backward in time,

    G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   G_{S-1} = dstate,

dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t), dk_t = G_t v_t + r_t u (v_t .
dy_t), dv_t = G_t^T k_t + (r_t . u k_t) dy_t, dw_t = rowsum(G_t * S_{t-1})
and du = sum_t r_t k_t (v_t . dy_t). On CUDA tensors the wrapper launches
the hand-written kernels of ``csrc/rwkv6_scan_backward.cu`` (one count in
``launches`` a call); on CPU tensors it runs
``ref_rwkv6_chunked_backward``, the reverse recurrence written out step by
step. The kernels cut the time axis into segments of whole 16-step chunks
(``wkv_backward_segments``): local passes give each chunk's state and each
segment's adjoint from zero, and the output pass carries them across the
segments and takes every gradient of a chunk from the state before it and
the adjoint after it, never keeping a step's state.
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
from repro_torch.kernels.work import count_meta, scan_backward_work, wkv_work

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)   # the head_dim instantiations in csrc/rwkv6_scan.cu and its backward
# steps of a chunk of the backward kernels (``kT`` in
# csrc/rwkv6_scan_backward.cu): a backward segment is a whole number of
# chunks, and each chunk's gradients come from the state before it and the
# adjoint after it
BACKWARD_CHUNK = 16
_BACKWARD_MIN_CHUNKS = 2

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


def backward_segments(slots: int, blocks: int, S: int, chunk: int, min_chunks: int):
    """(n_seg, seg_len) of a scan's backward, from shapes alone: segments of
    whole ``chunk``-step chunks, as many as let ``n_seg * blocks`` blocks of
    its output pass run in one wave of the card's ``slots``, each at least
    ``min_chunks`` chunks long (one segment where S allows no more)."""
    n_chunk = -(-S // chunk)
    n_seg, per = even_segments(n_chunk, max(1, min(slots // blocks, n_chunk // min_chunks)))
    return n_seg, per * chunk


def wkv_backward_segments(slots: int, B: int, H: int, S: int):
    """(n_seg, seg_len) of the WKV backward: one output-pass block a (row,
    head, segment)."""
    return backward_segments(slots, B * H, S, BACKWARD_CHUNK, _BACKWARD_MIN_CHUNKS)


@functools.lru_cache(maxsize=None)
def block_slots(device_index: int, lib_name: str, fn_name: str, err_name: str,
                dtype: torch.dtype, arg: int) -> int:
    """Blocks of a pass the card holds at once: its SMs times the blocks an
    SM holds (``fn_name`` of ``lib_name``, the CUDA occupancy query)."""
    from repro_torch.kernels._build import load_library

    per_sm = getattr(load_library(lib_name).lib, fn_name)(_DTYPE_CODES[dtype], arg)
    _raise_on_error(err_name, max(0, -per_sm))
    return _sm_count(device_index) * per_sm


def backward_slots(device_index: int, dtype: torch.dtype, hd: int) -> int:
    """Backward output-pass blocks the card holds at once."""
    return block_slots(device_index, "rwkv6_scan_backward", "wkvb_output_blocks_per_sm",
                       "rwkv6_chunked_backward", dtype, hd)


def output_slots(device_index: int, dtype: torch.dtype, hd: int) -> int:
    """Output-pass blocks the card holds at once."""
    return block_slots(device_index, "rwkv6_scan", "wkv_output_blocks_per_sm", "rwkv6_chunked",
                       dtype, hd)


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
    _check(name, r.is_cuda or r.is_meta, f"unsupported device {r.device}")
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
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    out = (state_out if state_out is not None
           else torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device))
    if r.is_meta:
        count_meta(name, *wkv_work(r, out))
        return y, out
    for t in tensors:
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
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
    return y, out


rwkv6_chunked.launches = 0


def ref_rwkv6_chunked_backward(r, k, v, w, u, state0, dy, dstate=None):
    """Plain version of ``rwkv6_chunked_backward``: the gradient of
    ``ref_rwkv6_chunked(r, k, v, w, u, state0)`` = (y, state) for the
    cotangents ``dy`` (B, S, H, hd) and ``dstate`` (B, H, hd, hd) (None:
    zeros), in float32, the forward states kept and the adjoint run back
    step by step (no autograd). Returns (dr, dk, dv, dw, du in their inputs'
    dtypes, dstate0 (B, H, hd, hd) float32, also when ``state0`` is
    None)."""
    B, S, H, hd = r.shape
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    dy = dy.float()
    states = [state]                          # states[t] = S_{t-1}
    for t in range(S):
        state = wf[:, t, :, :, None] * state + kf[:, t, :, :, None] * vf[:, t, :, None, :]
        states.append(state)
    g = torch.zeros_like(state) if dstate is None else dstate.float()   # G_t
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((H, hd), dtype=torch.float32, device=r.device)
    for t in range(S - 1, -1, -1):
        r_t, k_t, v_t, w_t, dy_t = rf[:, t], kf[:, t], vf[:, t], wf[:, t], dy[:, t]
        beta = (v_t * dy_t).sum(-1, keepdim=True)                  # v_t . dy_t
        gamma = (r_t * uf * k_t).sum(-1, keepdim=True)             # the bonus r_t . u k_t
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", states[t], dy_t) + uf * k_t * beta
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", g, v_t) + r_t * uf * beta
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", g, k_t) + gamma * dy_t
        dw[:, t] = (g * states[t]).sum(-1)
        du += (r_t * k_t * beta).sum(0)
        g = w_t[..., None] * g + r_t[..., None] * dy_t[:, :, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype), g)


def rwkv6_chunked_backward(r, k, v, w, u, state0, dy, dstate=None):
    """dr, dk, dv, dw, du, dstate0 of ``rwkv6_chunked(r, k, v, w, u,
    state0)`` = (y, state) for the cotangents ``dy`` (B, S, H, hd) float32
    and ``dstate`` (B, H, hd, hd) float32 or None (zeros): the gradients in
    their inputs' dtypes (w and u float32), dstate0 (B, H, hd, hd) float32.
    CUDA tensors launch the kernels of ``csrc/rwkv6_scan_backward.cu`` (one
    count in ``launches`` a call; the forward's shapes and dtypes, u
    float32); CPU tensors run the plain version."""
    if r.device.type == "cpu":
        return ref_rwkv6_chunked_backward(r, k, v, w, u, state0, dy, dstate)
    name = "rwkv6_chunked_backward"
    _check(name, r.is_cuda or r.is_meta, f"unsupported device {r.device}")
    _check(name, r.dim() == 4, "r, k, v and w must be (B, S, H, hd)")
    B, S, H, hd = r.shape
    _check(name, B >= 1 and S >= 1, f"B and S must be >= 1, got {B} and {S}")
    for t in (k, v, w, dy):
        _check(name, tuple(t.shape) == (B, S, H, hd), "r, k, v, w and dy must share one shape")
    _check(name, r.dtype in _DTYPE_CODES and k.dtype == r.dtype and v.dtype == r.dtype,
           f"r, k and v must share float32 or bfloat16, got {r.dtype}/{k.dtype}/{v.dtype}")
    _check(name, w.dtype == torch.float32 and dy.dtype == torch.float32,
           f"w and dy must be float32, got {w.dtype}/{dy.dtype}")
    _check(name, hd in _HEAD_DIMS, f"head_dim must be one of {_HEAD_DIMS}, got {hd}")
    _check(name, tuple(u.shape) == (H, hd) and u.dtype == torch.float32,
           "u must be (H, hd) float32")
    for t, what in ((state0, "state0"), (dstate, "dstate")):
        if t is not None:
            _check(name, tuple(t.shape) == (B, H, hd, hd) and t.dtype == torch.float32,
                   f"{what} must be (B, H, hd, hd) float32")
    tensors = [r, k, v, w, u, dy] + [t for t in (state0, dstate) if t is not None]
    for t in tensors:
        _check(name, t.device == r.device, "all tensors must be on r's device")
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw, du = torch.empty_like(w), torch.empty_like(u)
    dstate0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if r.is_meta:
        st = lambda t: dstate0 if t is None else t
        count_meta(name, *scan_backward_work(name, (r, k, v, w, u, st(state0), dy, st(dstate))))
        return dr, dk, dv, dw, du, dstate0
    for t in tensors:
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
    from repro_torch.kernels._build import load_library

    lib = load_library("rwkv6_scan_backward").lib
    n_seg, seg_len = wkv_backward_segments(backward_slots(r.device.index, r.dtype, hd), B, H, S)
    n_chunk = -(-S // BACKWARD_CHUNK)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=r.device)
    # each chunk's local state and its decay from its segment's start (B, H,
    # n_chunk, ...), each segment's end state and adjoint (B, H, n_seg, hd,
    # hd), its decay (B, H, n_seg, hd) and its share of du (B, n_seg, H, hd)
    scratch = (f32(B, H, n_chunk, hd, hd), f32(B, H, n_chunk, hd), f32(B, H, n_seg, hd, hd),
               f32(B, H, n_seg, hd, hd), f32(B, H, n_seg, hd), f32(B, n_seg, H, hd))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkvb_rwkv6_backward(
            _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ptr(state0), dy.data_ptr(), ptr(dstate), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du.data_ptr(), dstate0.data_ptr(),
            *(t.data_ptr() for t in scratch), B, S, H, hd, n_seg, seg_len, stream,
        )
    _raise_on_error(name, err)
    rwkv6_chunked_backward.launches += 1
    return dr, dk, dv, dw, du, dstate0


rwkv6_chunked_backward.launches = 0


class WKV6(torch.autograd.Function):
    """``rwkv6_chunked`` with its backward (``rwkv6_chunked_backward``). The
    forward saves its inputs; the backward recomputes the states from them.
    u comes in float32 (``trainable_rwkv6_chunked`` casts it outside); w is
    float32 already."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        y, state = rwkv6_chunked(r, k, v, w, u, state0)
        ctx.save_for_backward(r, k, v, w, u, state0)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        grads = rwkv6_chunked_backward(r, k, v, w, u, state0, dy.contiguous(),
                                       None if dstate is None else dstate.contiguous())
        return (*grads[:5], None if state0 is None else grads[5])


def trainable_rwkv6_chunked(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """``rwkv6_chunked`` under autograd (the ``WKV6`` Function): (y, final
    state), both float32. u is cast to float32 here, outside the Function.
    No ``state_out``: an in-place output has no place under autograd."""
    return WKV6.apply(r, k, v, w, u.float(), state0)


def reset_launch_counts() -> None:
    """Zero the wrappers' launch counters."""
    rwkv6_chunked.launches = 0
    rwkv6_chunked_backward.launches = 0
