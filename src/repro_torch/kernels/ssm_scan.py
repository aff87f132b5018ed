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
``ref_ssm_scan``. There is no fallback from one to the other: a CUDA input
the kernel does not take raises. On ``meta`` tensors (the dry run) both
wrappers return outputs of their contract's shapes and dtypes and count
their contract work in ``kernels.work.META_WORK``, with no launch and no
plain loop (``kernels.work``'s meta rule). The kernel takes dt, x, B and C
in float32 or bfloat16 (one dtype), N = 16 or 8 and any S >= 1, and
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

The backward. ``ssm_scan`` is forward-only: its outputs are filled through
ctypes and carry no ``grad_fn``, so on CUDA it refuses an input that
requires grad under grad mode. ``trainable_ssm_scan`` runs it inside the
autograd Function ``SelectiveScan``, whose backward is
``ssm_scan_backward``: the exact gradient of the sequential float32
recurrence, which is what JAX takes (autodiff of ``chunked_scan`` over the
``step`` of ``repro.models.ssm.apply_ssm``; no JAX caller sets
``use_kernel``, so JAX never differentiates its Pallas scan). The adjoint
g_t = dL/dh_t runs backward in time,

    g_t = exp(dt_{t+1} A) g_{t+1} + C_t dy_t,   g_{S-1} = C_{S-1} dy_{S-1} + dh,

and every gradient is a sum of g_t and h_{t-1} terms. On CUDA tensors the
wrapper launches the hand-written kernels of ``csrc/ssm_scan_backward.cu``
(one count in ``launches`` a call); on CPU tensors it runs
``ref_ssm_scan_backward``, the reverse recurrence written out step by step.
The kernels cut the time axis into segments of whole 8-step chunks
(``ssm_backward_segments``): a local pass gives each chunk's state from its
segment's start and each segment's adjoint, and the output pass carries
them across the segments and walks each chunk forward, then back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (
    _check,
    _raise_on_error,
    _scratch,
    refuse_grad,
)
from repro_torch.kernels.rwkv6_scan import backward_segments, block_slots, even_segments
from repro_torch.kernels.work import count_meta, scan_backward_work, ssm_work

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STATES = (8, 16)   # the N instantiations in csrc/ssm_scan.cu and csrc/ssm_scan_backward.cu
# steps of a chunk of the backward kernels (``kT`` in
# csrc/ssm_scan_backward.cu): a thread keeps a chunk's states and decays in
# registers while it walks the chunk back; a backward segment is a whole
# number of chunks
BACKWARD_CHUNK = 8
_BACKWARD_MIN_CHUNKS = 4
# states of a backward block (``Lanes::CH`` channels of N): 128 threads of
# 4 states of 2 channels
_BACKWARD_BLOCK_STATES = 128 * 2 * 4

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


def ssm_backward_segments(slots: int, B: int, Di: int, N: int, S: int):
    """(n_seg, seg_len) of the scan's backward: ``B * ceil(Di / channels)``
    output-pass blocks a segment."""
    return backward_segments(slots, B * -(-Di // (_BACKWARD_BLOCK_STATES // N)), S,
                             BACKWARD_CHUNK, _BACKWARD_MIN_CHUNKS)


def backward_slots(device_index: int, dtype: torch.dtype, N: int) -> int:
    """Backward output-pass blocks the card holds at once."""
    return block_slots(device_index, "ssm_scan_backward", "ssmb_output_blocks_per_sm",
                       "ssm_scan_backward", dtype, N)


def output_slots(device_index: int, dtype: torch.dtype, N: int) -> int:
    """Output-pass blocks the card holds at once."""
    return block_slots(device_index, "ssm_scan", "ssm_output_blocks_per_sm", "ssm_scan", dtype, N)


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
    _check(name, dt.is_cuda or dt.is_meta, f"unsupported device {dt.device}")
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
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dt.device)
    out = (h_out if h_out is not None
           else torch.empty((B, Di, N), dtype=torch.float32, device=dt.device))
    if dt.is_meta:
        count_meta(name, *ssm_work(dt, bm, out))
        return y, out
    for t in tensors:
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
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
    return y, out


ssm_scan.launches = 0


def ref_ssm_scan_backward(dt, x, bm, cm, a_log, h0, dy, dh=None):
    """Plain version of ``ssm_scan_backward``: the gradient of
    ``ref_ssm_scan(dt, x, bm, cm, a_log, h0)`` = (y, h) for the cotangents
    ``dy`` (B, S, Di) and ``dh`` (B, Di, N) (None: zeros), in float32, the
    forward states kept and the adjoint run back step by step (no
    autograd). Returns (ddt, dx, dbm, dcm in their inputs' dtypes, da_log in
    a_log's, dh0 (B, Di, N) float32, also when ``h0`` is None)."""
    B, S, Di = dt.shape
    N = bm.shape[-1]
    a = -torch.exp(a_log.float())
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float())
    dtf, xf, bf, cf = (t.float() for t in (dt, x, bm, cm))
    dy = dy.float()
    dtx = dtf * xf
    hs = [h]                                  # hs[t] = h_{t-1}, hs[t + 1] = h_t
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * a[None]) * h + dtx[:, t, :, None] * bf[:, t, None, :]
        hs.append(h)
    # g_next: the adjoint that reaches h_t from later steps (dh at the end)
    g_next = torch.zeros_like(h) if dh is None else dh.float()
    ddt, dx = torch.empty_like(dtf), torch.empty_like(xf)
    dbm, dcm = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros((Di, N), dtype=torch.float32, device=dt.device)
    for t in range(S - 1, -1, -1):
        decay = torch.exp(dtf[:, t, :, None] * a[None])
        g = g_next + dy[:, t, :, None] * cf[:, t, None, :]       # dL/dh_t
        dcm[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy[:, t])
        dbm[:, t] = torch.einsum("bdn,bd->bn", g, dtx[:, t])
        g_b = torch.einsum("bdn,bn->bd", g, bf[:, t])             # d(dt x)
        g_decay = g * hs[t] * decay                                # d(dt A), per state
        ddt[:, t] = (g_decay * a[None]).sum(-1) + xf[:, t] * g_b
        dx[:, t] = dtf[:, t] * g_b
        da += torch.einsum("bdn,bd->dn", g_decay, dtf[:, t])
        g_next = decay * g
    return (ddt.to(dt.dtype), dx.to(x.dtype), dbm.to(bm.dtype), dcm.to(cm.dtype),
            (da * a).to(a_log.dtype), g_next)


def ssm_scan_backward(dt, x, bm, cm, a_log, h0, dy, dh=None):
    """ddt, dx, dbm, dcm, da_log, dh0 of ``ssm_scan(dt, x, bm, cm, a_log,
    h0)`` = (y, h) for the cotangents ``dy`` (B, S, Di) float32 and ``dh``
    (B, Di, N) float32 or None (zeros): the gradients in their inputs'
    dtypes (a_log float32), dh0 (B, Di, N) float32. CUDA tensors launch the
    kernels of ``csrc/ssm_scan_backward.cu`` (one count in ``launches`` a
    call; the forward's shapes and dtypes, a_log float32); CPU tensors run
    the plain version."""
    if dt.device.type == "cpu":
        return ref_ssm_scan_backward(dt, x, bm, cm, a_log, h0, dy, dh)
    name = "ssm_scan_backward"
    _check(name, dt.is_cuda or dt.is_meta, f"unsupported device {dt.device}")
    _check(name, dt.dim() == 3 and bm.dim() == 3, "dt, x must be (B, S, Di), B, C (B, S, N)")
    B, S, Di = dt.shape
    N = bm.shape[-1]
    _check(name, B >= 1 and S >= 1, f"B and S must be >= 1, got {B} and {S}")
    _check(name, tuple(x.shape) == tuple(dy.shape) == (B, S, Di), "x and dy must have dt's shape")
    _check(name, tuple(bm.shape) == tuple(cm.shape) == (B, S, N), "B and C must be (B, S, N)")
    _check(name, N in _STATES, f"the state size must be one of {_STATES}, got {N}")
    _check(name, dt.dtype in _DTYPE_CODES and all(t.dtype == dt.dtype for t in (x, bm, cm)),
           f"dt, x, B and C must share float32 or bfloat16, got "
           f"{dt.dtype}/{x.dtype}/{bm.dtype}/{cm.dtype}")
    _check(name, tuple(a_log.shape) == (Di, N) and a_log.dtype == torch.float32,
           "a_log must be (Di, N) float32")
    _check(name, dy.dtype == torch.float32, f"dy must be float32, got {dy.dtype}")
    for t, what in ((h0, "h0"), (dh, "dh")):
        if t is not None:
            _check(name, tuple(t.shape) == (B, Di, N) and t.dtype == torch.float32,
                   f"{what} must be (B, Di, N) float32")
    tensors = [dt, x, bm, cm, a_log, dy] + [t for t in (h0, dh) if t is not None]
    for t in tensors:
        _check(name, t.device == dt.device, "all tensors must be on dt's device")
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(cm)
    da_log = torch.empty_like(a_log)
    dh0 = torch.empty((B, Di, N), dtype=torch.float32, device=dt.device)
    if dt.is_meta:
        st = lambda t: dh0 if t is None else t
        count_meta(name, *scan_backward_work(name, (dt, x, bm, cm, a_log, st(h0), dy, st(dh))))
        return ddt, dx, dbm, dcm, da_log, dh0
    for t in tensors:
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous and 16-byte aligned")
    from repro_torch.kernels._build import load_library

    lib = load_library("ssm_scan_backward").lib
    n_seg, seg_len = ssm_backward_segments(backward_slots(dt.device.index, dt.dtype, N), B, Di,
                                           N, S)
    n_chunk = -(-S // BACKWARD_CHUNK)
    n_cb = -(-Di // (_BACKWARD_BLOCK_STATES // N))
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dt.device)
    # each chunk's local state and its product of decays from its segment's
    # start (B, n_chunk, Di, N), each segment's end state, adjoint, product
    # of decays and share of dA (B, n_seg, Di, N), and the channel blocks'
    # shares of dB and dC (n_cb, B, S, 2N)
    scratch = (f32(B, n_chunk, Di, N), f32(B, n_chunk, Di, N), f32(B, n_seg, Di, N),
               f32(B, n_seg, Di, N), f32(B, n_seg, Di, N), f32(B, n_seg, Di, N),
               f32(n_cb, B, S, 2 * N))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.ssmb_selective_scan_backward(
            _DTYPE_CODES[dt.dtype], dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a_log.data_ptr(), ptr(h0), dy.data_ptr(), ptr(dh), ddt.data_ptr(), dx.data_ptr(),
            dbm.data_ptr(), dcm.data_ptr(), da_log.data_ptr(), dh0.data_ptr(),
            *(t.data_ptr() for t in scratch), B, S, Di, N, n_seg, seg_len, stream,
        )
    _raise_on_error(name, err)
    ssm_scan_backward.launches += 1
    return ddt, dx, dbm, dcm, da_log, dh0


ssm_scan_backward.launches = 0


class SelectiveScan(torch.autograd.Function):
    """``ssm_scan`` with its backward (``ssm_scan_backward``). The forward
    saves its inputs; the backward recomputes the states from them. a_log
    comes in float32 (``trainable_ssm_scan`` casts it outside, so autograd
    carries da_log back to a bf16 parameter)."""

    @staticmethod
    def forward(ctx, dt, x, bm, cm, a_log, h0):
        y, h = ssm_scan(dt, x, bm, cm, a_log, h0)
        ctx.save_for_backward(dt, x, bm, cm, a_log, h0)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        dt, x, bm, cm, a_log, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        grads = ssm_scan_backward(dt, x, bm, cm, a_log, h0, dy.contiguous(),
                                  None if dh is None else dh.contiguous())
        return (*grads[:5], None if h0 is None else grads[5])


def trainable_ssm_scan(dt, x, bm, cm, a_log, h0: Optional[torch.Tensor] = None):
    """``ssm_scan`` under autograd (the ``SelectiveScan`` Function): (y, final
    h), both float32. a_log is cast to float32 here, outside the Function.
    No ``h_out``: an in-place output has no place under autograd."""
    return SelectiveScan.apply(dt, x, bm, cm, a_log.float(), h0)


def reset_launch_counts() -> None:
    """Zero the wrappers' launch counters."""
    ssm_scan.launches = 0
    ssm_scan_backward.launches = 0
