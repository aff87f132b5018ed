"""GQA decode attention: CUDA kernels for the serving hot loop, and their
plain PyTorch versions.

``paged_decode_attention`` (one query token per row over its block chain)
and ``paged_chunk_attention`` (T packed query tokens, each over its own
row's chain under the segmented-prompt span mask) port the Pallas kernels of
``repro.kernels.decode_attention`` that the paged backend runs;
``decode_attention`` (one query token per row over a contiguous cache,
valid below each row's length) ports the one the dense backend runs. On
CUDA tensors each wrapper launches its hand-written kernel (the paged ones
in ``csrc/paged_attention.cu``, the dense one in ``csrc/dense_attention.cu``;
built on first use, see ``kernels._build``) on the current stream and counts
the launch in its ``launches`` attribute (one per call, whatever kernels
the call runs: the decode wrappers launch a split kernel and a merge, the
chunk wrapper with bf16 q a tile plan, the tiles and, when it splits them,
a merge); on CPU tensors it runs the plain version. There is no fallback
from one to the other: a CUDA input the kernel does not take raises. On
``meta`` tensors (the dry run) each wrapper returns an output of its
contract's shape and dtype and counts its contract work in
``kernels.work.META_WORK`` (every table or cache slot, since a meta tensor
holds no lengths); it launches nothing and runs no plain version
(``kernels.work``'s meta rule).

``ref_paged_decode_attention`` / ``ref_paged_chunk_attention`` are PyTorch
ports of the JAX gather oracles: they materialise each query's contiguous
view from its block table and run masked softmax attention, with the
scores accumulated in float32 and the probabilities cast to the value dtype
before the value product, as the oracles do. ``ref_decode_attention`` does
the same on the contiguous cache (``repro.kernels.ref.decode_attention_ref``).
They are the numerics contract the kernels are held against.

The paged kernels and their plain versions take RAW block tables (-1
entries are masked) and float32, bfloat16 or int8 pools; int8 pools come
with per-(block, KV head) float32 scales ``k_scale``/``v_scale`` of shape
(n_blocks, KVH). The kernels take q in float32 or bfloat16: a float pool in
q's dtype, an int8 pool with either. A packed pad token (``row_of < 0``)
gets zeros. The dense decode kernel takes q and a cache in one dtype,
float32 or bfloat16.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.work import count_meta, decode_work, paged_work

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# what the kernels are compiled for (kBS and the head_dim instantiations in
# csrc/paged_attention.cu)
_BLOCK_SIZE = 16
_HEAD_DIMS = (64, 128)

# Called as ``observer(name, k_pool.dtype, v_pool.dtype)`` by the two paged
# wrappers on every call, on any device, when set: the step audit
# (``analysis.step_audit``) uses it to see which pool dtypes reach the
# paged kernels, since it cannot see the ctypes launches. None by default.
observer = None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gather(pool, safe_tables, sc):
    """(R, mb) block ids -> (R, mb*bs, KVH, hd) view, dequantised to float32
    by the per-(block, KV head) scales when ``sc`` is given."""
    R, mb = safe_tables.shape
    g = pool[safe_tables]                                  # (R, mb, bs, KVH, hd)
    if sc is not None:
        g = g.float() * sc[safe_tables][:, :, None, :, None]
    return g.reshape(R, mb * pool.shape[1], *pool.shape[2:])


def _masked_attention(q, K, V, valid, scale):
    """q: (R, H, hd); K/V: (R, S, KVH, hd); valid: (R, S) -> (R, H, hd).
    Scores in float32, probabilities cast to V's dtype for the value
    product (accumulated in float32), output in q's dtype."""
    R, H, hd = q.shape
    KVH = K.shape[2]
    G = H // KVH
    qg = q.reshape(R, KVH, G, hd).float()
    scores = torch.einsum("rkgh,rskh->rkgs", qg, K.float()) * scale
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("rkgs,rskh->rkgh", probs.to(V.dtype).float(), V.float())
    return out.reshape(R, H, hd).to(q.dtype)


def ref_paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                               scale=None, k_scale=None, v_scale=None):
    """Plain version of ``paged_decode_attention``. q: (B, H, hd);
    k/v_pool: (n_blocks, bs, KVH, hd); block_tables: (B, mb) RAW; lengths:
    (B,) valid tokens per row (>= 1). Returns (B, H, hd)."""
    hd = q.shape[-1]
    bs = k_pool.shape[1]
    mb = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    safe = tables.clamp(min=0)
    slots = torch.arange(mb * bs, device=q.device)
    valid = (tables[:, slots // bs] >= 0) & (slots[None] < lengths.long()[:, None])
    K = _gather(k_pool, safe, k_scale)
    V = _gather(v_pool, safe, v_scale)
    return _masked_attention(q, K, V, valid, scale)


def ref_paged_chunk_attention(q, k_pool, v_pool, block_tables, row_of, slots,
                              p_end, s_start, scale=None, k_scale=None,
                              v_scale=None):
    """Plain version of ``paged_chunk_attention``. q: (T, H, hd); tables
    (B, mb) RAW; row_of/slots/p_end/s_start: (T,). Each token attends its
    own row's view under ``slot < p_end OR s_start <= slot <= slots[t]``.
    Returns (T, H, hd); pad tokens (row_of < 0) get zeros."""
    hd = q.shape[-1]
    bs = k_pool.shape[1]
    mb = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    row_of = row_of.long()
    rows = row_of.clamp(min=0)
    per_tok = block_tables.long()[rows]                   # (T, mb) table ints
    safe = per_tok.clamp(min=0)
    s_idx = torch.arange(mb * bs, device=q.device)
    backed = (row_of[:, None] >= 0) & (per_tok[:, s_idx // bs] >= 0)
    span = (s_idx[None] < p_end.long()[:, None]) | (
        (s_idx[None] >= s_start.long()[:, None])
        & (s_idx[None] <= slots.long()[:, None])
    )
    K = _gather(k_pool, safe, k_scale)
    V = _gather(v_pool, safe, v_scale)
    out = _masked_attention(q, K, V, backed & span, scale)
    return torch.where((row_of >= 0)[:, None, None], out, torch.zeros_like(out))


def ref_decode_attention(q, k_cache, v_cache, lengths, scale=None):
    """Plain version of ``decode_attention``. q: (B, H, hd); k/v_cache:
    (B, Sc, KVH, hd); lengths: (B,) valid slots per row (>= 1). Returns
    (B, H, hd)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    slots = torch.arange(k_cache.shape[1], device=q.device)
    valid = slots[None] < lengths.long()[:, None]
    return _masked_attention(q, k_cache, v_cache, valid, scale)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check(name, cond, what):
    if not cond:
        raise ValueError(f"{name}: {what}")


def _check_common(name, q, k_pool, v_pool, block_tables, k_scale, v_scale):
    """Validate what both kernels take; returns (dtype codes, scale ptrs)."""
    dev = q.device
    _check(name, q.dim() == 3 and k_pool.dim() == 4, "q must be 3-D, pools 4-D")
    _check(name, k_pool.shape == v_pool.shape, "k/v pools differ in shape")
    H, hd = q.shape[1], q.shape[2]
    KVH = k_pool.shape[2]
    _check(name, k_pool.shape[3] == hd, "pool head_dim differs from q")
    _check(name, KVH > 0 and H % KVH == 0, "H must be a multiple of KVH")
    _check(name, q.dtype in (torch.float32, torch.bfloat16),
           f"q must be float32 or bfloat16, got {q.dtype}")
    _check(name, k_pool.dtype == v_pool.dtype and k_pool.dtype in _DTYPE_CODES,
           f"pools must share one of float32/bfloat16/int8, got "
           f"{k_pool.dtype}/{v_pool.dtype}")
    quantized = k_pool.dtype == torch.int8
    _check(name, quantized or k_pool.dtype == q.dtype,
           f"a float pool must have q's dtype, got q {q.dtype}, pools {k_pool.dtype}")
    _check(name, block_tables.dtype == torch.int32 and block_tables.dim() == 2,
           "block_tables must be (B, mb) int32")
    _check(name, (k_scale is not None) == quantized
           and (v_scale is not None) == quantized,
           "int8 pools need k_scale and v_scale; float pools take none")
    tensors = [q, k_pool, v_pool, block_tables]
    if quantized:
        for sc in (k_scale, v_scale):
            _check(name, sc.dtype == torch.float32
                   and tuple(sc.shape) == (k_pool.shape[0], KVH),
                   "scales must be (n_blocks, KVH) float32")
        tensors += [k_scale, v_scale]
    for t in tensors:
        _check(name, t.device == dev, "all tensors must be on q's device")
        _check(name, t.is_contiguous(), "all tensors must be contiguous")
    ptrs = ((k_scale.data_ptr(), v_scale.data_ptr()) if quantized else (None, None))
    return _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], ptrs


def _launch_args(lib, q, k_pool):
    H, hd = q.shape[1], q.shape[2]
    bs, KVH = k_pool.shape[1], k_pool.shape[2]
    if bs != _BLOCK_SIZE or hd not in _HEAD_DIMS:
        raise ValueError(f"the kernels take block_size {_BLOCK_SIZE} and head_dim in "
                         f"{_HEAD_DIMS}; got block_size={bs}, head_dim={hd}")
    if k_pool.data_ptr() % 16:
        raise ValueError("the kernels read K in 16-byte loads: the pool must be "
                         "16-byte aligned")
    smem = lib.pa_smem_bytes(H // KVH, hd)
    if smem > 227 * 1024:
        raise ValueError(f"shared memory per block {smem} B exceeds the H100's 227 KB")
    return H, KVH, hd, bs


def _raise_on_error(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def refuse_grad(name, *tensors):
    """Raise where a forward-only kernel would be handed a floating input
    that requires grad under grad mode: its output, filled through ctypes,
    would carry no ``grad_fn``, and autograd would run on without the
    kernel's share of the gradient. The plain versions (CPU tensors) stay
    differentiable; the trainable forms, autograd Functions whose backward
    is a kernel too, are ``kernels.flash_attention.
    trainable_flash_attention``, ``kernels.rwkv6_scan.
    trainable_rwkv6_chunked`` and ``kernels.ssm_scan.trainable_ssm_scan``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward-only, and an input requires "
                           f"grad; run it under torch.no_grad() or on detached inputs")


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None):
    """Block-table decode attention over one layer's paged pool.

    q: (B, H, hd) float32/bfloat16; k/v_pool: (n_blocks, bs, KVH, hd);
    block_tables: (B, mb) int32 RAW (-1 = unallocated, masked); lengths:
    (B,) int32 valid tokens per row (>= 1). Returns (B, H, hd) in q's dtype.
    CUDA tensors launch the kernel, split across the chain
    (``decode_split``) and merged; CPU tensors run the plain version."""
    if observer is not None:
        observer("paged_decode_attention", k_pool.dtype, v_pool.dtype)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref_paged_decode_attention(q, k_pool, v_pool, block_tables,
                                          lengths, scale, k_scale, v_scale)
    name = "paged_decode_attention"
    _check(name, q.is_cuda or q.is_meta, f"unsupported device {q.device}")
    refuse_grad(name, q, k_pool, v_pool, k_scale, v_scale)
    qc, kc, (ks, vs) = _check_common(name, q, k_pool, v_pool, block_tables,
                                     k_scale, v_scale)
    B, mb = block_tables.shape
    _check(name, q.shape[0] == B, "q and block_tables disagree on B")
    _check(name, lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
           and lengths.device == q.device and lengths.is_contiguous(),
           "lengths must be (B,) int32 on q's device")
    if q.is_meta:
        count_meta(name, *paged_work(q, k_pool, block_tables))
        return torch.empty_like(q)
    from repro_torch.kernels._build import load_library

    lib = load_library("paged_attention").lib
    H, KVH, hd, bs = _launch_args(lib, q, k_pool)
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split, chunk = decode_split(_sm_count(q.device.index), B, KVH, mb * bs)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part_o, part_ml = _partials(q.device, stream, B, KVH, n_split, H // KVH, hd)
        err = lib.pa_paged_decode_attention(
            qc, kc, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), B, H, KVH, hd, bs, mb,
            n_split, chunk // bs, float(scale), stream,
        )
    _raise_on_error(name, err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_chunk_attention(q, k_pool, v_pool, block_tables, row_of, slots,
                          p_end, s_start, *, scale: Optional[float] = None,
                          k_scale=None, v_scale=None):
    """Ragged fused-step attention: T packed query tokens over one layer's
    paged pool, which already holds the packed tokens' own K/V.

    q: (T, H, hd); k/v_pool: (n_blocks, bs, KVH, hd); block_tables: (B, mb)
    int32 RAW; row_of: (T,) int32 owning row (-1 = pad token, zeros out);
    slots: (T,) absolute cache slot; p_end/s_start: (T,) segmented-prompt
    spans (zeros = plain causal). Returns (T, H, hd) in q's dtype. CUDA
    tensors launch the kernel (bf16 q, with a bf16 or an int8 pool: tiles
    of a row's packed tokens on the tensor cores, listed on the card by
    ``chunk_tile_plan``'s rule and split by ``chunk_split``; f32 q: one
    block per token); CPU tensors run the plain version."""
    if observer is not None:
        observer("paged_chunk_attention", k_pool.dtype, v_pool.dtype)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref_paged_chunk_attention(q, k_pool, v_pool, block_tables,
                                         row_of, slots, p_end, s_start, scale,
                                         k_scale, v_scale)
    name = "paged_chunk_attention"
    _check(name, q.is_cuda or q.is_meta, f"unsupported device {q.device}")
    refuse_grad(name, q, k_pool, v_pool, k_scale, v_scale)
    qc, kc, (ks, vs) = _check_common(name, q, k_pool, v_pool, block_tables,
                                     k_scale, v_scale)
    T = q.shape[0]
    mb = block_tables.shape[1]
    for t in (row_of, slots, p_end, s_start):
        _check(name, t.dtype == torch.int32 and tuple(t.shape) == (T,)
               and t.device == q.device and t.is_contiguous(),
               "row_of/slots/p_end/s_start must be (T,) int32 on q's device")
    if q.is_meta:
        count_meta(name, *paged_work(q, k_pool, block_tables))
        return torch.empty_like(q)
    from repro_torch.kernels._build import load_library

    lib = load_library("paged_attention").lib
    H, KVH, hd, bs = _launch_args(lib, q, k_pool)
    out = torch.empty_like(q)
    if T == 0:
        return out
    B = block_tables.shape[0]
    G = H // KVH
    tensor_cores = q.dtype == torch.bfloat16            # with a bf16 or an int8 pool
    n_split, grid_x = 1, 1
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        plan = part_o = part_ml = None
        if tensor_cores:
            _check(name, G <= _TILE_ROWS, f"the kernel takes at most {_TILE_ROWS} query heads "
                   f"a KV head, got {G}")
            smem = lib.pa_chunk_tc_smem_bytes(hd, mb)
            _check(name, smem <= 227 * 1024,
                   f"shared memory per block {smem} B exceeds the H100's 227 KB")
            n_split, tiles = chunk_split(_sm_count(q.device.index), T, B, KVH, G, mb * bs)
            grid_x = tiles * n_split
            plan = _scratch(q.device, stream, "chunk_plan", 1 + 2 * T, torch.int32)
            if n_split > 1:
                part_o, part_ml = _partials(q.device, stream, T, KVH, n_split, G, hd)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = lib.pa_paged_chunk_attention(
            qc, kc, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
            block_tables.data_ptr(), row_of.data_ptr(), slots.data_ptr(),
            p_end.data_ptr(), s_start.data_ptr(), out.data_ptr(), ptr(plan),
            ptr(part_o), ptr(part_ml), T, H, KVH, hd, bs, mb, n_split, grid_x,
            float(scale), stream,
        )
    _raise_on_error(name, err)
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0


# the decode kernels split a row's cache into spans of whole 16-slot tiles
# (the paged kernel's blocks), at least this many slots long (one pass of a
# thread block's eight 16-slot warps) unless one span holds the whole row
_MIN_SPLIT_SLOTS = 128


def decode_split(sms: int, B: int, KVH: int, slots: int):
    """(n_split, chunk) of the split paged decode kernel, its only user (the
    dense decode kernel splits each row by its own length,
    ``dense_decode_split``): a row's ``mb * block_size`` table slots go to
    n_split thread blocks of ``chunk`` slots each, the last one taking what
    remains. ``chunk`` is a whole number of 16-slot tiles, at least
    ``_MIN_SPLIT_SLOTS`` unless there is one split, and small enough that the
    ``n_split * KVH * B`` blocks give each of the ``sms`` SMs two where the
    slots allow; no split is empty."""
    tile = _BLOCK_SIZE
    target = -(-2 * sms // max(B * KVH, 1))                # splits for two blocks per SM
    chunk = max(_MIN_SPLIT_SLOTS, slots // target // tile * tile)
    n_split = max(1, -(-slots // chunk))
    # the same number of splits, evened out: the least whole-tile chunk
    # that covers the slots (never more than chunk, so n_split holds)
    per_split = -(-slots // n_split)
    even = max(tile, -(-per_split // tile) * tile)
    if n_split == 1 or even >= _MIN_SPLIT_SLOTS:
        chunk = even
    return n_split, chunk


# the dense decode kernel: warps (splits) to aim for per SM (of 1, 2, 4, 8
# and 16 at the mixed step's lengths on the H100, 2 was the fastest at
# qwen2.5-3b's heads and 4 at hymba-1.5b's, 1-10 % apart; kernel_ab --sweep),
# and the rows of the tensor cores' m16 tile, the most query heads one warp
# scores
_DENSE_WARPS_PER_SM = 2
_HEAD_ROWS = 16


def dense_decode_split(sms: int, B: int, KVH: int, G: int, Sc: int) -> int:
    """n_split of the dense decode kernel, from shapes alone: each (row,
    KV head, group of up to 16 query heads) goes to n_split warps, about
    ``_DENSE_WARPS_PER_SM`` warps per SM in all, never more splits than
    16-slot tiles of the cache. The kernel cuts each row by its own length
    (``dense_decode_chunk``), so short rows fill the card too."""
    groups = B * KVH * -(-G // _HEAD_ROWS)
    want = -(-_DENSE_WARPS_PER_SM * sms // max(groups, 1))
    return max(1, min(want, -(-Sc // _BLOCK_SIZE)))


def dense_decode_chunk(length: int, n_split: int) -> int:
    """Slots per split of a row with ``length`` valid slots, as the dense
    decode kernel computes them on the card (``row_chunk`` in
    csrc/dense_attention.cu): whole 16-slot tiles, the least that lets
    n_split splits cover the row; split s covers [s * chunk, (s + 1) *
    chunk) below the length."""
    per = -(-length // n_split)
    return -(-per // _BLOCK_SIZE) * _BLOCK_SIZE


# the chunk kernel's tiles: at most 16 packed tokens and 128 query rows
# ((token, head) pairs: eight warps of 16); a split covers whole 64-slot
# K/V tiles; blocks to aim for per SM (a block takes an SM's registers; 1
# was the fastest of 1, 2, 4 and 8 at the engine's mixed step on the H100,
# kernel_ab --sweep)
_TILE_TOKENS = 16
_TILE_ROWS = 128
_KV_TILE = 64
_CHUNK_BLOCKS_PER_SM = 1


def chunk_tile_tokens(G: int) -> int:
    """Packed tokens a tile of the chunk kernel takes at G query heads per
    KV head (``chunk_tile_tokens`` in csrc/paged_attention.cu)."""
    return min(_TILE_TOKENS, _TILE_ROWS // G)


def chunk_tile_plan(row_of, G: int):
    """The chunk kernel's tiles, by the rule its plan kernel applies on the
    card (``chunk_plan_kernel`` in csrc/paged_attention.cu): token t starts
    a tile iff ``row_of[t] >= 0`` and (t is a multiple of the tile size
    ``chunk_tile_tokens(G)`` or ``row_of[t - 1] != row_of[t]``); the tile
    runs up to the next token that breaks the row or is a multiple of the
    tile size. Returns (first token, tokens) of each tile, in order, as two
    int64 tensors on row_of's device. A tile holds consecutive tokens of one
    row and no pad, for any row_of; with each row's tokens in one run (the
    control plane's packing) there are at most ``ceil(T / size) + B``."""
    size = chunk_tile_tokens(G)
    r = row_of.long()
    T = r.numel()
    t = torch.arange(T, device=r.device)
    prev = torch.cat([r.new_full((1,), -1), r[:-1]])
    cut = (t % size == 0) | (r != prev)          # a tile may begin only here
    starts = t[(r >= 0) & cut]
    bounds = torch.cat([t[cut], t.new_full((1,), T)])
    ends = bounds[torch.searchsorted(bounds, starts, right=True)]
    return starts, ends - starts


def chunk_split(sms: int, T: int, B: int, KVH: int, G: int, slots: int):
    """(n_split, tiles) of the chunk kernel, from shapes alone: ``tiles``
    bounds the tiles of a packing of T tokens over B rows (``ceil(T /
    size) + B``), and each tile's reach (its furthest attended slot + 1) is
    cut into n_split splits of whole 64-slot K/V tiles, enough that the
    ``tiles * n_split * KVH`` blocks give each of the ``sms`` SMs
    ``_CHUNK_BLOCKS_PER_SM``, and no more than the 64-slot tiles of
    ``slots``. The grid is ``tiles * n_split`` blocks a KV head; they walk
    the card's tile list grid-stride, so a plan with more tiles is still
    complete."""
    tiles = -(-T // chunk_tile_tokens(G)) + B
    want = -(-_CHUNK_BLOCKS_PER_SM * sms // max(tiles * KVH, 1))
    return max(1, min(want, -(-slots // _KV_TILE))), tiles


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# the kernels' scratch: the split kernels' partials (part_o, part_ml) and
# the chunk kernel's tile plan, one flat buffer per (device, stream, name),
# kept at the largest size asked for and a prefix used: every layer of every
# step reuses it, since launches on one stream run in order and each launch
# writes what its merge reads before the merge runs
_grow_scratch = {}


def _scratch(device, stream, name, numel, dtype=torch.float32):
    key = (device, stream, name)
    buf = _grow_scratch.get(key)
    if buf is None or buf.numel() < numel:
        buf = _grow_scratch[key] = torch.empty(numel, dtype=dtype, device=device)
    return buf[:numel]


def _partials(device, stream, rows, KVH, n_split, G, hd):
    """part_o (rows, KVH, n_split, G, hd) and part_ml (.., 2), flat."""
    n = rows * KVH * n_split * G
    return (_scratch(device, stream, "part_o", n * hd), _scratch(device, stream, "part_ml", n * 2))


def decode_attention(q, k_cache, v_cache, lengths, *, scale: Optional[float] = None):
    """Dense-cache decode attention: one query token per row over the row's
    contiguous cache.

    q: (B, H, hd); k/v_cache: (B, Sc, KVH, hd) in q's dtype (float32 or
    bfloat16); lengths: (B,) int32 valid slots per row (1 <= lengths <= Sc).
    Returns (B, H, hd) in q's dtype. CUDA tensors launch the kernel, each
    row split by its own length (``dense_decode_split``,
    ``dense_decode_chunk``) and merged; CPU tensors run the plain
    version."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref_decode_attention(q, k_cache, v_cache, lengths, scale)
    name = "decode_attention"
    _check(name, q.is_cuda or q.is_meta, f"unsupported device {q.device}")
    refuse_grad(name, q, k_cache, v_cache)
    _check(name, q.dim() == 3 and k_cache.dim() == 4, "q must be 3-D, caches 4-D")
    B, H, hd = q.shape
    Sc, KVH = k_cache.shape[1], k_cache.shape[2]
    _check(name, k_cache.shape == v_cache.shape and tuple(k_cache.shape) == (B, Sc, KVH, hd),
           "k/v caches must be (B, Sc, KVH, hd) with q's B and hd")
    _check(name, KVH > 0 and H % KVH == 0, "H must be a multiple of KVH")
    _check(name, q.dtype in (torch.float32, torch.bfloat16)
           and k_cache.dtype == q.dtype and v_cache.dtype == q.dtype,
           f"q and the caches must share float32 or bfloat16, got "
           f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    _check(name, hd in _HEAD_DIMS, f"head_dim must be one of {_HEAD_DIMS}, got {hd}")
    _check(name, lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
           and lengths.is_contiguous(), "lengths must be (B,) int32")
    for t in (k_cache, v_cache, lengths):
        _check(name, t.device == q.device, "all tensors must be on q's device")
    if q.is_meta:
        count_meta(name, *decode_work(q, k_cache, [Sc] * B))
        return torch.empty_like(q)
    for t in (q, k_cache, v_cache):
        _check(name, t.is_contiguous() and t.data_ptr() % 16 == 0,
               "q and the caches must be contiguous and 16-byte aligned")
    from repro_torch.kernels._build import load_library

    lib = load_library("dense_attention").lib
    G = H // KVH
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split = dense_decode_split(_sm_count(q.device.index), B, KVH, G, Sc)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part_o, part_ml = _partials(q.device, stream, B, KVH, n_split, G, hd)
        err = lib.da_decode_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
            B, H, KVH, hd, Sc, n_split, float(scale), stream,
        )
    _raise_on_error(name, err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero the three wrappers' launch counters."""
    paged_decode_attention.launches = 0
    paged_chunk_attention.launches = 0
    decode_attention.launches = 0
