"""Fused dense-retrieval scoring and top-k: a CUDA kernel for the
Retriever's exact search, and its plain PyTorch version.

``topk_retrieval`` ports the Pallas kernel of
``repro.kernels.topk_retrieval``: queries (B, d) are scored against docs
(N, d) in float32 and each query keeps its k best, returned as (B, k)
float32 scores and (B, k) int32 doc ids, best first, equal scores resolved
to the lower doc id (``lax.top_k``'s order). On CUDA tensors the wrapper
launches the hand-written kernel in ``csrc/topk_retrieval.cu`` (built on
first use, see ``kernels._build``) on the current stream and counts the
launch in ``topk_retrieval.launches``; on CPU tensors it runs the plain
version. There is no fallback from one to the other: a CUDA input the
kernel does not take raises ``ValueError``. On ``meta`` tensors (the dry
run) it returns outputs of the contract's shapes and dtypes and counts its
contract work in ``kernels.work.META_WORK``, with no launch and no plain
version (``kernels.work``'s meta rule).

``ref_topk_retrieval`` is the numerics contract (``ref.topk_retrieval_ref``
of the JAX package): one float32 matrix product, then a stable descending
sort, so equal scores keep the lower id first.

``topk_plan`` is how the kernel cuts its work on the card, a pure function
of the shapes that the CPU tests hold: tiles of 32 queries, slices of whole
128-doc tiles (one block a slice and query tile, one block an SM), and the
ring's stage count from what shared memory leaves (5 with f32 docs, 6
with bf16 at d 768).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.decode_attention import refuse_grad
from repro_torch.kernels.work import count_meta, topk_work

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024       # shared memory a block can use on the H100

# the kernel's constants (csrc/topk_retrieval.cu; the card tests compare)
TILE_DOCS = 128                # docs per tile: wgmma's N
QUERY_TILE = 32                # queries per block
MAX_K = 128
_STAGE_BYTES = TILE_DOCS * 128          # a stage: 128 docs x 128 bytes
_BARRIER_BYTES = 16                     # two mbarriers a stage
_SCORE_BYTES = QUERY_TILE * (TILE_DOCS + 4) * 4   # the score tile
_BUFFER_BYTES = QUERY_TILE * 64 * 8     # a candidate buffer of 64 a query
_ALIGN = 1024                  # room to align the ring to the 128-byte swizzle's 1024 bytes
_MAX_STAGES = 6                # ring stages at most (the kernel takes up to 8)
_MAX_SLICES = 256              # the merge kernel's shared memory holds 3/4 of them
_SLICES_PER_SM = 1             # blocks per SM of pass 1 (its shared memory allows one)


def ref_topk_retrieval(queries, docs, k: int = 16):
    """Plain version: queries (B, d), docs (N, d) -> (scores (B, k) float32,
    ids (B, k) int32), best first, ties to the lower id."""
    scores = queries.float() @ docs.float().T
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].to(torch.int32).contiguous()


def list_capacity(k: int) -> int:
    """Entries of a query's sorted list (the kernel's template K)."""
    return 32 if k <= 32 else (64 if k <= 64 else 128)


def stage_cols(docs_item: int) -> int:
    """Doc columns of a 128-byte stage row: 32 f32, 64 bf16."""
    return 128 // docs_item


def topk_smem_bytes(d: int, k: int, docs_item: int, stages: int) -> int:
    """Pass 1's shared memory (``tk_smem_bytes``; the same for every k): the
    ring, a d_lo buffer of a stage (f32 docs), the query tile in f32
    (rows of d rounded up to whole stages, padded by 4 floats for f32 docs
    and 8 for bf16), the score tile, a candidate buffer of 64 a query, the
    mbarriers, and room to align the ring."""
    cols = stage_cols(docs_item)
    f32 = docs_item == 4
    qs = -(-d // cols) * cols + (4 if f32 else 8)
    return (_ALIGN + (stages + (1 if f32 else 0)) * _STAGE_BYTES + QUERY_TILE * qs * 4
            + _SCORE_BYTES + _BUFFER_BYTES + stages * _BARRIER_BYTES + 16)


def merge_smem_bytes(n_slices: int, k: int) -> int:
    """Pass 2's shared memory (``tk_merge_smem_bytes``): the tree's first
    two levels of lists of K scores and K ids."""
    half = (n_slices + 1) // 2
    return (half + (half + 1) // 2) * 2 * list_capacity(k) * 4


class TopkPlan(NamedTuple):
    q_tiles: int           # blocks along the queries, 32 queries each
    n_slices: int          # blocks along the corpus, per query tile
    tiles_per_slice: int   # 128-doc tiles of each slice (the last may hold fewer)
    stages: int            # the ring's stages of 16 KB
    list_k: int            # K: the sorted lists' capacity


def topk_plan(sms: int, B: int, N: int, d: int, k: int, docs_item: int) -> TopkPlan:
    """How the kernel cuts (B, N) on a card of ``sms`` SMs: ceil(B / 32)
    query tiles; per query tile, about ``_SLICES_PER_SM * sms / q_tiles``
    slices of whole 128-doc tiles, each slice non-empty and every tile in
    exactly one; as many ring stages as shared memory leaves, up to
    ``_MAX_STAGES``. Raises ``ValueError`` where fewer than 2 stages fit
    (d too large)."""
    q_tiles = -(-B // QUERY_TILE)
    n_tiles = -(-N // TILE_DOCS)
    target = max(1, min(_MAX_SLICES, _SLICES_PER_SM * sms // q_tiles, n_tiles))
    tiles_per_slice = -(-n_tiles // target)
    n_slices = -(-n_tiles // tiles_per_slice)
    fixed = topk_smem_bytes(d, k, docs_item, 0)
    stages = min(_MAX_STAGES, (_SMEM_LIMIT - fixed) // (_STAGE_BYTES + _BARRIER_BYTES))
    _check(stages >= 2, f"shared memory per block at d={d}, k={k} leaves {stages} ring "
                        f"stages; the kernel needs 2 (the H100's 227 KB)")
    return TopkPlan(q_tiles, n_slices, tiles_per_slice, stages, list_capacity(k))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(cond, what):
    if not cond:
        raise ValueError(f"topk_retrieval: {what}")


def topk_retrieval(queries, docs, k: int = 16):
    """queries: (B, d) float; docs: (N, d) float32 or bfloat16, 1 <= k <= N.
    Returns (scores (B, k) float32, ids (B, k) int32). CUDA tensors launch
    the kernel (k <= 128, d a multiple of 8); CPU tensors run the plain
    version."""
    _check(queries.dim() == 2 and docs.dim() == 2 and queries.shape[1] == docs.shape[1],
           f"want queries (B, d) and docs (N, d), got {tuple(queries.shape)} and "
           f"{tuple(docs.shape)}")
    B, d = queries.shape
    N = docs.shape[0]
    _check(1 <= k <= N, f"k must be in [1, N={N}], got {k}")
    if docs.device.type == "cpu":
        _check(queries.device.type == "cpu", "queries and docs on different devices")
        return ref_topk_retrieval(queries, docs, k)
    _check((docs.is_cuda or docs.is_meta) and queries.device == docs.device,
           f"unsupported devices {queries.device}, {docs.device}")
    refuse_grad("topk_retrieval", queries, docs)
    _check(docs.dtype in _DTYPE_CODES, f"docs must be float32 or bfloat16, got {docs.dtype}")
    _check(queries.is_floating_point(), f"queries must be float, got {queries.dtype}")
    if docs.is_meta:
        nbytes, flops, _products = topk_work(queries, docs, k)
        count_meta("topk_retrieval", nbytes, flops)
        return (torch.empty((B, k), dtype=torch.float32, device=docs.device),
                torch.empty((B, k), dtype=torch.int32, device=docs.device))
    _check(docs.is_contiguous(), "docs must be contiguous")
    _check(d % 8 == 0 and docs.data_ptr() % 16 == 0,
           "the kernel reads docs in 16-byte loads: d must be a multiple of 8 and "
           "docs 16-byte aligned")
    _check(N < 2**31 - TILE_DOCS, "doc ids must fit in int32")
    _check(k <= MAX_K, f"the kernel takes k <= {MAX_K}, got {k}")
    out_s = torch.empty((B, k), dtype=torch.float32, device=docs.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=docs.device)
    if B == 0:
        return out_s, out_i
    plan = topk_plan(_sm_count(docs.device.index), B, N, d, k, docs.element_size())
    from repro_torch.kernels._build import load_library

    lib = load_library("topk_retrieval").lib
    q = queries.float().contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    part_s = torch.empty((B, plan.n_slices, k), dtype=torch.float32, device=docs.device)
    part_i = torch.empty((B, plan.n_slices, k), dtype=torch.int32, device=docs.device)
    with torch.cuda.device(docs.device):
        stream = torch.cuda.current_stream(docs.device).cuda_stream
        err = lib.tk_topk_retrieval(
            _DTYPE_CODES[docs.dtype], q.data_ptr(), docs.data_ptr(), part_s.data_ptr(),
            part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), B, N, d, k,
            plan.n_slices, plan.tiles_per_slice, plan.stages, stream)
    if err != 0:
        raise RuntimeError(f"topk_retrieval: CUDA launch failed with cudaError_t {err}")
    topk_retrieval.launches += 1
    return out_s, out_i


topk_retrieval.launches = 0


def reset_launch_counts() -> None:
    topk_retrieval.launches = 0
