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
kernel does not take raises ``ValueError``.

``ref_topk_retrieval`` is the numerics contract (``ref.topk_retrieval_ref``
of the JAX package): one float32 matrix product, then a stable descending
sort, so equal scores keep the lower id first.
"""
from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024       # shared memory a block can use on the H100


def ref_topk_retrieval(queries, docs, k: int = 16):
    """Plain version: queries (B, d), docs (N, d) -> (scores (B, k) float32,
    ids (B, k) int32), best first, ties to the lower id."""
    scores = queries.float() @ docs.float().T
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].to(torch.int32).contiguous()


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
    _check(docs.is_cuda and queries.device == docs.device,
           f"unsupported devices {queries.device}, {docs.device}")
    _check(docs.dtype in _DTYPE_CODES, f"docs must be float32 or bfloat16, got {docs.dtype}")
    _check(queries.is_floating_point(), f"queries must be float, got {queries.dtype}")
    _check(docs.is_contiguous(), "docs must be contiguous")
    _check(d % 8 == 0 and docs.data_ptr() % 16 == 0,
           "the kernel reads docs in 16-byte loads: d must be a multiple of 8 and "
           "docs 16-byte aligned")
    _check(N < 2**31 - 1, "doc ids must fit in int32")
    from repro_torch.kernels._build import load_library

    lib = load_library("topk_retrieval").lib
    _check(k <= lib.tk_max_k(), f"the kernel takes k <= {lib.tk_max_k()}, got {k}")
    smem = lib.tk_smem_bytes(d, k)
    _check(smem <= _SMEM_LIMIT,
           f"shared memory per block {smem} B at d={d} exceeds the H100's 227 KB")
    q = queries.float().contiguous()
    out_s = torch.empty((B, k), dtype=torch.float32, device=docs.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=docs.device)
    if B == 0:
        return out_s, out_i
    # one slice of the corpus per SM, whole tiles each
    n_tiles = -(-N // lib.tk_docs_per_tile())
    sms = torch.cuda.get_device_properties(docs.device).multi_processor_count
    tiles_per_slice = -(-n_tiles // min(sms, n_tiles))
    n_slices = -(-n_tiles // tiles_per_slice)
    part_s = torch.empty((B, n_slices, k), dtype=torch.float32, device=docs.device)
    part_i = torch.empty((B, n_slices, k), dtype=torch.int32, device=docs.device)
    with torch.cuda.device(docs.device):
        stream = torch.cuda.current_stream(docs.device).cuda_stream
        err = lib.tk_topk_retrieval(
            _DTYPE_CODES[docs.dtype], q.data_ptr(), docs.data_ptr(), part_s.data_ptr(),
            part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), B, N, d, k,
            n_slices, tiles_per_slice, stream)
    if err != 0:
        raise RuntimeError(f"topk_retrieval: CUDA launch failed with cudaError_t {err}")
    topk_retrieval.launches += 1
    return out_s, out_i


topk_retrieval.launches = 0


def reset_launch_counts() -> None:
    topk_retrieval.launches = 0
