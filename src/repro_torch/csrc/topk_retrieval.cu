// Fused dense-retrieval scoring and top-k for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes). Built by
// repro_torch/kernels/_build.py.
//
// topk_retrieval
//   Replaces the Pallas kernel repro/kernels/topk_retrieval.py::
//   topk_retrieval (body _topk_kernel). Scores queries (B, d) against docs
//   (N, d) in float32 and returns, per query, the k best as (B, k) float32
//   scores and (B, k) int32 doc ids in descending score order, equal scores
//   resolved to the lower doc id (the order of lax.top_k). Docs are float32
//   or bfloat16; queries arrive in float32.
//
// What bounds it on the H100: at the retrieval phase's shapes (N = 2^21,
// d = 768, B = 32) both the bytes (the corpus read once: 6.4 GB in f32,
// ~1.9 ms at 3.35 TB/s) and the f32 products (2 B N d = 1.0e11 flops,
// ~1.5 ms at 67 TFLOP/s on the CUDA cores) are close, so the kernel must
// read the corpus once and keep the FMA pipes busy.
// What the design does about it: the Pallas grid streams the whole corpus
// once per query; here each thread block owns a contiguous slice of the
// corpus and scores it against a tile of 32 queries held in shared memory,
// so a doc row is read from device memory once per 32 queries (once in
// all for B <= 32), in 16-byte loads staged through shared memory in
// 32-column chunks, the next chunk prefetched into registers while the
// current one is scored. Each thread keeps an 8-doc x 4-query register tile
// of f32 sums (plain FMAs on the CUDA cores: no TF32, no bf16 products).
// The scores of a 256-doc tile never leave the SM: each warp filters its
// queries' scores against the query's current k-th best (a ballot), appends
// the survivors to a shared-memory buffer and, when the buffer fills,
// bitonic-sorts it and merges it into the query's sorted top list. A second
// kernel merges the per-slice lists of each query the same way.
// Known weak spots (later work): one 256-thread block per SM (the query
// tile takes 96 KB of shared memory at d = 768), no cp.async/TMA, and the
// products stay off the tensor cores to keep the f32 contract.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 32;              // queries per thread block (one tile)
constexpr int kTN = 256;             // docs per tile
constexpr int kKC = 32;              // columns of a staged chunk
constexpr int kDocStride = kKC + 1;  // padded smem row: conflict-free reads
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoId = 0x7fffffff;    // id of an empty list entry

enum DType { kF32 = 0, kBF16 = 1 };

static_assert(kQT * kTN <= kTN * kDocStride, "the score tile reuses the doc chunk");
static_assert(kThreads == 32 * (kQT / 4) && kTN == 32 * 8, "8-doc x 4-query thread tiles");

// the order of the result: higher score first, then lower id
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of K (score, id) pairs in shared memory, best first, by one
// warp.
template <int K>
__device__ void sort_desc(float* s, int* id, int lane) {
#pragma unroll 1
  for (int size = 2; size <= K; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < K / 2; t += 32) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const float a = s[lo], b = s[hi];
        const int ia = id[lo], ib = id[hi];
        if (desc ? better(b, ib, a, ia) : better(a, ia, b, ib)) {
          s[lo] = b; s[hi] = a; id[lo] = ib; id[hi] = ia;
        }
      }
      __syncwarp();
    }
  }
}

// ts/ti (sorted, best first) becomes the best K of itself and bs/bi (sorted,
// best first): the elementwise better of ts[i] and bs[K-1-i] is a bitonic
// sequence holding the best K of the union, which a bitonic merge sorts.
template <int K>
__device__ void merge_into(float* ts, int* ti, const float* bs, const int* bi, int lane) {
  for (int i = lane; i < K; i += 32) {
    const float b = bs[K - 1 - i];
    const int ib = bi[K - 1 - i];
    if (better(b, ib, ts[i], ti[i])) { ts[i] = b; ti[i] = ib; }
  }
  __syncwarp();
#pragma unroll 1
  for (int stride = K / 2; stride > 0; stride >>= 1) {
    for (int t = lane; t < K / 2; t += 32) {
      const int lo = 2 * stride * (t / stride) + (t % stride);
      const int hi = lo + stride;
      const float a = ts[lo], b = ts[hi];
      const int ia = ti[lo], ib = ti[hi];
      if (better(b, ib, a, ia)) { ts[lo] = b; ts[hi] = a; ti[lo] = ib; ti[hi] = ia; }
    }
    __syncwarp();
  }
}

// One query's running top-K, owned by one warp: a sorted list and a buffer
// of candidates, 4 * K words of shared memory at `base`. Every call is made
// by the whole warp; cnt and the threshold are warp-uniform.
template <int K>
struct TopK {
  float* base;
  int cnt;
  float thr_s;  // the k-th best so far: only a better candidate can enter
  int thr_i;

  __device__ float* ts() const { return base; }
  __device__ int* ti() const { return reinterpret_cast<int*>(base + K); }
  __device__ float* bs() const { return base + 2 * K; }
  __device__ int* bi() const { return reinterpret_cast<int*>(base + 3 * K); }

  __device__ void init(float* b, int lane) {
    base = b;
    for (int i = lane; i < K; i += 32) { ts()[i] = -INFINITY; ti()[i] = kNoId; }
    cnt = 0;
    thr_s = -INFINITY;
    thr_i = kNoId;
    __syncwarp();
  }

  __device__ void flush(int k, int lane) {
    if (cnt == 0) return;
    for (int i = cnt + lane; i < K; i += 32) { bs()[i] = -INFINITY; bi()[i] = kNoId; }
    __syncwarp();
    sort_desc<K>(bs(), bi(), lane);
    merge_into<K>(ts(), ti(), bs(), bi(), lane);
    cnt = 0;
    thr_s = ts()[k - 1];
    thr_i = ti()[k - 1];
    __syncwarp();
  }

  // each lane offers one candidate (valid = false offers nothing)
  __device__ void offer(float s, int id, bool valid, int k, int lane) {
    bool pass = valid && better(s, id, thr_s, thr_i);
    unsigned m = __ballot_sync(kFull, pass);
    if (m == 0) return;
    if (cnt + __popc(m) > K) {
      flush(k, lane);
      pass = valid && better(s, id, thr_s, thr_i);
      m = __ballot_sync(kFull, pass);
      if (m == 0) return;
    }
    if (pass) {
      const int pos = cnt + __popc(m & ((1u << lane) - 1u));
      bs()[pos] = s;
      bi()[pos] = id;
    }
    cnt += __popc(m);
  }
};

// A 256-doc x 32-column chunk of the corpus: loaded by each thread in
// 16-byte pieces into registers, then stored as float32 into the padded
// shared-memory tile [doc][kDocStride]. Columns at or past d read zeros.
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int kVec = 4;
  static constexpr int kParts = kKC / kVec;                 // 16-byte pieces per row
  static constexpr int kPer = kTN * kParts / kThreads;      // pieces per thread
  float4 v[kPer];

  __device__ void load(const float* docs, int N, int d, int doc0, int col0, int tid) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int idx = tid + r * kThreads;
      const int doc = doc0 + idx / kParts, col = col0 + (idx % kParts) * kVec;
      v[r] = (doc < N && col < d)
                 ? __ldg(reinterpret_cast<const float4*>(docs + (size_t)doc * d + col))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ void store(float* tile, int tid) const {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int idx = tid + r * kThreads;
      float* p = tile + (idx / kParts) * kDocStride + (idx % kParts) * kVec;
      p[0] = v[r].x; p[1] = v[r].y; p[2] = v[r].z; p[3] = v[r].w;
    }
  }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kParts = kKC / kVec;
  static constexpr int kPer = kTN * kParts / kThreads;
  uint4 v[kPer];

  __device__ void load(const __nv_bfloat16* docs, int N, int d, int doc0, int col0, int tid) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int idx = tid + r * kThreads;
      const int doc = doc0 + idx / kParts, col = col0 + (idx % kParts) * kVec;
      v[r] = (doc < N && col < d)
                 ? __ldg(reinterpret_cast<const uint4*>(docs + (size_t)doc * d + col))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ void store(float* tile, int tid) const {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int idx = tid + r * kThreads;
      float* p = tile + (idx / kParts) * kDocStride + (idx % kParts) * kVec;
      const unsigned w[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // little-endian: element 2e in the low half
        p[2 * e] = __uint_as_float(w[e] << 16);
        p[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  }
};

// Pass 1. Block (slice, query tile): the top-k of each of the tile's queries
// over the slice's docs [tile0 * kTN, tile1 * kTN), written to
// part[query][slice][0..k).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
topk_partial_kernel(const float* __restrict__ q, const T* __restrict__ docs,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    int B, int N, int d, int k, int n_chunks, int tiles_per_slice,
                    int n_slices) {
  extern __shared__ __align__(16) float smem[];
  const int dp = n_chunks * kKC;
  float* sQ = smem;                        // [dp][kQT], zeros past d and B
  float* sDoc = sQ + dp * kQT;             // staged chunk; then the score tile [kQT][kTN]
  float* lists = sDoc + kTN * kDocStride;  // 4 * K words per query
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x, q0 = blockIdx.y * kQT;
  const int n_tiles = (N + kTN - 1) / kTN;
  const int tile0 = slice * tiles_per_slice;
  const int tile1 = min(tile0 + tiles_per_slice, n_tiles);

  for (int i = tid; i < dp * kQT; i += kThreads) {
    const int dd = i / kQT, qi = i % kQT;
    sQ[i] = (q0 + qi < B && dd < d) ? q[(size_t)(q0 + qi) * d + dd] : 0.f;
  }
  // warp w scores queries 4w..4w+3 and owns their top lists
  TopK<K> st[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) st[j].init(lists + (4 * warp + j) * 4 * K, lane);

  Chunk<T> ch;
  ch.load(docs, N, d, tile0 * kTN, 0, tid);
  ch.store(sDoc, tid);
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_steps = (tile1 - tile0) * n_chunks;
  for (int step = 0; step < n_steps; ++step) {
    const int tile = tile0 + step / n_chunks, c = step % n_chunks;
    const bool more = step + 1 < n_steps;
    if (more)
      ch.load(docs, N, d, (tile0 + (step + 1) / n_chunks) * kTN,
              ((step + 1) % n_chunks) * kKC, tid);
    const float* qrow = sQ + c * kKC * kQT + 4 * warp;
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + kk * kQT);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dv = sDoc[(lane + 32 * i) * kDocStride + kk];
        acc[i][0] = fmaf(dv, qv.x, acc[i][0]);
        acc[i][1] = fmaf(dv, qv.y, acc[i][1]);
        acc[i][2] = fmaf(dv, qv.z, acc[i][2]);
        acc[i][3] = fmaf(dv, qv.w, acc[i][3]);
      }
    }
    __syncthreads();
    if (c == n_chunks - 1) {
      // the tile's scores to shared memory, then each warp offers its
      // queries' 256 scores to their top lists
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sDoc[(4 * warp + j) * kTN + lane + 32 * i] = acc[i][j];
          acc[i][j] = 0.f;
        }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = 4 * warp + j;
        if (q0 + qi >= B) continue;  // warp-uniform
        for (int i = 0; i < kTN / 32; ++i) {
          const int n = 32 * i + lane, doc = tile * kTN + n;
          st[j].offer(sDoc[qi * kTN + n], doc, doc < N, k, lane);
        }
      }
      __syncthreads();
    }
    if (more) ch.store(sDoc, tid);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = q0 + 4 * warp + j;
    if (b >= B) continue;
    st[j].flush(k, lane);
    const size_t o = ((size_t)b * n_slices + slice) * k;
    for (int r = lane; r < k; r += 32) {
      part_s[o + r] = st[j].ts()[r];
      part_i[o + r] = st[j].ti()[r];
    }
  }
}

// Pass 2. Block b merges query b's M = n_slices * k partial results: each
// warp offers a strided share to its own list, then warp 0 merges the lists.
template <int K>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                  float* __restrict__ out_s, int* __restrict__ out_i, int M, int k) {
  __shared__ __align__(16) float lists[kWarps][4 * K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.x;
  const float* ps = part_s + (size_t)b * M;
  const int* pi = part_i + (size_t)b * M;
  TopK<K> st;
  st.init(lists[warp], lane);
  int i = 32 * warp + lane;
  float s = i < M ? ps[i] : -INFINITY;
  int id = i < M ? pi[i] : kNoId;
  for (int base = 32 * warp; base < M; base += kThreads) {
    const int ni = base + kThreads + lane;  // prefetch the next round
    const float ns = ni < M ? ps[ni] : -INFINITY;
    const int nid = ni < M ? pi[ni] : kNoId;
    st.offer(s, id, base + lane < M, k, lane);
    s = ns;
    id = nid;
  }
  st.flush(k, lane);
  __syncthreads();
  if (warp == 0) {
    TopK<K> w0;
    w0.base = lists[0];
    for (int w = 1; w < kWarps; ++w) {
      TopK<K> other;
      other.base = lists[w];
      merge_into<K>(w0.ts(), w0.ti(), other.ts(), other.ti(), lane);
    }
    for (int r = lane; r < k; r += 32) {
      out_s[(size_t)b * k + r] = w0.ts()[r];
      out_i[(size_t)b * k + r] = w0.ti()[r];
    }
  }
}

int list_capacity(int k) { return k <= 32 ? 32 : (k <= 64 ? 64 : 128); }

int smem_bytes(int d, int K) {
  const int n_chunks = (d + kKC - 1) / kKC;
  return (n_chunks * kKC * kQT + kTN * kDocStride + kQT * 4 * K) * (int)sizeof(float);
}

template <typename T, int K>
int launch(const float* q, const T* docs, float* part_s, int* part_i, float* out_s,
           int* out_i, int B, int N, int d, int k, int n_slices, int tiles_per_slice,
           cudaStream_t stream) {
  const int smem = smem_bytes(d, K);
  auto* pass1 = topk_partial_kernel<T, K>;
  cudaError_t err =
      cudaFuncSetAttribute(pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (d + kKC - 1) / kKC;
  const dim3 grid(n_slices, (B + kQT - 1) / kQT);
  pass1<<<grid, kThreads, smem, stream>>>(q, docs, part_s, part_i, B, N, d, k, n_chunks,
                                          tiles_per_slice, n_slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<K><<<B, kThreads, 0, stream>>>(part_s, part_i, out_s, out_i,
                                                   n_slices * k, k);
  return cudaGetLastError();
}

template <typename T>
int dispatch_k(const float* q, const T* docs, float* part_s, int* part_i, float* out_s,
               int* out_i, int B, int N, int d, int k, int n_slices, int tiles_per_slice,
               cudaStream_t stream) {
  switch (list_capacity(k)) {
    case 32:
      return launch<T, 32>(q, docs, part_s, part_i, out_s, out_i, B, N, d, k, n_slices,
                           tiles_per_slice, stream);
    case 64:
      return launch<T, 64>(q, docs, part_s, part_i, out_s, out_i, B, N, d, k, n_slices,
                           tiles_per_slice, stream);
    default:
      return launch<T, 128>(q, docs, part_s, part_i, out_s, out_i, B, N, d, k, n_slices,
                            tiles_per_slice, stream);
  }
}

}  // namespace

extern "C" {

// constants the wrapper checks against before a launch
int tk_max_k() { return 128; }
int tk_docs_per_tile() { return kTN; }
int tk_smem_bytes(int d, int k) { return smem_bytes(d, list_capacity(k)); }

// queries: (B, d) float32; docs: (N, d) float32 (doc_dtype 0) or bfloat16
// (1), rows 16-byte aligned (d % 8 == 0); part_s/part_i: (B, n_slices, k)
// scratch; out_s/out_i: (B, k). The slices cover tiles_per_slice tiles of
// kTN docs each. Returns a cudaError_t (0 = launched).
int tk_topk_retrieval(int doc_dtype, const void* q, const void* docs, void* part_s,
                      void* part_i, void* out_s, void* out_i, int B, int N, int d, int k,
                      int n_slices, int tiles_per_slice, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  if (doc_dtype == kF32)
    return dispatch_k(qf, static_cast<const float*>(docs), ps, pi, os, oi, B, N, d, k,
                      n_slices, tiles_per_slice, s);
  if (doc_dtype == kBF16)
    return dispatch_k(qf, static_cast<const __nv_bfloat16*>(docs), ps, pi, os, oi, B, N,
                      d, k, n_slices, tiles_per_slice, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
