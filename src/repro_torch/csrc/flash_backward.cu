// Backward of causal GQA flash attention for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes). Built by
// repro_torch/kernels/_build.py; the autograd Function of
// repro_torch/kernels/flash_attention.py runs it for CUDA tensors.
//
// Replaces repro/models/attention.py::_flash_backward, the custom_vjp rule of
// blockwise_attention: plain jnp, no Pallas kernel, a two-pass recompute
// backward. From q (B, S, H, HDK), k (B, S, KVH, HDK), v (B, S, KVH, HDV),
// the forward's output o and its gradient do (B, S, H, HDV) it computes dq,
// dk and dv in the inputs' dtype, everything in f32 inside: the row's
// log-sum-exp L (recomputed: the forward kernel writes none), delta = sum
// do * o, the probabilities p = exp(scale q.k - L), dp = do . v,
// ds = p (dp - delta) scale, dq = sum_keys ds k, dk = sum_rows ds q and
// dv = sum_rows p do, the group's query heads summed into their KV head.
// Causal only (a key at or before the row), at the head dims of the
// training slice: (64, 64) and (128, 128); any S >= 1, any G = H / KVH.
//
// Bound on the H100: operations. Five S x S x hd products a head, halved
// by the causal mask, against each tensor read or written once: at S 2048,
// hd 128 some 1700 flops a byte. This first version keeps the arithmetic
// on the CUDA cores in f32 (bf16 inputs are widened as they are staged), as
// the forward's f32 kernel does: simple, and exactly the f32 contract.
//
// Three kernels, one 256-thread block (16 x 16: ty = tid / 16, tx = tid %
// 16) per tile of 64 rows, no atomics, so every result is deterministic:
//   (a) fb_rows_kernel, per (query tile, head, batch row): L of each row by
//       one online pass over the keys it sees, and delta; both (B, H, S) f32.
//   (b) fb_dkdv_kernel, per (key tile, KV head, batch row): the G query
//       heads of the group and the query tiles at or after the key tile in
//       turn. Its scores are laid out transposed (the thread's rows are keys
//       ty + 16a, its columns queries tx + 16b), so that dv += p^T do and
//       dk += ds^T q, like the forward's o += p v, take each probability
//       from the half-warp that holds its key row by shuffles. dk and dv
//       stay in registers across the group.
//   (c) fb_dq_kernel, per (query tile, head, batch row): the key tiles at or
//       before the query tile; dq += ds k in registers, the same way.
// Tiles are staged in shared memory as f32 rows padded by 4 floats (16-byte
// aligned rows; the 16 rows a half-warp reads fall on distinct banks). Rows
// and keys past S are zeros and masked, so S need not be a multiple of 64.
#include "attention_common.cuh"

namespace {

constexpr int kTile = 64;        // rows of a query tile and of a key tile
constexpr int kBThreads = 256;   // 16 x 16 threads

// Four consecutive elements as floats in one load (8- or 16-byte aligned).
template <typename T> struct Load4;
template <> struct Load4<float> {
  __device__ __forceinline__ static float4 run(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <> struct Load4<bf16> {
  __device__ __forceinline__ static float4 run(const bf16* p) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  }
};

// rows [row0, row0 + kTile) of a (.., S, heads, HD) tensor at head `head`
// into a padded f32 tile (row stride HD + 4); rows at or past S are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int S, int heads, int head) {
  constexpr int kQuads = HD / 4;
  for (int e = threadIdx.x; e < kTile * kQuads; e += kBThreads) {
    const int r = e / kQuads, d = (e % kQuads) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = Load4<T>::run(src + ((size_t)(row0 + r) * heads + head) * HD + d);
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + d) = x;
  }
}

// acc[i][j] = row (ty + 16i) of tile A . row (tx + 16j) of tile B, over HD
// columns (both tiles in shared memory with row stride HD + 4)
template <int HD>
__device__ __forceinline__ void tile_products(float (&acc)[4][4], const float* A,
                                              const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * (HD + 4) + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * (HD + 4) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        acc[i][j] = x;
      }
  }
}

// out[i][4g + c] += sum_kk w[i][kk] M[kk][64g + 4tx + c]: w[i][kk] is the
// value of row i at column kk of the 16 x 16 layout (held in w[i][kk / 16]
// by lane kk % 16 of this half-warp), M a tile in shared memory (row stride
// HD + 4); the thread owns output columns 64g + 4tx .. +3
template <int HD>
__device__ __forceinline__ void shuffle_products(float (&out)[4][HD / 16], const float (&w)[4][4],
                                                 const float* M, int tx, int lane) {
  constexpr int NG = HD / 64;
#pragma unroll  // whole: w[i][kk / 16] must stay in registers
  for (int kk = 0; kk < kTile; ++kk) {
    const int src = (lane & 16) | (kk & 15);
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __shfl_sync(kFull, w[i][kk / 16], src);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 m = *reinterpret_cast<const float4*>(M + kk * (HD + 4) + 64 * g + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[i][4 * g] = fmaf(p[i], m.x, out[i][4 * g]);
        out[i][4 * g + 1] = fmaf(p[i], m.y, out[i][4 * g + 1]);
        out[i][4 * g + 2] = fmaf(p[i], m.z, out[i][4 * g + 2]);
        out[i][4 * g + 3] = fmaf(p[i], m.w, out[i][4 * g + 3]);
      }
    }
  }
}

// rows (ty + 16i) of an accumulator with columns 64g + 4tx .. +3 to rows
// row0 + ty + 16i (< S) of a (.., S, heads, HD) tensor at head `head`
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[4][HD / 16],
                                           int row0, int S, int heads, int head, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
    T* p = dst + ((size_t)row * heads + head) * HD;
#pragma unroll
    for (int g = 0; g < HD / 64; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[64 * g + 4 * tx + c] = from_f32<T>(acc[i][4 * g + c]);
  }
}

// whether query row (of S) sees key col: causal, both inside the sequence
__device__ __forceinline__ bool visible(int row, int col, int S) {
  return row < S && col <= row;
}

// (a) L and delta of the rows of query tile blockIdx.x, head blockIdx.y,
// batch row blockIdx.z
template <typename T, int HDK, int HDV>
__global__ void __launch_bounds__(kBThreads)
fb_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
               const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
               int S, int H, int KVH, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (HDK + 4);
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * kTile;
  load_tile<T, HDK>(Qs, q + (size_t)b * S * H * HDK, q0, S, H, h);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const T* kb = k + (size_t)b * S * KVH * HDK;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous key tile is no longer read (and Q is in)
    load_tile<T, HDK>(Ks, kb, k0, S, KVH, kvh);
    __syncthreads();
    float s[4][4];
    tile_products<HDK>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(row, k0 + tx + 16 * j, S) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      // m_new is -inf only while the row has seen no key (past S): then
      // every s is -inf, the sum 0 and l stays 0
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
#pragma unroll
      for (int w = 8; w > 0; w /= 2) sum += __shfl_xor_sync(kFull, sum, w);
      l[i] = l[i] * (m[i] == -INFINITY ? 0.f : expf(m[i] - m_new)) + sum;
      m[i] = m_new;
    }
  }

  // delta = sum over the value dims of do * o, in f32: lane tx of the
  // half-warp of row ty + 16i reads columns 64g + 4tx .. +3
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float d = 0.f;
    if (row < S) {
      const size_t at = ((size_t)b * S + row) * H * HDV + (size_t)h * HDV;
#pragma unroll
      for (int g = 0; g < HDV / 64; ++g) {
        const float4 x = Load4<T>::run(dout + at + 64 * g + 4 * tx);
        const float4 y = Load4<T>::run(o + at + 64 * g + 4 * tx);
        d = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, d))));
      }
    }
#pragma unroll
    for (int w = 8; w > 0; w /= 2) d += __shfl_xor_sync(kFull, d, w);
    if (row < S && tx == 0) {
      const size_t at = ((size_t)b * H + h) * S + row;
      lse[at] = m[i] + logf(l[i]);
      delta[at] = d;
    }
  }
}

// (b) dk and dv of key tile blockIdx.x, KV head blockIdx.y, batch row
// blockIdx.z, over the group's G query heads and the query tiles that see it
template <typename T, int HDK, int HDV>
__global__ void __launch_bounds__(kBThreads, 1)
fb_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
               int H, int KVH, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Qs = Ks + kTile * (HDK + 4);
  float* Vs = Qs + kTile * (HDK + 4);
  float* dOs = Vs + kTile * (HDV + 4);
  float* Ls = dOs + kTile * (HDV + 4);
  float* Ds = Ls + kTile;
  const int kt = blockIdx.x;  // the first key tiles are seen by the most query tiles
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KVH, nq = gridDim.x;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid % 32;
  const int k0 = kt * kTile;
  load_tile<T, HDK>(Ks, k + (size_t)b * S * KVH * HDK, k0, S, KVH, kvh);
  load_tile<T, HDV>(Vs, v + (size_t)b * S * KVH * HDV, k0, S, KVH, kvh);

  float dk_acc[4][HDK / 16], dv_acc[4][HDV / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < HDK / 16; ++c) dk_acc[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < HDV / 16; ++c) dv_acc[a][c] = 0.f;
  }
  const T* qb = q + (size_t)b * S * H * HDK;
  const T* dob = dout + (size_t)b * S * H * HDV;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + ((size_t)b * H + h) * S;
    const float* delta_h = delta + ((size_t)b * H + h) * S;
    for (int qt = kt; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous query tile is no longer read
      load_tile<T, HDK>(Qs, qb, q0, S, H, h);
      load_tile<T, HDV>(dOs, dob, q0, S, H, h);
      if (tid < kTile) {
        Ls[tid] = q0 + tid < S ? lse_h[q0 + tid] : 0.f;
        Ds[tid] = q0 + tid < S ? delta_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      // transposed: rows are keys ty + 16a, columns queries tx + 16c
      float p[4][4], ds[4][4];
      tile_products<HDK>(p, Ks, Qs, ty, tx);
      tile_products<HDV>(ds, Vs, dOs, ty, tx);  // dp^T
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = tx + 16 * c;
          const bool ok = visible(q0 + qi, k0 + ty + 16 * a, S);
          p[a][c] = ok ? expf(p[a][c] * scale - Ls[qi]) : 0.f;
          ds[a][c] = p[a][c] * (ds[a][c] - Ds[qi]) * scale;
        }
      shuffle_products<HDV>(dv_acc, p, dOs, tx, lane);
      shuffle_products<HDK>(dk_acc, ds, Qs, tx, lane);
    }
  }
  store_rows<T, HDK>(dk + (size_t)b * S * KVH * HDK, dk_acc, k0, S, KVH, kvh, ty, tx);
  store_rows<T, HDV>(dv + (size_t)b * S * KVH * HDV, dv_acc, k0, S, KVH, kvh, ty, tx);
}

// (c) dq of query tile blockIdx.x (heaviest first), head blockIdx.y, batch
// row blockIdx.z, over the key tiles at or before it
template <typename T, int HDK, int HDV>
__global__ void __launch_bounds__(kBThreads, 1)
fb_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int KVH,
             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (HDK + 4);
  float* dOs = Ks + kTile * (HDK + 4);
  float* Vs = dOs + kTile * (HDV + 4);
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid % 32;
  const int q0 = qt * kTile;
  load_tile<T, HDK>(Qs, q + (size_t)b * S * H * HDK, q0, S, H, h);
  load_tile<T, HDV>(dOs, dout + (size_t)b * S * H * HDV, q0, S, H, h);
  float L[4], D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = ((size_t)b * H + h) * S + row;
    L[i] = row < S ? lse[at] : 0.f;
    D[i] = row < S ? delta[at] : 0.f;
  }
  float dq_acc[4][HDK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HDK / 16; ++c) dq_acc[i][c] = 0.f;

  const T* kb = k + (size_t)b * S * KVH * HDK;
  const T* vb = v + (size_t)b * S * KVH * HDV;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous key tile is no longer read (and Q, dO are in)
    load_tile<T, HDK>(Ks, kb, k0, S, KVH, kvh);
    load_tile<T, HDV>(Vs, vb, k0, S, KVH, kvh);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_products<HDK>(p, Qs, Ks, ty, tx);
    tile_products<HDV>(ds, dOs, Vs, ty, tx);  // dp
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(q0 + ty + 16 * i, k0 + tx + 16 * j, S);
        const float pij = ok ? expf(p[i][j] * scale - L[i]) : 0.f;
        ds[i][j] = pij * (ds[i][j] - D[i]) * scale;
      }
    shuffle_products<HDK>(dq_acc, ds, Ks, tx, lane);
  }
  store_rows<T, HDK>(dq + (size_t)b * S * H * HDK, dq_acc, q0, S, H, h, ty, tx);
}

__host__ __device__ constexpr int rows_smem_floats(int hdk) { return 2 * kTile * (hdk + 4); }
__host__ __device__ constexpr int dkdv_smem_floats(int hdk, int hdv) {
  return 2 * kTile * (hdk + 4) + 2 * kTile * (hdv + 4) + 2 * kTile;
}
__host__ __device__ constexpr int dq_smem_floats(int hdk, int hdv) {
  return 2 * kTile * (hdk + 4) + 2 * kTile * (hdv + 4);
}

template <typename T, int HDK, int HDV>
cudaError_t launch_backward_hd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, float* lse, float* delta, void* dq, void* dk,
                               void* dv, int B, int S, int H, int KVH, float scale,
                               cudaStream_t stream) {
  const int n = (S + kTile - 1) / kTile;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);

  size_t smem = rows_smem_floats(HDK) * sizeof(float);
  auto rows = fb_rows_kernel<T, HDK, HDV>;
  cudaError_t err = prepare(rows, smem);
  if (err != cudaSuccess) return err;
  rows<<<dim3(n, H, B), kBThreads, smem, stream>>>(q_, k_, static_cast<const T*>(o), do_, lse,
                                                  delta, S, H, KVH, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = dkdv_smem_floats(HDK, HDV) * sizeof(float);
  auto dkdv = fb_dkdv_kernel<T, HDK, HDV>;
  if ((err = prepare(dkdv, smem)) != cudaSuccess) return err;
  dkdv<<<dim3(n, KVH, B), kBThreads, smem, stream>>>(q_, k_, v_, do_, lse, delta,
                                                    static_cast<T*>(dk), static_cast<T*>(dv),
                                                    S, H, KVH, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = dq_smem_floats(HDK, HDV) * sizeof(float);
  auto dqk = fb_dq_kernel<T, HDK, HDV>;
  if ((err = prepare(dqk, smem)) != cudaSuccess) return err;
  dqk<<<dim3(n, H, B), kBThreads, smem, stream>>>(q_, k_, v_, do_, lse, delta,
                                                 static_cast<T*>(dq), S, H, KVH, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, float* lse, float* delta, void* dq, void* dk,
                            void* dv, int B, int S, int H, int KVH, int hdk, int hdv,
                            float scale, cudaStream_t stream) {
  if (hdk == 64 && hdv == 64)
    return launch_backward_hd<T, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KVH,
                                         scale, stream);
  if (hdk == 128 && hdv == 128)
    return launch_backward_hd<T, 128, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                                           KVH, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the largest of the three kernels takes.
int fb_smem_bytes(int hdk, int hdv) {
  return dkdv_smem_floats(hdk, hdv) * static_cast<int>(sizeof(float));
}

// Returns the cudaError_t of the launches (0 on success). q (B, S, H, hdk),
// k (B, S, KVH, hdk), v (B, S, KVH, hdv), o and dout (B, S, H, hdv), dq/dk/dv
// like q/k/v, all in one dtype (0: float32, 1: bfloat16), contiguous;
// lse and delta: (B, H, S) float32 scratch the caller allocates.
int fb_flash_backward(int dtype, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, float* lse, float* delta, void* dq, void* dk, void* dv,
                      int B, int S, int H, int KVH, int hdk, int hdv, float scale,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_backward<float>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                                     B, S, H, KVH, hdk, hdv, scale, st));
    case kBF16:
      return static_cast<int>(launch_backward<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                                    B, S, H, KVH, hdk, hdv, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
