// Paged GQA attention kernels for Hopper (sm_90a), bound to PyTorch through
// a plain C interface (ctypes). Built by repro_torch/kernels/_build.py.
//
// paged_decode_attention
//   Replaces the Pallas kernel repro/kernels/decode_attention.py::
//   paged_decode_attention (body _paged_decode_kernel). One query token per
//   batch row attends the row's KV through its block table, valid below
//   lengths[b] and where the table entry is >= 0.
//
// paged_chunk_attention
//   Replaces the Pallas kernel repro/kernels/decode_attention.py::
//   paged_chunk_attention (body _paged_chunk_kernel). T packed query tokens
//   each attend their own row's paged KV through block_tables[row_of[t]],
//   under the span mask  slot < p_end[t]  OR  s_start[t] <= slot <= slots[t].
//   A pad token (row_of[t] < 0) writes zeros.
//
// What bounds them on the H100: bytes of K/V read from device memory. Each
// query head does 4 flops per K/V element pair it reads, far below the ~295
// flops per byte at which the card stops being bandwidth-bound, so both
// kernels are bandwidth-bound.
// What the design does about it: one thread block per (row or packed token,
// KV head) reads each KV block of its chain once and shares it across the
// G = H / KVH query heads of the group, so K/V bytes are not multiplied by
// G. Blocks outside the row's length or the token's span, and -1 table
// entries, are skipped without a load. The block's eight warps walk the chain
// in parallel, one 16-slot block each, keeping K and V in registers (int8
// dequantised by the block's per-KV-head scale) and a per-warp online
// softmax (running max, sum and (G, hd) accumulator, f32); the warps' states
// are merged at the end, so the scores of a row never leave the SM.
// Known weak spots (later work): decode has only B * KVH thread blocks, and
// the chunk kernel reads a row's KV once per packed token of that row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBS = 16;  // the block_size the kernels take
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements from a 16-byte aligned address, as float, in
// 16-byte loads (N * sizeof(T) must be a multiple of 16).
template <typename T, int N> struct Load16;
template <int N> struct Load16<float, N> {
  __device__ __forceinline__ static void run(const float* p, float* out) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 x = reinterpret_cast<const float4*>(p)[c];
      out[4 * c] = x.x;
      out[4 * c + 1] = x.y;
      out[4 * c + 2] = x.z;
      out[4 * c + 3] = x.w;
    }
  }
};
template <int N> struct Load16<__nv_bfloat16, N> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p, float* out) {
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[c];
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // little-endian: element 2k in the low half
        out[8 * c + 2 * k] = __uint_as_float(w[k] << 16);
        out[8 * c + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
};
template <int N> struct Load16<int8_t, N> {
  __device__ __forceinline__ static void run(const int8_t* p, float* out) {
#pragma unroll
    for (int c = 0; c < N / 16; ++c) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[c];
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        out[16 * c + k] = static_cast<float>(static_cast<int8_t>((w[k / 4] >> (8 * (k % 4))) & 0xffu));
      }
    }
  }
};

// Decode: slots below the row's length.
struct DecodeMask {
  int len;
  __device__ __forceinline__ int n_blocks() const { return (len + kBS - 1) / kBS; }
  __device__ __forceinline__ bool block_live(int lo) const { return lo < len; }
  __device__ __forceinline__ bool valid(int s) const { return s < len; }
};

// Ragged chunk: the segmented-prompt span of one packed token.
struct ChunkMask {
  int slot, p_end, s_start;
  __device__ __forceinline__ int n_blocks() const {
    const int last = slot > p_end - 1 ? slot : p_end - 1;
    return last / kBS + 1;
  }
  __device__ __forceinline__ bool block_live(int lo) const {
    return lo < p_end || (lo + kBS - 1 >= s_start && lo <= slot);
  }
  __device__ __forceinline__ bool valid(int s) const {
    return s < p_end || (s >= s_start && s <= slot);
  }
};

// Shared-memory plan (floats): q (G*hd) | per-warp accumulators
// (kWarps*G*hd) | per-warp running max (kWarps*G) | per-warp sum (kWarps*G).
__host__ __device__ inline size_t smem_floats(int G, int hd) {
  return (size_t)G * hd * (1 + kWarps) + (size_t)2 * kWarps * G;
}

// One (query row, KV head) of attention over a block chain. q_row points at
// the G*HD query values of this KV head's group; out_row likewise; table is
// the row's mb block ids. Warp w takes the chain's blocks w, w + kWarps, ...
// Within a warp, lane (i, h) = (lane % 16, lane / 16) scores slot i of the
// block over half h of head_dim, and owns output columns lane*HD/32 .. +HD/32.
template <typename QT, typename KVT, int HD, typename Mask>
__device__ void attend(const QT* __restrict__ q_row, const KVT* __restrict__ k_pool,
                       const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ table,
                       QT* __restrict__ out_row, Mask mask, int kvh, int KVH, int G, int mb,
                       float scale) {
  constexpr int KH = HD / 2;   // K columns a lane scores
  constexpr int DPL = HD / 32; // output columns a lane owns
  extern __shared__ __align__(16) float smem[];
  float* q = smem;
  float* acc_all = q + G * HD;
  float* m_all = acc_all + kWarps * G * HD;
  float* l_all = m_all + kWarps * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i = lane % kBS, h = lane / kBS;
  float* acc = acc_all + warp * G * HD;
  float* m = m_all + warp * G;
  float* l = l_all + warp * G;

  for (int e = tid; e < G * HD; e += kThreads) q[e] = to_f32(q_row[e]);
  for (int e = tid; e < kWarps * G * HD; e += kThreads) acc_all[e] = 0.f;
  for (int e = tid; e < kWarps * G; e += kThreads) {
    m_all[e] = -INFINITY;
    l_all[e] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)KVH * HD;  // elements between slots
  int nb = mask.n_blocks();
  if (nb > mb) nb = mb;
  for (int j = warp; j < nb; j += kWarps) {
    const int blk = table[j];
    // -1 entries and blocks outside the length/span are skipped unread;
    // the test is uniform across the warp
    if (blk < 0 || !mask.block_live(j * kBS)) continue;
    const float ks = k_scale != nullptr ? k_scale[(size_t)blk * KVH + kvh] : 1.f;
    const float vs = v_scale != nullptr ? v_scale[(size_t)blk * KVH + kvh] : 1.f;
    const KVT* base_k = k_pool + ((size_t)blk * kBS * KVH + kvh) * HD;
    const KVT* base_v = v_pool + ((size_t)blk * kBS * KVH + kvh) * HD;
    float kr[KH];
    Load16<KVT, KH>::run(base_k + i * row_stride + h * KH, kr);
    float vr[kBS][DPL];
#pragma unroll
    for (int s = 0; s < kBS; ++s) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) vr[s][c] = to_f32(base_v[s * row_stride + lane * DPL + c]);
    }
    const bool valid = mask.valid(j * kBS + i);
    const float sk = scale * ks;
    for (int g = 0; g < G; ++g) {
      const float* qg = q + g * HD + h * KH;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int d = 0; d < KH; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qg + d);
        a0 = fmaf(qq.x, kr[d], a0);
        a1 = fmaf(qq.y, kr[d + 1], a1);
        a2 = fmaf(qq.z, kr[d + 2], a2);
        a3 = fmaf(qq.w, kr[d + 3], a3);
      }
      float dot = (a0 + a1) + (a2 + a3);
      dot += __shfl_xor_sync(kFull, dot, kBS);  // the other half of head_dim
      const float s = valid ? dot * sk : -INFINITY;
      const float m_old = m[g];
      float mx = fmaxf(s, m_old);
#pragma unroll
      for (int w = kBS / 2; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      if (mx == -INFINITY) continue;  // nothing valid yet (uniform across the warp)
      const float p = s == -INFINITY ? 0.f : expf(s - mx);
      float sum = p;
#pragma unroll
      for (int w = kBS / 2; w > 0; w /= 2) sum += __shfl_xor_sync(kFull, sum, w);
      const float alpha = expf(m_old - mx);  // 0 on the first live block
      float o[DPL];
      float* ag = acc + g * HD + lane * DPL;
#pragma unroll
      for (int c = 0; c < DPL; ++c) o[c] = ag[c] * alpha;
#pragma unroll
      for (int s2 = 0; s2 < kBS; ++s2) {
        const float ps = __shfl_sync(kFull, p, s2) * vs;
#pragma unroll
        for (int c = 0; c < DPL; ++c) o[c] = fmaf(ps, vr[s2][c], o[c]);
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c) ag[c] = o[c];
      __syncwarp();  // every lane has read m[g] and l[g]
      if (lane == 0) {
        m[g] = mx;
        l[g] = l[g] * alpha + sum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // merge the warps' states: out = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M)
  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_all[w * G + g]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float mw = m_all[w * G + g];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - M);
        L = fmaf(l_all[w * G + g], c, L);
        O = fmaf(acc_all[w * G * HD + e], c, O);
      }
    }
    out_row[e] = from_f32<QT>(L > 0.f ? O / L : 0.f);
  }
}

template <typename QT, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ lengths, QT* __restrict__ out, int H, int KVH,
                    int mb, float scale) {
  const int b = blockIdx.x, kvh = blockIdx.y, G = H / KVH;
  const size_t off = ((size_t)b * H + (size_t)kvh * G) * HD;
  attend<QT, KVT, HD>(q + off, k_pool, v_pool, k_scale, v_scale, tables + (size_t)b * mb,
                      out + off, DecodeMask{lengths[b]}, kvh, KVH, G, mb, scale);
}

template <typename QT, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                   const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ tables,
                   const int* __restrict__ row_of, const int* __restrict__ slots,
                   const int* __restrict__ p_end, const int* __restrict__ s_start,
                   QT* __restrict__ out, int H, int KVH, int mb, float scale) {
  const int t = blockIdx.x, kvh = blockIdx.y, G = H / KVH;
  const size_t off = ((size_t)t * H + (size_t)kvh * G) * HD;
  const int row = row_of[t];
  if (row < 0) {  // packed pad token
    for (int e = threadIdx.x; e < G * HD; e += kThreads) out[off + e] = from_f32<QT>(0.f);
    return;
  }
  attend<QT, KVT, HD>(q + off, k_pool, v_pool, k_scale, v_scale, tables + (size_t)row * mb,
                      out + off, ChunkMask{slots[t], p_end[t], s_start[t]}, kvh, KVH, G,
                      mb, scale);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

template <typename QT, typename KVT, int HD>
cudaError_t launch_decode_hd(const void* q, const void* k, const void* v, const float* ks,
                             const float* vs, const int* tables, const int* lengths,
                             void* out, int B, int H, int KVH, int mb, float scale,
                             cudaStream_t stream) {
  const size_t smem = smem_floats(H / KVH, HD) * sizeof(float);
  auto kernel = paged_decode_kernel<QT, KVT, HD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KVH), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v), ks,
      vs, tables, lengths, static_cast<QT*>(out), H, KVH, mb, scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT, int HD>
cudaError_t launch_chunk_hd(const void* q, const void* k, const void* v, const float* ks,
                            const float* vs, const int* tables, const int* row_of,
                            const int* slots, const int* p_end, const int* s_start,
                            void* out, int T, int H, int KVH, int mb, float scale,
                            cudaStream_t stream) {
  const size_t smem = smem_floats(H / KVH, HD) * sizeof(float);
  auto kernel = paged_chunk_kernel<QT, KVT, HD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T, KVH), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v), ks,
      vs, tables, row_of, slots, p_end, s_start, static_cast<QT*>(out), H, KVH, mb, scale);
  return cudaGetLastError();
}

// head_dim is a template parameter (registers are indexed at compile time);
// the kernels take 64 and 128, the head dims of the archs the port serves.
template <typename QT, typename KVT>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const float* ks,
                          const float* vs, const int* tables, const int* lengths, void* out,
                          int B, int H, int KVH, int hd, int bs, int mb, float scale,
                          cudaStream_t stream) {
  if (bs != kBS) return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_decode_hd<QT, KVT, 64>(q, k, v, ks, vs, tables, lengths, out, B, H, KVH,
                                         mb, scale, stream);
  if (hd == 128)
    return launch_decode_hd<QT, KVT, 128>(q, k, v, ks, vs, tables, lengths, out, B, H, KVH,
                                          mb, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename QT, typename KVT>
cudaError_t launch_chunk(const void* q, const void* k, const void* v, const float* ks,
                         const float* vs, const int* tables, const int* row_of,
                         const int* slots, const int* p_end, const int* s_start, void* out,
                         int T, int H, int KVH, int hd, int bs, int mb, float scale,
                         cudaStream_t stream) {
  if (bs != kBS) return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_chunk_hd<QT, KVT, 64>(q, k, v, ks, vs, tables, row_of, slots, p_end,
                                        s_start, out, T, H, KVH, mb, scale, stream);
  if (hd == 128)
    return launch_chunk_hd<QT, KVT, 128>(q, k, v, ks, vs, tables, row_of, slots, p_end,
                                         s_start, out, T, H, KVH, mb, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dispatch on (q dtype, pool dtype): q is f32 or bf16; a float pool has q's
// dtype, an int8 pool (with f32 scales of shape (n_blocks, KVH)) takes either.
#define PA_DISPATCH(FN, ...)                                                      \
  switch (q_dtype * 3 + kv_dtype) {                                               \
    case kF32 * 3 + kF32: return static_cast<int>(FN<float, float>(__VA_ARGS__));  \
    case kF32 * 3 + kI8: return static_cast<int>(FN<float, int8_t>(__VA_ARGS__));  \
    case kBF16 * 3 + kBF16:                                                       \
      return static_cast<int>(FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__));     \
    case kBF16 * 3 + kI8:                                                         \
      return static_cast<int>(FN<__nv_bfloat16, int8_t>(__VA_ARGS__));            \
    default: return static_cast<int>(cudaErrorInvalidValue);                      \
  }

extern "C" {

// Bytes of dynamic shared memory one thread block takes.
int pa_smem_bytes(int G, int hd) {
  return static_cast<int>(smem_floats(G, hd) * sizeof(float));
}

// Each launcher returns the cudaError_t of its launch (0 on success).
int pa_paged_decode_attention(int q_dtype, int kv_dtype, const void* q, const void* k_pool,
                              const void* v_pool, const float* k_scale, const float* v_scale,
                              const int* tables, const int* lengths, void* out, int B, int H,
                              int KVH, int hd, int bs, int mb, float scale, void* stream) {
  PA_DISPATCH(launch_decode, q, k_pool, v_pool, k_scale, v_scale, tables,
              lengths, out, B, H, KVH, hd, bs, mb, scale, static_cast<cudaStream_t>(stream))
}

int pa_paged_chunk_attention(int q_dtype, int kv_dtype, const void* q, const void* k_pool,
                             const void* v_pool, const float* k_scale, const float* v_scale,
                             const int* tables, const int* row_of, const int* slots,
                             const int* p_end, const int* s_start, void* out, int T, int H,
                             int KVH, int hd, int bs, int mb, float scale, void* stream) {
  PA_DISPATCH(launch_chunk, q, k_pool, v_pool, k_scale, v_scale, tables,
              row_of, slots, p_end, s_start, out, T, H, KVH, hd, bs, mb, scale,
              static_cast<cudaStream_t>(stream))
}

}  // extern "C"
