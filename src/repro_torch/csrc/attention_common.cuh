// What the attention sources (dense_attention.cu, paged_attention.cu) share:
// element conversions and 16-byte loads, the launch preparation for large
// dynamic shared memory, and the split-cache decode's pieces: the merge of a
// block's per-warp online-softmax states into the block's, and the kernel
// that merges the blocks' partial states of one (KV head, row).
//
// The split-cache decode keeps, per (row b, KV head, split s, query head g of
// the group), the partial state of the slots the split covers: the running
// max M, the sum L = sum_i e^(s_i - M) and the accumulator O = sum_i
// e^(s_i - M) v_i, all f32. part_o is (B, KVH, n_split, G, hd), part_ml
// (B, KVH, n_split, G, 2) holding (M, L). A split with no valid slot has
// M = -inf and L = 0; the merge does not read its O.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                 // warps of a decode block
constexpr int kThreads = 32 * kWarps;

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

// A kernel that takes more than 48 KB of dynamic shared memory must say so
// before its launch.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

// Shared-memory plan of a decode block (floats): q (G*hd) | per-warp
// accumulators (kWarps*G*hd) | per-warp running max (kWarps*G) | per-warp
// sum (kWarps*G).
__host__ __device__ inline size_t decode_smem_floats(int G, int hd) {
  return (size_t)G * hd * (1 + kWarps) + (size_t)2 * kWarps * G;
}

// Merge the kWarps per-warp states of a block (acc_all, m_all, l_all in the
// plan above; the caller has synchronised) into the block's: M = max_w m_w,
// L = sum_w l_w e^(m_w - M), O = sum_w acc_w e^(m_w - M). With part_o null
// it writes out_row = O / L (zeros where no slot was valid); otherwise the
// partial state, O at part_o and (M, L) at part_ml, both already offset to
// this block's partial.
template <typename T>
__device__ void store_block_state(const float* acc_all, const float* m_all, const float* l_all,
                                  int G, int hd, T* __restrict__ out_row,
                                  float* __restrict__ part_o, float* __restrict__ part_ml) {
  for (int e = threadIdx.x; e < G * hd; e += kThreads) {
    const int g = e / hd;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_all[w * G + g]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float mw = m_all[w * G + g];
        if (mw == -INFINITY) continue;
        const float c = expf(mw - M);
        L = fmaf(l_all[w * G + g], c, L);
        O = fmaf(acc_all[w * G * hd + e], c, O);
      }
    }
    if (part_o == nullptr) {
      out_row[e] = from_f32<T>(L > 0.f ? O / L : 0.f);
    } else {
      part_o[e] = O;
      if (e % hd == 0) {
        part_ml[2 * g] = M;
        part_ml[2 * g + 1] = L;
      }
    }
  }
}

// The partial state of a split with no slot below the row's length: the
// merge skips it on M = -inf and never reads its O.
__device__ __forceinline__ void store_empty_split(float* __restrict__ part_ml, int G) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    part_ml[2 * g] = -INFINITY;
    part_ml[2 * g + 1] = 0.f;
  }
}

// One (KV head, row) per block: merge the n_split partial states of its G
// query heads into out (B, H, hd).
template <typename T>
__global__ void __launch_bounds__(kThreads)
split_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   T* __restrict__ out, int H, int KVH, int hd, int n_split) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KVH;
  const size_t part0 = ((size_t)b * KVH + kvh) * n_split;
  T* out_row = out + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int e = threadIdx.x; e < G * hd; e += kThreads) {
    const int g = e / hd;
    float M = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, part_ml[((part0 + sp) * G + g) * 2]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY) {
      for (int sp = 0; sp < n_split; ++sp) {
        const float ms = part_ml[((part0 + sp) * G + g) * 2];
        if (ms == -INFINITY) continue;  // an empty split
        const float c = expf(ms - M);
        L = fmaf(part_ml[((part0 + sp) * G + g) * 2 + 1], c, L);
        O = fmaf(part_o[(part0 + sp) * G * hd + e], c, O);
      }
    }
    out_row[e] = from_f32<T>(L > 0.f ? O / L : 0.f);
  }
}

template <typename T>
cudaError_t launch_split_merge(const float* part_o, const float* part_ml, void* out, int B,
                               int H, int KVH, int hd, int n_split, cudaStream_t stream) {
  split_merge_kernel<T><<<dim3(KVH, B), kThreads, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), H, KVH, hd, n_split);
  return cudaGetLastError();
}

}  // namespace
