// What the attention sources (dense_attention.cu, paged_attention.cu) share:
// element conversions and 16-byte loads, the launch preparation for large
// dynamic shared memory, the tensor-core fragment path (cp.async staging,
// ldmatrix, mma.sync m16n8k16 bf16 -> f32, the two-part bf16 split of P, the
// SFU's exp2), and the split-cache decode's pieces: the merge of a block's
// per-warp online-softmax states into the block's, and the kernel that merges
// the blocks' partial states of one (KV head, row or packed token).
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

// ---------------------------------------------------------------------------
// the tensor-core fragment path (bf16 in, f32 accumulators)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and lane l receives row l / 4, columns 2 (l % 4) .. +1 of each
// (of the transpose with .trans). volatile keeps them between the barriers;
// no memory clobber, so the compiler may schedule a step's loads ahead of its
// mma.sync
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// two consecutive bf16 values (4-byte aligned) as one A-fragment register
__device__ __forceinline__ unsigned ld_bf16x2(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo keeps
// about 16 significant bits of each
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// 2^x by the SFU's ex2.approx (about 2 ulp; results below 2^-126 flush to
// 0, a probability the f32 output cannot see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ln 2: a running max kept in log2 units (scores scaled by log2(e)) times
// this is the max in natural units that split_merge_kernel reads
constexpr float kLn2 = 0.6931471805599453f;

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

// The merge of the split-cache partials: one block per (KV head, row or
// packed token, slice of kMergeThreads of the G * hd outputs), one output
// element a thread. The block first turns the splits' (M, L) into weights
// w[s][g] = e^(M_s - M) / L in shared memory (0 for an empty split, whose O
// is never read), then each thread sums w[s][g] O_s over the splits with
// independent loads in flight, so the time does not grow with a chain of
// dependent loads per split. out is (rows, H, hd).
constexpr int kMergeThreads = 256;

__host__ __device__ inline size_t merge_smem_bytes(int G, int n_split) {
  return (size_t)(2 * n_split * G + 2 * G) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
split_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   T* __restrict__ out, int H, int KVH, int hd, int n_split) {
  extern __shared__ __align__(16) float merge_smem[];
  const int kvh = blockIdx.x, row = blockIdx.y, G = H / KVH, tid = threadIdx.x;
  float* w = merge_smem;              // m_s, then the weight, per (split, head)
  float* l = w + n_split * G;         // L_s per (split, head)
  float* head_m = l + n_split * G;    // M per head
  float* head_inv = head_m + G;       // 1 / L per head (0 where no slot was valid)
  const size_t part0 = ((size_t)row * KVH + kvh) * n_split;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + part0 * G;
  for (int p = tid; p < n_split * G; p += kMergeThreads) {
    const float2 x = ml[p];
    w[p] = x.x;
    l[p] = x.y;
  }
  __syncthreads();
  for (int g = tid; g < G; g += kMergeThreads) {
    float M = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, w[sp * G + g]);
    float L = 0.f;
    if (M != -INFINITY)
      for (int sp = 0; sp < n_split; ++sp) {
        const float ms = w[sp * G + g];
        if (ms != -INFINITY) L = fmaf(l[sp * G + g], expf(ms - M), L);
      }
    head_m[g] = M;
    head_inv[g] = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  for (int p = tid; p < n_split * G; p += kMergeThreads) {
    const int g = p % G;
    const float ms = w[p];
    w[p] = ms == -INFINITY ? 0.f : expf(ms - head_m[g]) * head_inv[g];
  }
  __syncthreads();
  const int e = blockIdx.z * kMergeThreads + tid;
  if (e >= G * hd) return;
  const int g = e / hd;
  const float* po = part_o + part0 * G * hd + e;
  float acc = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < n_split; ++sp) {
    const float ws = w[sp * G + g];
    if (ws != 0.f) acc = fmaf(ws, po[(size_t)sp * G * hd], acc);  // an empty split's O is unread
  }
  out[((size_t)row * H + (size_t)kvh * G) * hd + e] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch_split_merge(const float* part_o, const float* part_ml, void* out, int rows,
                               int H, int KVH, int hd, int n_split, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = merge_smem_bytes(G, n_split);
  auto kernel = split_merge_kernel<T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int slices = (G * hd + kMergeThreads - 1) / kMergeThreads;
  kernel<<<dim3(KVH, rows, slices), kMergeThreads, smem, stream>>>(
      part_o, part_ml, static_cast<T*>(out), H, KVH, hd, n_split);
  return cudaGetLastError();
}

}  // namespace
