// Dense (contiguous-cache) GQA attention kernels for Hopper (sm_90a), bound
// to PyTorch through a plain C interface (ctypes). Built by
// repro_torch/kernels/_build.py. They back the engine's dense backend.
//
// flash_attention
//   Replaces the Pallas kernel repro/kernels/flash_attention.py::
//   flash_attention (body _flash_kernel). q (B, S, H, hd) attends k/v
//   (B, S, KVH, hd), causal or not, any S >= 1; scores, softmax and the
//   value product in f32, output in q's dtype. A sliding window (window >
//   0, hymba's SWA layers) also masks keys at or before row - window, the
//   mask of repro/models/attention.py::blockwise_attention(ATTN_SWA); the
//   Pallas kernel has no window.
//   Bound on the H100: operations. A 64-query tile does 4*hd flops per key
//   per query against ~hd*4 bytes of K/V per key: hundreds of flops per byte,
//   well above the ~20 flops per byte at which f32 CUDA-core work stops being
//   bandwidth-bound. The f32 contract (no bf16 rounding of P) keeps it off
//   the tensor cores, so the bound is the 67 TFLOP/s f32 rate.
//   Design: one 256-thread block per (64-query tile, head, batch row) keeps
//   its Q tile in shared memory as f32 and streams 64-key K/V tiles through
//   shared memory. Each thread holds a 4 x 4 score tile (rows ty + 16i, keys
//   tx + 16j) and a 4 x hd/16 slice of the output accumulator in registers;
//   the row max and sum are reduced over the 16 lanes of a half-warp with
//   shuffles, and the probabilities reach the value product by shuffles too,
//   so scores never touch shared memory. Causal blocks stop at the diagonal
//   tile (the Pallas grid's block skip), windowed blocks start at the first
//   tile that holds a key of the window, and the heaviest query tiles are
//   scheduled first. Rows and keys past S are masked, so S need not be a
//   multiple of the tile. Later work: tensor cores cannot keep the f32
//   contract; wider register tiles and cp.async/TMA staging can.
//
// decode_attention
//   Replaces the Pallas kernel repro/kernels/decode_attention.py::
//   decode_attention (body _decode_kernel). One query per row, q (B, H, hd),
//   over a contiguous cache (B, Sc, KVH, hd); slots below lengths[b] are
//   valid (lengths >= 1). Output in q's dtype.
//   Bound on the H100: bytes of K/V read (4 flops per K/V element pair per
//   query head, far below the ~295 flops per byte of the card).
//   Design: the cache axis is split across thread blocks, so that B * KVH *
//   n_split blocks fill the card (B * KVH is only 16 at B = 8, KVH = 2). One
//   block per (split, KV head, row) reads each K/V slot of its slice once and
//   shares it across the G = H / KVH query heads of the group; its eight warps
//   walk 16-slot tiles in parallel with a per-warp f32 online softmax, merged
//   at the end into the block's (max, sum, accumulator). Slots at or past the
//   row's length are never loaded. A second kernel merges the splits of each
//   (row, KV head).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements as float: one 16-byte load (f32) or one 8-byte
// load (bf16); the address must be aligned to that size.
template <typename T> struct Load4;
template <> struct Load4<float> {
  __device__ __forceinline__ static float4 run(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <> struct Load4<__nv_bfloat16> {
  __device__ __forceinline__ static float4 run(const __nv_bfloat16* p) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    // little-endian: element 2k in the low half of word k
    return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  }
};

// ---------------------------------------------------------------------------
// flash attention
// ---------------------------------------------------------------------------

constexpr int kTile = 64;         // queries per block and keys per K/V tile
constexpr int kFThreads = 256;    // 16 x 16 threads: ty = tid / 16, tx = tid % 16

// Shared-memory plan (floats): Q tile (kTile x (HD+4)) | K tile (kTile x
// (HD+4)) | V tile (kTile x HD). The +4 pad keeps rows 16-byte aligned and
// spreads the K rows a half-warp reads over all 32 banks.
__host__ __device__ constexpr int flash_smem_floats(int hd) {
  return 2 * kTile * (hd + 4) + kTile * hd;
}

// rows [row0, row0 + kTile) of a (.., S, heads, HD) tensor at head `head`
// into a padded f32 tile; rows at or past S are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* __restrict__ src,
                                          int row0, int S, int heads, int head) {
  constexpr int kQuads = HD / 4;
  for (int e = threadIdx.x; e < kTile * kQuads; e += kFThreads) {
    const int r = e / kQuads, d = (e % kQuads) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = Load4<T>::run(src + ((size_t)(row0 + r) * heads + head) * HD + d);
    *reinterpret_cast<float4*>(dst + r * dst_stride + d) = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int S, int H, int KVH, int causal, int window,
             float scale) {
  constexpr int QS = HD + 4;      // padded row stride of the Q and K tiles
  constexpr int NG = HD / 64;     // 4-column groups of the output a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * QS;
  float* Vs = Ks + kTile * QS;

  const int nq = gridDim.x;
  const int qt = causal ? nq - 1 - blockIdx.x : blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid % 32;
  const int q0 = qt * kTile;
  const T* qb = q + (size_t)b * S * H * HD;
  const T* kb = k + (size_t)b * S * KVH * HD;
  const T* vb = v + (size_t)b * S * KVH * HD;

  load_tile<T, HD>(Qs, QS, qb, q0, S, H, h);

  float m[4], l[4], o[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[i][c] = 0.f;
  }

  const int n_kv = (S + kTile - 1) / kTile;
  // causal: K/V tiles past the diagonal lie wholly in the future; window:
  // tiles before the first row's first key (q0 - window + 1) lie wholly
  // before every row's window
  const int kt_end = causal ? min(qt + 1, n_kv) : n_kv;
  const int kt_begin = window > 0 ? max(q0 - window + 1, 0) / kTile : 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K/V are no longer read (and Q is in)
    load_tile<T, HD>(Ks, QS, kb, k0, S, KVH, kvh);
    load_tile<T, HD>(Vs, HD, vb, k0, S, KVH, kvh);
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online softmax of each row over this tile's keys; the
    // 16 lanes of a half-warp hold one row's 64 keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok =
            col < S && (!causal || col <= row) && (window <= 0 || col > row - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float m_new = fmaxf(m[i], mx);
      // m_new is -inf only while no key of the row was valid yet
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w /= 2) sum += __shfl_xor_sync(kFull, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) o[i][c] *= alpha;
    }

    // o += P V: key kk's probability of row i sits in lane kk % 16 of this
    // half-warp, in s[i][kk / 16]; the thread owns columns 64g + 4tx .. +3
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const int src = (lane & 16) | (kk & 15);
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = __shfl_sync(kFull, s[i][kk / 16], src);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * HD + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * g] = fmaf(p[i], vv.x, o[i][4 * g]);
          o[i][4 * g + 1] = fmaf(p[i], vv.y, o[i][4 * g + 1]);
          o[i][4 * g + 2] = fmaf(p[i], vv.z, o[i][4 * g + 2]);
          o[i][4 * g + 3] = fmaf(p[i], vv.w, o[i][4 * g + 3]);
        }
      }
    }
  }

  T* ob = out + (size_t)b * S * H * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = ob + ((size_t)row * H + h) * HD;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[64 * g + 4 * tx + c] = from_f32<T>(o[i][4 * g + c] * inv);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch_flash_hd(const void* q, const void* k, const void* v, void* out, int B,
                            int S, int H, int KVH, int causal, int window, float scale,
                            cudaStream_t stream) {
  const size_t smem = flash_smem_floats(HD) * sizeof(float);
  auto kernel = flash_kernel<T, HD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nq = (S + kTile - 1) / kTile;
  kernel<<<dim3(nq, H, B), kFThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KVH, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out, int B, int S,
                         int H, int KVH, int hd, int causal, int window, float scale,
                         cudaStream_t stream) {
  if (hd == 64)
    return launch_flash_hd<T, 64>(q, k, v, out, B, S, H, KVH, causal, window, scale, stream);
  if (hd == 128)
    return launch_flash_hd<T, 128>(q, k, v, out, B, S, H, KVH, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// decode attention (split over the cache axis)
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kDThreads = 32 * kWarps;
constexpr int kSlots = 16;  // slots of a warp's tile

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
      for (int j = 0; j < 4; ++j) {
        out[8 * c + 2 * j] = __uint_as_float(w[j] << 16);
        out[8 * c + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
};

// Shared-memory plan (floats): q (G*hd) | per-warp accumulators
// (kWarps*G*hd) | per-warp running max (kWarps*G) | per-warp sum (kWarps*G).
__host__ __device__ inline size_t decode_smem_floats(int G, int hd) {
  return (size_t)G * hd * (1 + kWarps) + (size_t)2 * kWarps * G;
}

// One (split, KV head, row): slots [lo, hi) of the row, hi <= lengths[b].
// Warp w takes the slice's 16-slot tiles w, w + kWarps, ...; within a warp,
// lane (i, half) = (lane % 16, lane / 16) scores slot i of the tile over half
// of head_dim, and owns output columns lane*HD/32 .. +HD/32. Writes the
// block's merged state: max and sum per query head (part_ml) and the
// accumulator relative to that max (part_o).
template <typename T, int HD>
__global__ void __launch_bounds__(kDThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int* __restrict__ lengths,
                    float* __restrict__ part_o, float* __restrict__ part_ml, int H, int KVH,
                    int Sc, int chunk, float scale) {
  constexpr int KH = HD / 2;    // K columns a lane scores
  constexpr int DPL = HD / 32;  // output columns a lane owns
  extern __shared__ __align__(16) float smem[];
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, n_split = gridDim.x;
  const int G = H / KVH;
  float* qs = smem;
  float* acc_all = qs + G * HD;
  float* m_all = acc_all + kWarps * G * HD;
  float* l_all = m_all + kWarps * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i = lane % kSlots, half = lane / kSlots;
  float* acc = acc_all + warp * G * HD;
  float* m = m_all + warp * G;
  float* l = l_all + warp * G;

  const T* q_row = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int e = tid; e < G * HD; e += kDThreads) qs[e] = to_f32(q_row[e]);
  for (int e = tid; e < kWarps * G * HD; e += kDThreads) acc_all[e] = 0.f;
  for (int e = tid; e < kWarps * G; e += kDThreads) {
    m_all[e] = -INFINITY;
    l_all[e] = 0.f;
  }
  __syncthreads();

  const int len = min(lengths[b], Sc);
  const int lo = sp * chunk;
  const int hi = min(lo + chunk, len);
  const size_t row_stride = (size_t)KVH * HD;  // elements between slots
  const T* kb = k_cache + ((size_t)b * Sc * KVH + kvh) * HD;
  const T* vb = v_cache + ((size_t)b * Sc * KVH + kvh) * HD;
  for (int s0 = lo + warp * kSlots; s0 < hi; s0 += kWarps * kSlots) {
    const int slot = s0 + i;
    const bool valid = slot < hi;  // slots at or past hi are never loaded
    float kr[KH];
    if (valid) {
      Load16<T, KH>::run(kb + slot * row_stride + half * KH, kr);
    } else {
#pragma unroll
      for (int d = 0; d < KH; ++d) kr[d] = 0.f;
    }
    float vr[kSlots][DPL];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const bool in = s0 + s < hi;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        vr[s][c] = in ? to_f32(vb[(s0 + s) * row_stride + lane * DPL + c]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      const float* qg = qs + g * HD + half * KH;
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
      dot += __shfl_xor_sync(kFull, dot, kSlots);  // the other half of head_dim
      const float sc = valid ? dot * scale : -INFINITY;
      const float m_old = m[g];
      float mx = fmaxf(sc, m_old);
#pragma unroll
      for (int w = kSlots / 2; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      // the tile's first slot is valid, so mx is finite (uniform across the warp)
      const float p = sc == -INFINITY ? 0.f : expf(sc - mx);
      float sum = p;
#pragma unroll
      for (int w = kSlots / 2; w > 0; w /= 2) sum += __shfl_xor_sync(kFull, sum, w);
      const float alpha = expf(m_old - mx);  // 0 on the warp's first tile
      float o[DPL];
      float* ag = acc + g * HD + lane * DPL;
#pragma unroll
      for (int c = 0; c < DPL; ++c) o[c] = ag[c] * alpha;
#pragma unroll
      for (int s2 = 0; s2 < kSlots; ++s2) {
        const float ps = __shfl_sync(kFull, p, s2);
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
  // merge the warps' states into the block's: M = max_w m_w,
  // L = sum_w l_w e^(m_w - M), O = sum_w acc_w e^(m_w - M)
  const size_t part = ((size_t)b * KVH + kvh) * n_split + sp;
  for (int e = tid; e < G * HD; e += kDThreads) {
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
    part_o[part * G * HD + e] = O;
    if (e % HD == 0) {
      part_ml[(part * G + g) * 2] = M;
      part_ml[(part * G + g) * 2 + 1] = L;
    }
  }
}

// One (KV head, row): merge the n_split partial states of its G query heads.
template <typename T>
__global__ void __launch_bounds__(kDThreads)
decode_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                    T* __restrict__ out, int H, int KVH, int hd, int n_split) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KVH;
  const size_t part0 = ((size_t)b * KVH + kvh) * n_split;
  T* out_row = out + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int e = threadIdx.x; e < G * hd; e += kDThreads) {
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

template <typename T, int HD>
cudaError_t launch_decode_hd(const void* q, const void* k, const void* v, const int* lengths,
                             void* out, float* part_o, float* part_ml, int B, int H, int KVH,
                             int Sc, int n_split, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_floats(H / KVH, HD) * sizeof(float);
  auto kernel = decode_split_kernel<T, HD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  // slots per split: whole 16-slot tiles, n_split splits covering Sc
  const int tiles = (Sc + kSlots - 1) / kSlots;
  const int chunk = (tiles + n_split - 1) / n_split * kSlots;
  kernel<<<dim3(n_split, KVH, B), kDThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_o, part_ml, H, KVH, Sc, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(KVH, B), kDThreads, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), H, KVH, HD, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* lengths,
                          void* out, float* part_o, float* part_ml, int B, int H, int KVH,
                          int hd, int Sc, int n_split, float scale, cudaStream_t stream) {
  if (hd == 64)
    return launch_decode_hd<T, 64>(q, k, v, lengths, out, part_o, part_ml, B, H, KVH, Sc,
                                   n_split, scale, stream);
  if (hd == 128)
    return launch_decode_hd<T, 128>(q, k, v, lengths, out, part_o, part_ml, B, H, KVH, Sc,
                                    n_split, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, K and V share one dtype: f32 or bf16.
#define DA_DISPATCH(FN, ...)                                                    \
  switch (dtype) {                                                              \
    case kF32: return static_cast<int>(FN<float>(__VA_ARGS__));                 \
    case kBF16: return static_cast<int>(FN<__nv_bfloat16>(__VA_ARGS__));        \
    default: return static_cast<int>(cudaErrorInvalidValue);                    \
  }

extern "C" {

// Bytes of dynamic shared memory one thread block takes.
int da_flash_smem_bytes(int hd) { return flash_smem_floats(hd) * static_cast<int>(sizeof(float)); }

int da_decode_smem_bytes(int G, int hd) {
  return static_cast<int>(decode_smem_floats(G, hd) * sizeof(float));
}

// Each launcher returns the cudaError_t of its launches (0 on success).
// window <= 0: no sliding window.
int da_flash_attention(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                       int S, int H, int KVH, int hd, int causal, int window, float scale,
                       void* stream) {
  DA_DISPATCH(launch_flash, q, k, v, out, B, S, H, KVH, hd, causal, window, scale,
              static_cast<cudaStream_t>(stream))
}

// part_o: (B, KVH, n_split, G, hd) and part_ml: (B, KVH, n_split, G, 2)
// float32 scratch the caller allocates.
int da_decode_attention(int dtype, const void* q, const void* k_cache, const void* v_cache,
                        const int* lengths, void* out, float* part_o, float* part_ml, int B,
                        int H, int KVH, int hd, int Sc, int n_split, float scale,
                        void* stream) {
  DA_DISPATCH(launch_decode, q, k_cache, v_cache, lengths, out, part_o, part_ml, B, H, KVH, hd,
              Sc, n_split, scale, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
