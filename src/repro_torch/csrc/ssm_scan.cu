// Selective scan (the Mamba heads of Hymba's hybrid layers) for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes). Built by
// repro_torch/kernels/_build.py. It backs every SSM recurrence of the dense
// backend's hybrid stacks: the whole-prompt prefill and each decode step.
//
// ssm_scan
//   Replaces the Pallas kernel repro/kernels/ssm_scan.py::ssm_scan (body
//   _ssm_kernel). Per batch row b, channel d and state index n, with h
//   carried from h0 (zero when absent) and A = -exp(a_log) in f32:
//     h_t[d,n] = exp(dt_t[d] * A[d,n]) * h_{t-1}[d,n] + (dt_t[d] * x_t[d]) * B_t[n]
//     y_t[d]   = sum_n C_t[n] * h_t[d,n]
//   dt, x (B, S, Di) and B, C (B, S, N) in f32 or bf16 (one dtype, widened
//   to f32 exactly: dt * x is taken in f32, as the Pallas kernel does);
//   a_log (Di, N) f32; y (B, S, Di) and the final h (B, Di, N) f32. N is 16
//   or 8; any S >= 1.
//   The contract is the sequential recurrence of repro/kernels/ref.py::
//   ssm_scan_ref continued from h0. The Pallas kernel zeroes its state at
//   its first chunk (it ignores h0), so it serves prefill only; this kernel
//   honours h0, so the decode step runs it too.
//   Bound on the H100: the S * Di * N exponentials at the SFU rate (16 a
//   clock per SM), level with the ~6 f32 operations per state element per
//   step at 67 TFLOP/s; bytes are smaller (dt, x, B, C read once, y written
//   once, h read and written once).
//
//   Design. One sequential loop per channel left about 6 warps an SM at
//   B = 1, Di = 1600, and each step's load, exponential and FMA waited on
//   one another. The time axis is now cut into n_seg segments of seg_len
//   steps (the wrapper's ssm_segments: as many as one wave of the output
//   pass holds, 21 of 80 steps at B 1, Di 1600, S 1664 on the H100), and a
//   thread of the two prefill passes holds 4 states of 2 channels of one
//   (row, segment): the N / 4 threads of a channel pair are neighbouring
//   lanes, a 128-thread block holds 1024 / N channels, and one 16-byte
//   load of B (of C) feeds 8 states, one of (dt, dt x) both channels. Two
//   launches:
//   1. the segment pass (ssm_pass_kernel<.., false>), segments 0 .. n_seg
//      - 2: each segment's end state from a zero state (segment 0: from
//      h0, whose copy it keeps in the scratch), and its sum of dt per
//      channel; no C and no y.
//   2. the output pass (ssm_pass_kernel<.., true>), every segment: the
//      carry first, h_start[j] = exp(A * sum dt of segment j - 1) *
//      h_start[j-1] + h_loc[j-1] from segment 0's end state (the loads of 8
//      earlier segments in flight at once), then the recurrence over the
//      segment with y, as the one-loop kernel ran it.
//   The exponential's argument underflows to 0 for a strong decay, the
//   right value; nothing divides. Both passes take one exponential per
//   element and step, so the SFU floor doubles (less segment n_seg - 1's
//   share) in exchange for n_seg times the warps. Time runs in chunks of 16
//   steps: (dt, dt * x) of the block's channels and B (and C) of the row
//   staged in shared memory as f32, the next chunk's loads in flight in
//   registers, steps past the segment staged as zeros (dt = 0 leaves h as
//   it is). Steps go in batches of 4: first the batch's loads, exponentials
//   and (dt x) * B, then the FMAs of h, so only h crosses steps. Each step
//   leaves a thread's C . h of each channel in shared memory, and a pass
//   after the chunk adds a channel's N / 4 partials into y.
//   Decode (n_seg = 1, S <= 16): ssm_direct_kernel, one thread per (row,
//   channel, 4 states), reads each step's inputs straight from global
//   memory and sums y over a channel's lanes with shuffles: no shared
//   memory, no barrier.
//   Only the segment pass reads h0 (or, with one segment, the thread that
//   also writes the element), and only the last segment writes h_out, so
//   h_out may be h0 itself: the decode step updates the cache's state slice
//   in place.
#include "scan_common.cuh"

namespace {

using scan::ld4;
using scan::st4;
using scan::to_f32;
using scan::Vec4;
using scan::zero_of;

constexpr int kThreads = 128;   // 4 warps
constexpr int kSV = 4;          // states a thread holds of a channel
constexpr int kCPT = 2;         // channels a thread holds in the prefill passes
constexpr int kT = 16;          // time steps per staged chunk
constexpr int kBatch = 4;       // steps whose loads and exponentials run ahead of h
constexpr int kCarryBatch = 8;  // earlier segments whose carry loads are in flight at once
constexpr int kDirectMax = 16;  // one segment of at most this many steps: the direct kernel
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1 };

// exp(dt * A) = exp2(dt * A * log2(e)): one SFU instruction (ex2.approx.ftz:
// a result below 2^-126 becomes 0, which changes h by less than 1e-37)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The prefill passes' threads: thread tid holds states ng * 4 .. + 3 (ng =
// tid % NG) of the two channels d0 + 2 cp, d0 + 2 cp + 1 (cp = tid / NG), so
// one 16-byte load of B (and of C) feeds 8 states and one of (dt, dt x)
// both channels.
template <int N>
struct Lanes {
  static constexpr int NG = N / kSV;               // threads of a channel pair
  static constexpr int CP = kThreads / NG;         // channel pairs of a block
  static constexpr int CH = CP * kCPT;             // channels of a block
  static constexpr int PD = kT * CH / kThreads;    // dt and x elements a thread stages per chunk
  static constexpr int PB = kT * N / kThreads;     // B and C elements a thread stages per chunk
  static constexpr int PY = kT * CP / kThreads;    // (step, channel pair) sums of y a thread makes
  static_assert(N % kSV == 0 && PD >= 1 && PB >= 1 && PY >= 1 && kT % kBatch == 0,
                "chunk shape");
};

// A thread's A * log2(e) for its 4 states of channel d (zeros off Di).
template <int N>
__device__ __forceinline__ void decay_rates(float (&a2)[kSV], const float* a_log, int d, int n0,
                                            bool live) {
  const float4 al = live ? ld4(a_log + static_cast<size_t>(d) * N + n0) : make_float4(0, 0, 0, 0);
  a2[0] = live ? -expf(al.x) * kLog2e : 0.f;
  a2[1] = live ? -expf(al.y) * kLog2e : 0.f;
  a2[2] = live ? -expf(al.z) * kLog2e : 0.f;
  a2[3] = live ? -expf(al.w) * kLog2e : 0.f;
}

__device__ __forceinline__ void load4(float (&h)[kSV], const float* p) {
  const float4 x = ld4(p);
  h[0] = x.x; h[1] = x.y; h[2] = x.z; h[3] = x.w;
}
__device__ __forceinline__ void store4(float* p, const float (&h)[kSV]) {
  st4(p, make_float4(h[0], h[1], h[2], h[3]));
}

// Block (channel block, j, b) runs segment j of row b for its channels.
// kOut false (the segment pass, j < n_seg - 1): from a zero state, or for
// j = 0 from init (h0, (B, Di, N) at init_stride per row, copied to slot 0),
// the end state into seg_h slot j + 1 and the sum of dt into seg_dsum[(b,
// j, d)]. kOut true (the output pass): from init (j = 0; zero when null) or
// the carry (j >= 1), y, and for the last segment the final h into h_out.
// seg_h is (B, n_seg, Di, N), seg_dsum (B, n_seg, Di).
template <typename T, int N, bool kOut>
__global__ void __launch_bounds__(kThreads)
ssm_pass_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ a_log, const float* init,
                size_t init_stride, float* seg_h, float* seg_dsum, float* __restrict__ y,
                float* h_out, int S, int Di, int n_seg, int seg_len) {
  using Ln = Lanes<N>;
  constexpr int NG = Ln::NG, CP = Ln::CP, CH = Ln::CH, PD = Ln::PD, PB = Ln::PB;
  // (t, channel pair): (dt, dt x) of both channels
  __shared__ __align__(16) float s_d[kT * CP * 4];
  __shared__ __align__(16) float s_b[kT * N];                        // (t, n)
  __shared__ __align__(16) float s_c[kOut ? kT * N : 1];             // (t, n)
  __shared__ __align__(16) float s_p[kOut ? kT * kThreads * 2 : 1];  // (t, thread): C . h of each channel

  const int j = blockIdx.y, b = blockIdx.z, d0 = blockIdx.x * CH;
  const int tid = threadIdx.x, ng = tid % NG, cp = tid / NG, n0 = ng * kSV;
  const int d[kCPT] = {d0 + 2 * cp, d0 + 2 * cp + 1};
  const bool live[kCPT] = {d[0] < Di, d[1] < Di};
  const int s0 = j * seg_len, s1 = min(S, s0 + seg_len);
  const size_t row0 = static_cast<size_t>(b) * S;  // first time step of row b
  const size_t plane = static_cast<size_t>(Di) * N;
  float* slots = seg_h + static_cast<size_t>(b) * n_seg * plane;

  float a2[kCPT][kSV], h[kCPT][kSV];
#pragma unroll
  for (int e = 0; e < kCPT; ++e) {
    decay_rates<N>(a2[e], a_log, d[e], n0, live[e]);
#pragma unroll
    for (int q = 0; q < kSV; ++q) h[e][q] = 0.f;
  }
  if (j == 0) {
    if (init != nullptr) {
#pragma unroll
      for (int e = 0; e < kCPT; ++e)
        if (live[e]) {
          const size_t el = static_cast<size_t>(d[e]) * N + n0;
          load4(h[e], init + b * init_stride + el);
          if constexpr (!kOut) store4(slots + el, h[e]);  // slot 0: the start of segment 0
        }
    }
  } else if constexpr (kOut) {
    // the carry: segment 0's end state, then segments 1 .. j - 1, their
    // loads kCarryBatch segments at a time
#pragma unroll
    for (int e = 0; e < kCPT; ++e)
      if (live[e]) load4(h[e], slots + plane + static_cast<size_t>(d[e]) * N + n0);
    for (int i0 = 1; i0 < j; i0 += kCarryBatch) {
      float ds[kCarryBatch][kCPT], hl[kCarryBatch][kCPT][kSV];
#pragma unroll
      for (int m = 0; m < kCarryBatch; ++m)
#pragma unroll
        for (int e = 0; e < kCPT; ++e) {
          ds[m][e] = 0.f;
#pragma unroll
          for (int q = 0; q < kSV; ++q) hl[m][e][q] = 0.f;
          if (i0 + m < j && live[e]) {
            ds[m][e] = seg_dsum[(static_cast<size_t>(b) * n_seg + i0 + m) * Di + d[e]];
            load4(hl[m][e], slots + static_cast<size_t>(i0 + m + 1) * plane +
                                static_cast<size_t>(d[e]) * N + n0);
          }
        }
#pragma unroll
      for (int m = 0; m < kCarryBatch; ++m)
        if (i0 + m < j) {
#pragma unroll
          for (int e = 0; e < kCPT; ++e)
#pragma unroll
            for (int q = 0; q < kSV; ++q)
              h[e][q] = fmaf(ex2(a2[e][q] * ds[m][e]), h[e][q], hl[m][e][q]);
        }
    }
  }

  T r_dt[PD], r_x[PD], r_b[PB], r_c[kOut ? PB : 1];
  // steps t0 .. t0 + tc - 1 into registers, zeros past them and past Di
  auto fetch = [&](int t0, int tc) {
#pragma unroll
    for (int i = 0; i < PD; ++i) {
      const int e = tid + i * kThreads, t = e / CH, c = e % CH;
      r_dt[i] = r_x[i] = zero_of<T>();
      if (t < tc && d0 + c < Di) {
        const size_t off = (row0 + t0 + t) * Di + d0 + c;
        r_dt[i] = dt[off];
        r_x[i] = x[off];
      }
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int e = tid + i * kThreads, t = e / N;
      r_b[i] = zero_of<T>();
      if constexpr (kOut) r_c[i] = zero_of<T>();
      if (t < tc) {
        const size_t off = (row0 + t0 + t) * N + e % N;
        r_b[i] = bm[off];
        if constexpr (kOut) r_c[i] = cm[off];
      }
    }
  };

  float dsum[kCPT] = {0.f, 0.f};  // sum of dt over the segment (the segment pass's decay)
  fetch(s0, min(kT, s1 - s0));
  for (int t0 = s0; t0 < s1; t0 += kT) {
    const int tc = min(kT, s1 - t0);
    __syncthreads();  // the previous chunk's staging and partials are no longer read
#pragma unroll
    for (int i = 0; i < PD; ++i) {
      const int e = tid + i * kThreads, t = e / CH, c = e % CH;
      const float dtv = to_f32(r_dt[i]);
      *reinterpret_cast<float2*>(s_d + (t * CP + c / 2) * 4 + (c % 2) * 2) =
          make_float2(dtv, dtv * to_f32(r_x[i]));
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      s_b[tid + i * kThreads] = to_f32(r_b[i]);
      if constexpr (kOut) s_c[tid + i * kThreads] = to_f32(r_c[i]);
    }
    __syncthreads();
    if (t0 + kT < s1) fetch(t0 + kT, min(kT, s1 - t0 - kT));  // in flight during the steps

    for (int r0 = 0; r0 < tc; r0 += kBatch) {  // steps past tc: zeros, h unchanged
      float da[kBatch][kCPT][kSV], u[kBatch][kCPT][kSV], c[kBatch][kSV];
#pragma unroll
      for (int st = 0; st < kBatch; ++st) {
        const float4 d4 = ld4(s_d + ((r0 + st) * CP + cp) * 4);
        const float4 b4 = ld4(s_b + (r0 + st) * N + n0);
        const float dtv[kCPT] = {d4.x, d4.z}, dxv[kCPT] = {d4.y, d4.w};
        const float bv[kSV] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int e = 0; e < kCPT; ++e)
#pragma unroll
          for (int q = 0; q < kSV; ++q) {
            da[st][e][q] = ex2(dtv[e] * a2[e][q]);
            u[st][e][q] = dxv[e] * bv[q];
          }
        if constexpr (kOut) {
          const float4 c4 = ld4(s_c + (r0 + st) * N + n0);
          c[st][0] = c4.x; c[st][1] = c4.y; c[st][2] = c4.z; c[st][3] = c4.w;
        } else {
          dsum[0] += d4.x;
          dsum[1] += d4.z;
        }
      }
#pragma unroll
      for (int st = 0; st < kBatch; ++st) {
#pragma unroll
        for (int e = 0; e < kCPT; ++e)
#pragma unroll
          for (int q = 0; q < kSV; ++q) h[e][q] = fmaf(da[st][e][q], h[e][q], u[st][e][q]);
        if constexpr (kOut) {
          float p[kCPT];
#pragma unroll
          for (int e = 0; e < kCPT; ++e) {
            p[e] = c[st][0] * h[e][0];
#pragma unroll
            for (int q = 1; q < kSV; ++q) p[e] = fmaf(c[st][q], h[e][q], p[e]);
          }
          *reinterpret_cast<float2*>(s_p + ((r0 + st) * kThreads + tid) * 2) =
              make_float2(p[0], p[1]);
        }
      }
    }
    if constexpr (kOut) {
      __syncthreads();
      // y of the chunk: (step t, channel pair cc) sums the partials of its NG lanes
#pragma unroll
      for (int i = 0; i < Ln::PY; ++i) {
        const int e = tid + i * kThreads, t = e / CP, cc = e % CP;
        const float* part = s_p + (t * kThreads + cc * NG) * 2;  // (lane, channel) pairs
        float ya = 0.f, yb = 0.f;
#pragma unroll
        for (int g = 0; g < NG; g += 2) {
          const float4 v = ld4(part + 2 * g);
          ya += v.x + v.z;
          yb += v.y + v.w;
        }
        const size_t yo = (row0 + t0 + t) * Di + d0 + 2 * cc;
        if (t < tc && d0 + 2 * cc < Di) y[yo] = ya;
        if (t < tc && d0 + 2 * cc + 1 < Di) y[yo + 1] = yb;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kCPT; ++e) {
    if (!live[e]) continue;
    const size_t el = static_cast<size_t>(d[e]) * N + n0;
    if constexpr (!kOut) {
      store4(slots + static_cast<size_t>(j + 1) * plane + el, h[e]);
      if (ng == 0) seg_dsum[(static_cast<size_t>(b) * n_seg + j) * Di + d[e]] = dsum[e];
    } else if (j == n_seg - 1) {
      store4(h_out + static_cast<size_t>(b) * plane + el, h[e]);
    }
  }
}

// Thread (b, d, 4 states) runs steps 0 .. S - 1 with its inputs read
// straight from global memory; a channel's NG lanes sum y by shuffles.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_direct_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ a_log, const float* h0,
                  float* __restrict__ y, float* h_out, int B, int S, int Di) {
  constexpr int NG = N / kSV;
  using V = Vec4<T>;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int ng = static_cast<int>(g % NG), n0 = ng * kSV;
  const long long cd = g / NG;
  const int d = static_cast<int>(cd % Di), b = static_cast<int>(cd / Di);
  const bool live = b < B;  // the lanes past the end still join the shuffles
  const size_t hi = (static_cast<size_t>(b) * Di + d) * N + n0;

  float a2[kSV];
  decay_rates<N>(a2, a_log, d, n0, live);
  float h[kSV] = {0.f, 0.f, 0.f, 0.f};
  if (live && h0 != nullptr) load4(h, h0 + hi);
  for (int t = 0; t < S; ++t) {
    const size_t rt = static_cast<size_t>(b) * S + t;
    float p = 0.f;
    if (live) {
      const float dtv = to_f32(dt[rt * Di + d]);
      const float dx = dtv * to_f32(x[rt * Di + d]);
      const float4 b4 = V::widen(V::load(bm + rt * N + n0));
      const float4 c4 = V::widen(V::load(cm + rt * N + n0));
      const float bv[kSV] = {b4.x, b4.y, b4.z, b4.w}, cv[kSV] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int q = 0; q < kSV; ++q) h[q] = fmaf(ex2(dtv * a2[q]), h[q], dx * bv[q]);
      p = cv[0] * h[0];
#pragma unroll
      for (int q = 1; q < kSV; ++q) p = fmaf(cv[q], h[q], p);
    }
#pragma unroll
    for (int m = 1; m < NG; m <<= 1) p += __shfl_xor_sync(0xffffffffu, p, m);
    if (live && ng == 0) y[rt * Di + d] = p;
  }
  if (live) store4(h_out + hi, h);
}

template <typename T, int N>
cudaError_t launch_ssm_n(const void* dt_, const void* x_, const void* bm_, const void* cm_,
                         const float* a_log, const float* h0, float* y, float* h_out,
                         float* seg_h, float* seg_dsum, int B, int S, int Di, int n_seg,
                         int seg_len, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(dt_);
  const T* x = static_cast<const T*>(x_);
  const T* bm = static_cast<const T*>(bm_);
  const T* cm = static_cast<const T*>(cm_);
  if (n_seg == 1 && S <= kDirectMax) {
    const long long blocks = (static_cast<long long>(B) * Di * (N / kSV) + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    ssm_direct_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        dt, x, bm, cm, a_log, h0, y, h_out, B, S, Di);
    return cudaGetLastError();
  }
  const dim3 grid((Di + Lanes<N>::CH - 1) / Lanes<N>::CH, n_seg, B);
  const float* init = h0;
  size_t init_stride = static_cast<size_t>(Di) * N;
  if (n_seg > 1) {
    if (seg_h == nullptr || seg_dsum == nullptr) return cudaErrorInvalidValue;
    ssm_pass_kernel<T, N, false><<<dim3(grid.x, n_seg - 1, B), kThreads, 0, stream>>>(
        dt, x, bm, cm, a_log, h0, init_stride, seg_h, seg_dsum, nullptr, nullptr, S, Di, n_seg,
        seg_len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    init = h0 != nullptr ? seg_h : nullptr;  // slot 0: the copy of h0
    init_stride *= n_seg;
  }
  ssm_pass_kernel<T, N, true><<<grid, kThreads, 0, stream>>>(
      dt, x, bm, cm, a_log, init, init_stride, seg_h, seg_dsum, y, h_out, S, Di, n_seg, seg_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ssm(const void* dt, const void* x, const void* bm, const void* cm,
                       const float* a_log, const float* h0, float* y, float* h_out, float* seg_h,
                       float* seg_dsum, int B, int S, int Di, int N, int n_seg, int seg_len,
                       cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0) return cudaErrorInvalidValue;
  // the segments cover S exactly once, none empty
  if (n_seg < 1 || n_seg > 65535 || seg_len < 1 ||
      static_cast<long long>(n_seg - 1) * seg_len >= S ||
      static_cast<long long>(n_seg) * seg_len < S)
    return cudaErrorInvalidValue;
  if (N == 16)
    return launch_ssm_n<T, 16>(dt, x, bm, cm, a_log, h0, y, h_out, seg_h, seg_dsum, B, S, Di,
                               n_seg, seg_len, stream);
  if (N == 8)
    return launch_ssm_n<T, 8>(dt, x, bm, cm, a_log, h0, y, h_out, seg_h, seg_dsum, B, S, Di,
                              n_seg, seg_len, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
int output_blocks_per_sm(int N) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (N == 16)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssm_pass_kernel<T, 16, true>,
                                                        kThreads, 0);
  if (N == 8)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssm_pass_kernel<T, 8, true>,
                                                        kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Output-pass blocks one SM holds at once (the wrapper's segment rule fills
// one wave of them); a cudaError_t, negated, on failure.
int ssm_output_blocks_per_sm(int dtype, int N) {
  if (dtype == kF32) return output_blocks_per_sm<float>(N);
  if (dtype == kBF16) return output_blocks_per_sm<__nv_bfloat16>(N);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Returns the cudaError_t of the launches (0 on success). dt, x, B and C
// share one dtype (0: f32, 1: bf16); h0 may be null (a zero state) and may
// equal h_out (updated in place). The time axis runs as n_seg segments of
// seg_len steps (the last may be shorter); with n_seg > 1, seg_h (B, n_seg,
// Di, N) and seg_dsum (B, n_seg, Di) are f32 scratch.
int ssm_selective_scan(int dtype, const void* dt, const void* x, const void* bm, const void* cm,
                       const float* a_log, const float* h0, float* y, float* h_out, float* seg_h,
                       float* seg_dsum, int B, int S, int Di, int N, int n_seg, int seg_len,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_ssm<float>(dt, x, bm, cm, a_log, h0, y, h_out, seg_h,
                                                seg_dsum, B, S, Di, N, n_seg, seg_len, st));
    case kBF16:
      return static_cast<int>(launch_ssm<__nv_bfloat16>(dt, x, bm, cm, a_log, h0, y, h_out,
                                                        seg_h, seg_dsum, B, S, Di, N, n_seg,
                                                        seg_len, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
