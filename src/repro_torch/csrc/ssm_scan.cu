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
//   Design: a thread owns one (row, channel, state) element: h lives in a
//   register for the whole sequence, and the N threads of a channel are N
//   consecutive lanes of one warp. A 128-thread block owns 128 / N channels
//   (8 at N = 16: Di / 8 = 200 blocks at B = 1, Di = 1600). At B = 1 that is
//   only 1-2 warps per scheduler, so a step must not wait on anything but
//   h. Only h crosses steps, through one FMA a step: the step loop runs in
//   batches of 8, first the 8 steps' loads, exp(dt * A) and (dt * x) * B,
//   then the 8 FMAs of h, and each step leaves its h * C_t[n] in shared
//   memory and goes on (a shuffle sum of y_t inside the step put its
//   latency on every step); a pass after each chunk sums the N partials of
//   every (step, channel) into y. Still latency-bound: with ~6 warps an SM
//   each step's loads, exponential and FMA wait on one another; splitting
//   the time axis (a chunked scan with a carry pass) is the next step.
//   Time runs in chunks of KT steps, 128 at prefill and 16 when S <= 16 (a
//   128-step chunk's 104 KB of shared memory would leave room for 2 of a
//   decode step's 1600 blocks an SM): (dt, dt * x) of the block's channels
//   and (B, C) of the row are staged in shared memory as f32 pairs (one
//   8-byte load each a step), while the next chunk's loads are in flight in
//   registers (kept raw, widened only when staged); a step past S has
//   dt = 0, which leaves h as it is.
//   h is read once at the start and written once at the end by the thread
//   that owns it, so h_out may be h0 itself: the decode step updates the
//   cache's state slice in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBatch = 8;      // steps whose loads and exponentials run ahead of h
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Shared memory of a block (bytes): (dt, dt * x) of KT steps x its channels,
// (B, C) of KT steps, and the h * C partials of KT steps x its threads (a
// channel's N partials padded to N + 4 floats, so that the reduction's
// 16-byte loads of 8 channels fall in 8 different bank groups).
template <int N, int KT>
__host__ __device__ constexpr int smem_bytes() {
  return KT * (kThreads / N) * 8 + KT * N * 8 + KT * (kThreads / N) * (N + 4) * 4;
}

// The chunk of steps [t0, t0 + KT) that a thread stages: dt and x of the
// block's channels, B and C of the row, raw, zeros past S and Di.
template <typename T, int N, int KT>
__device__ __forceinline__ void fetch_chunk(T (&r_dt)[KT / N], T (&r_x)[KT / N],
                                            T (&r_b)[KT * N / kThreads],
                                            T (&r_c)[KT * N / kThreads],
                                            const T* __restrict__ dt, const T* __restrict__ x,
                                            const T* __restrict__ bm, const T* __restrict__ cm,
                                            size_t row0, int t0, int S, int Di, int d0) {
  constexpr int CH = kThreads / N;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < KT / N; ++i) {
    const int e = tid + i * kThreads, r = e / CH, c = e % CH;
    r_dt[i] = r_x[i] = zero_of<T>();
    if (t0 + r < S && d0 + c < Di) {
      const size_t off = (row0 + t0 + r) * Di + d0 + c;
      r_dt[i] = dt[off];
      r_x[i] = x[off];
    }
  }
#pragma unroll
  for (int i = 0; i < KT * N / kThreads; ++i) {
    const int e = tid + i * kThreads, r = e / N, c = e % N;
    r_b[i] = r_c[i] = zero_of<T>();
    if (t0 + r < S) {
      const size_t off = (row0 + t0 + r) * N + c;
      r_b[i] = bm[off];
      r_c[i] = cm[off];
    }
  }
}

template <typename T, int N, int KT>
__global__ void __launch_bounds__(kThreads)
ssm_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ a_log, const float* h0,
           float* __restrict__ y, float* h_out, int S, int Di) {
  constexpr int CH = kThreads / N;        // channels of a block
  constexpr int PD = KT * CH / kThreads;  // dt and x elements a thread stages per chunk
  constexpr int PB = KT * N / kThreads;   // B and C elements a thread stages per chunk
  static_assert(KT % kBatch == 0 && PD >= 1 && PB >= 1, "chunk shape");
  constexpr int PR = CH * (N + 4);        // floats of a step's partials
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_p = reinterpret_cast<float*>(smem_raw);                  // [KT][CH][N + 4]
  float2* s_d = reinterpret_cast<float2*>(s_p + KT * PR);           // [KT][CH]: (dt, dt x)
  float2* s_bc = s_d + KT * CH;                                     // [KT][N]: (B, C)

  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int tid = threadIdx.x, ch = tid / N, n = tid % N, d = d0 + ch;
  const bool live = d < Di;
  const size_t row0 = static_cast<size_t>(b) * S;  // first time step of row b
  const size_t hi = (static_cast<size_t>(b) * Di + d) * N + n;
  // exp(dt * A) = exp2(dt * A * log2(e)): one SFU instruction a step
  // (ex2.approx.ftz: a result below 2^-126 becomes 0, which changes h by
  // less than 1e-37)
  const float a2 = live ? -expf(a_log[static_cast<size_t>(d) * N + n]) * kLog2e : 0.f;
  float h = (live && h0 != nullptr) ? h0[hi] : 0.f;

  T r_dt[PD], r_x[PD], r_b[PB], r_c[PB];
  fetch_chunk<T, N, KT>(r_dt, r_x, r_b, r_c, dt, x, bm, cm, row0, 0, S, Di, d0);
  for (int t0 = 0; t0 < S; t0 += KT) {
    const int tc = min(KT, S - t0);
    __syncthreads();  // the previous chunk's staging and partials are no longer read
#pragma unroll
    for (int i = 0; i < PD; ++i) {
      const float dtv = to_f32(r_dt[i]);
      s_d[tid + i * kThreads] = make_float2(dtv, dtv * to_f32(r_x[i]));
    }
#pragma unroll
    for (int i = 0; i < PB; ++i)
      s_bc[tid + i * kThreads] = make_float2(to_f32(r_b[i]), to_f32(r_c[i]));
    __syncthreads();
    if (t0 + KT < S)  // in flight while this chunk runs
      fetch_chunk<T, N, KT>(r_dt, r_x, r_b, r_c, dt, x, bm, cm, row0, t0 + KT, S, Di, d0);

    // steps r0 .. r0 + 7 (past tc only inside the chunk: zeros, h unchanged)
    for (int r0 = 0; r0 < tc; r0 += kBatch) {
      float da[kBatch], u[kBatch], c[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float2 d2 = s_d[(r0 + j) * CH + ch];
        const float2 bc = s_bc[(r0 + j) * N + n];
        asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(da[j]) : "f"(d2.x * a2));
        u[j] = d2.y * bc.x;
        c[j] = bc.y;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        h = fmaf(da[j], h, u[j]);
        s_p[(r0 + j) * PR + ch * (N + 4) + n] = h * c[j];
      }
    }
    __syncthreads();
    // y of the chunk: (step r, channel c) sums the N partials of its lanes
#pragma unroll
    for (int i = 0; i < PD; ++i) {
      const int e = tid + i * kThreads, r = e / CH, cc = e % CH;
      const float4* part = reinterpret_cast<const float4*>(s_p + r * PR + cc * (N + 4));
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 v = part[q];
        acc += (v.x + v.y) + (v.z + v.w);
      }
      if (r < tc && d0 + cc < Di) y[(row0 + t0 + r) * Di + d0 + cc] = acc;
    }
  }
  if (live) h_out[hi] = h;
}

template <typename T, int N, int KT>
cudaError_t launch_ssm_nk(const void* dt, const void* x, const void* bm, const void* cm,
                          const float* a_log, const float* h0, float* y, float* h_out, int B,
                          int S, int Di, cudaStream_t stream) {
  constexpr int CH = kThreads / N;
  constexpr int smem = smem_bytes<N, KT>();
  auto kernel = ssm_kernel<T, N, KT>;
  if (smem > 48 * 1024) {  // above 48 KB dynamic shared memory must be allowed first
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((Di + CH - 1) / CH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), a_log, h0, y, h_out, S, Di);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_ssm_n(const void* dt, const void* x, const void* bm, const void* cm,
                         const float* a_log, const float* h0, float* y, float* h_out, int B,
                         int S, int Di, cudaStream_t stream) {
  if (S <= 16)
    return launch_ssm_nk<T, N, 16>(dt, x, bm, cm, a_log, h0, y, h_out, B, S, Di, stream);
  return launch_ssm_nk<T, N, 128>(dt, x, bm, cm, a_log, h0, y, h_out, B, S, Di, stream);
}

template <typename T>
cudaError_t launch_ssm(const void* dt, const void* x, const void* bm, const void* cm,
                       const float* a_log, const float* h0, float* y, float* h_out, int B,
                       int S, int Di, int N, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0) return cudaErrorInvalidValue;
  if (N == 16) return launch_ssm_n<T, 16>(dt, x, bm, cm, a_log, h0, y, h_out, B, S, Di, stream);
  if (N == 8) return launch_ssm_n<T, 8>(dt, x, bm, cm, a_log, h0, y, h_out, B, S, Di, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dt, x, B and C
// share one dtype (0: f32, 1: bf16); h0 may be null (a zero state) and may
// equal h_out (updated in place).
int ssm_selective_scan(int dtype, const void* dt, const void* x, const void* bm, const void* cm,
                       const float* a_log, const float* h0, float* y, float* h_out, int B,
                       int S, int Di, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(
          launch_ssm<float>(dt, x, bm, cm, a_log, h0, y, h_out, B, S, Di, N, st));
    case kBF16:
      return static_cast<int>(
          launch_ssm<__nv_bfloat16>(dt, x, bm, cm, a_log, h0, y, h_out, B, S, Di, N, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
