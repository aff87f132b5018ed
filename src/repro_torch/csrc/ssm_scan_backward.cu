// Backward of the selective scan (the Mamba heads of Hymba's hybrid layers)
// for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (ctypes). Built by repro_torch/kernels/_build.py. It backs the backward
// of kernels.ssm_scan.SelectiveScan, which models/ssm.py::apply_ssm runs
// under grad: every SSM layer of a hybrid stack in training.
//
// ssm_scan_backward
//   Replaces no Pallas kernel: JAX differentiates the plain recurrence
//   (autodiff of repro/models/layers.py::chunked_scan over the step of
//   repro/models/ssm.py::apply_ssm; no JAX caller routes training through
//   its Pallas scan). It computes that gradient: the exact gradient of the
//   sequential f32 recurrence of ssm_scan.cu,
//     h_t = a_t * h_{t-1} + (dt_t x_t) B_t,  a_t = exp(dt_t A),  y_t = C_t . h_t,
//   for the cotangents dy (B, S, Di) f32 and dh of the final h (B, Di, N)
//   f32 (null: zero). With the adjoint g_t = dL/dh_t, run backward in time,
//     g_t = C_t dy_t + G_t,   G_t = a_{t+1} * g_{t+1}   (G_{S-1} = dh),
//   the gradients are, per step and channel d (sums over the states n),
//     dC_t[n] = sum_d dy_t[d] h_t[d,n]      dB_t[n] = sum_d g_t[d,n] dt_t x_t
//     dx_t    = dt_t sum_n g_t B_t[n]       ddt_t = sum_n g_t h_{t-1} a_t A + x_t sum_n g_t B_t
//     dA      = sum_{b,t} g_t h_{t-1} a_t dt_t,   da_log = A * dA,   dh0 = G_{-1}.
//   dt, x, B, C in f32 or bf16 (the gradients in the same dtype, computed
//   in f32); a_log (Di, N) f32; h0, dh, dh0 f32. N is 16 or 8; any S >= 1.
//   Bound on the H100: the contract's 18 f32 operations an element and
//   step at 67 TFLOP/s (an FMA counted as 2: the state recomputed 4, the
//   adjoint 2, dC and dB 2 each, the lane sum of g B 2, G = a g 1, G h 1,
//   its FMAs with A and with dt 2 each), a little above its one
//   exponential an element and step at the SFU rate; in bf16 the bytes
//   (the inputs read once, the gradients written once) are smaller, in
//   f32 they are the bound (chip_smoke.py scan_backward_work). The kernels
//   take four exponentials an element and step (the local pass two, the
//   output pass's forward and reverse walks one each) and one a segment in
//   the carry.
//
//   Design. No state is ever walked backward by division: a decay a_t
//   underflows to 0 for a strong decay, and h_{t-1} is then lost from h_t.
//   The states are recomputed forward from saved carries instead, as
//   chunked_scan recomputes its inner steps. The time axis is cut into
//   segments of kSeg steps, and the adjoint, itself a linear recurrence
//   run in reverse, is cut at the same places. Four launches:
//   1. ssmb_local_kernel, one block per (channel block, segment, row):
//      segment j's end state from a zero state, its sum of dt, and its
//      local adjoint: a_{s0} * g_{s0} from a zero adjoint at its end.
//   2. ssmb_carry_kernel, one thread per 4 states: the true start state of
//      every segment, h_start[j] = exp(A sum dt[j-1]) h_start[j-1] +
//      h_loc[j-1] from h_start[0] = h0, and the true adjoint reaching its
//      end, G_end[j] = g_loc[j+1] + exp(A sum dt[j+1]) G_end[j+1] from
//      G_end[n_seg-1] = dh, in place.
//   3. ssmb_output_kernel, one block per (channel block, segment, row): the
//      forward walk over the segment from h_start keeps each h_{t-1} in
//      shared memory, then the reverse walk from G_end makes every
//      gradient. A thread holds 4 states of one channel (the N / 4 lanes of
//      a channel neighbouring), so ddt and dx are lane sums (shuffles); dB
//      and dC are sums over the block's channels (shuffles across a warp's
//      channels, then the warps' sums through shared memory), written as
//      the block's partials; dA's share of the segment stays in registers
//      and goes out once.
//   4. ssmb_reduce_kernel: dB and dC add the channel blocks' partials, and
//      da_log the (row, segment) shares of dA, each in a fixed order.
//   No atomics: every sum is taken in one order, so two calls give the same
//   bits.
#include "scan_common.cuh"

namespace {

using scan::ld4;
using scan::st4;
using scan::to_f32;
using scan::Vec4;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSV = 4;         // states a thread holds of a channel
constexpr int kSeg = 16;       // steps of a segment (kernels.ssm_scan.BACKWARD_SEGMENT)
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1 };

// exp(dt * A) = exp2(dt * A * log2(e)), as the forward kernel takes it
// (ex2.approx.ftz: a result below 2^-126 becomes 0)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Thread tid holds states ng * 4 .. + 3 (ng = tid % NG) of channel
// blockIdx.x * CH + tid / NG.
template <int N>
struct Lanes {
  static constexpr int NG = N / kSV;        // lanes of a channel
  static constexpr int CH = kThreads / NG;  // channels of a block
  static_assert(N % kSV == 0 && 32 % NG == 0, "state size");
};

__device__ __forceinline__ void load4(float (&h)[kSV], const float* p) {
  const float4 x = ld4(p);
  h[0] = x.x; h[1] = x.y; h[2] = x.z; h[3] = x.w;
}
__device__ __forceinline__ void store4(float* p, const float (&h)[kSV]) {
  st4(p, make_float4(h[0], h[1], h[2], h[3]));
}
__device__ __forceinline__ void zero4(float (&h)[kSV]) { h[0] = h[1] = h[2] = h[3] = 0.f; }

// A (a) and A log2(e) (a2) of a thread's 4 states of channel d.
__device__ __forceinline__ void rates(float (&a)[kSV], float (&a2)[kSV], const float* a_log,
                                      size_t el) {
  const float4 al = ld4(a_log + el);
  a[0] = -expf(al.x); a[1] = -expf(al.y); a[2] = -expf(al.z); a[3] = -expf(al.w);
#pragma unroll
  for (int q = 0; q < kSV; ++q) a2[q] = a[q] * kLog2e;
}

// One step's inputs of a thread: dt, x, dy of its channel and 4 of B and C.
template <typename T, int N>
struct Step {
  float dt, x, dy, b[kSV], c[kSV];
  __device__ __forceinline__ void load(const T* dtp, const T* xp, const T* bmp, const T* cmp,
                                       const float* dyp, size_t rt, int Di, int d, int n0) {
    using V = Vec4<T>;
    dt = to_f32(dtp[rt * Di + d]);
    x = to_f32(xp[rt * Di + d]);
    dy = dyp[rt * Di + d];
    const float4 b4 = V::widen(V::load(bmp + rt * N + n0));
    const float4 c4 = V::widen(V::load(cmp + rt * N + n0));
    b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
    c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
  }
};

// 1. Block (channel block, j, b): for j < n_seg - 1, segment j's end state
// from a zero state into h_slots slot j + 1 and its sum of dt into
// dsum[(b, j, d)]; for j >= 1, its local adjoint a_{s0} g_{s0} from a zero
// adjoint at its end into g_slots slot j - 1 (and, for the last segment,
// its sum of dt). h_slots and g_slots are (B, n_seg, Di, N), dsum (B,
// n_seg, Di).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssmb_local_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ a_log,
                  const float* __restrict__ dy, float* __restrict__ h_slots,
                  float* __restrict__ g_slots, float* __restrict__ dsum, int S, int Di,
                  int n_seg) {
  using Ln = Lanes<N>;
  const int j = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ng = tid % Ln::NG, d = blockIdx.x * Ln::CH + tid / Ln::NG, n0 = ng * kSV;
  if (d >= Di) return;  // no shuffles here: lanes past Di leave at once
  const int s0 = j * kSeg, s1 = min(S, s0 + kSeg);
  const size_t plane = static_cast<size_t>(Di) * N, el = static_cast<size_t>(d) * N + n0;
  const size_t row0 = static_cast<size_t>(b) * S;
  float a[kSV], a2[kSV];
  rates(a, a2, a_log, el);
  Step<T, N> in;
  if (j < n_seg - 1) {
    float h[kSV], ds = 0.f;
    zero4(h);
    for (int t = s0; t < s1; ++t) {
      in.load(dt, x, bm, cm, dy, row0 + t, Di, d, n0);
      const float dx = in.dt * in.x;
#pragma unroll
      for (int q = 0; q < kSV; ++q) h[q] = fmaf(ex2(in.dt * a2[q]), h[q], dx * in.b[q]);
      ds += in.dt;
    }
    store4(h_slots + (static_cast<size_t>(b) * n_seg + j + 1) * plane + el, h);
    if (ng == 0) dsum[(static_cast<size_t>(b) * n_seg + j) * Di + d] = ds;
  }
  if (j >= 1) {
    float g[kSV], ds = 0.f;
    zero4(g);
    for (int t = s1 - 1; t >= s0; --t) {
      in.load(dt, x, bm, cm, dy, row0 + t, Di, d, n0);
#pragma unroll
      for (int q = 0; q < kSV; ++q) g[q] = ex2(in.dt * a2[q]) * fmaf(in.c[q], in.dy, g[q]);
      ds += in.dt;
    }
    store4(g_slots + (static_cast<size_t>(b) * n_seg + j - 1) * plane + el, g);
    if (j == n_seg - 1 && ng == 0) dsum[(static_cast<size_t>(b) * n_seg + j) * Di + d] = ds;
  }
}

// 2. Thread (b, d, 4 states): the carries over the segments, in place.
// Afterwards h_slots slot j (j >= 1) holds segment j's true start state and
// g_slots slot j (j <= n_seg - 2) the true adjoint reaching its end.
__global__ void __launch_bounds__(kThreads)
ssmb_carry_kernel(const float* __restrict__ a_log, const float* __restrict__ h0,
                  const float* __restrict__ dh, float* __restrict__ h_slots,
                  float* __restrict__ g_slots, const float* __restrict__ dsum, int B, int Di,
                  int N, int n_seg) {
  const long long gi = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int groups = N / kSV;
  if (gi >= static_cast<long long>(B) * Di * groups) return;
  const int n0 = static_cast<int>(gi % groups) * kSV;
  const long long cd = gi / groups;
  const int d = static_cast<int>(cd % Di), b = static_cast<int>(cd / Di);
  const size_t plane = static_cast<size_t>(Di) * N, el = static_cast<size_t>(d) * N + n0;
  const size_t base = static_cast<size_t>(b) * n_seg;
  float a[kSV], a2[kSV];
  rates(a, a2, a_log, el);
  float h[kSV];
  zero4(h);
  if (h0 != nullptr) load4(h, h0 + b * plane + el);
  for (int j = 1; j < n_seg; ++j) {
    const float ds = dsum[(base + j - 1) * Di + d];
    float hl[kSV];
    load4(hl, h_slots + (base + j) * plane + el);
#pragma unroll
    for (int q = 0; q < kSV; ++q) h[q] = fmaf(ex2(a2[q] * ds), h[q], hl[q]);
    store4(h_slots + (base + j) * plane + el, h);
  }
  float g[kSV];
  zero4(g);
  if (dh != nullptr) load4(g, dh + b * plane + el);
  for (int j = n_seg - 2; j >= 0; --j) {
    const float ds = dsum[(base + j + 1) * Di + d];
    float gl[kSV];
    load4(gl, g_slots + (base + j) * plane + el);
#pragma unroll
    for (int q = 0; q < kSV; ++q) g[q] = fmaf(ex2(a2[q] * ds), g[q], gl[q]);
    store4(g_slots + (base + j) * plane + el, g);
  }
}

// 3. Block (channel block, j, b): segment j's gradients. ddt and dx (B, S,
// Di) in T; dh0 (segment 0); part_a (B, n_seg, Di, N) the segment's share
// of dA; part_bc (n_cb, B, S, 2N) the block's shares of dB (n < N) and dC.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssmb_output_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                   const T* __restrict__ cm, const float* __restrict__ a_log,
                   const float* __restrict__ h0, const float* __restrict__ dy,
                   const float* __restrict__ dh, T* __restrict__ ddt, T* __restrict__ dx,
                   const float* __restrict__ h_slots, const float* __restrict__ g_slots,
                   float* __restrict__ dh0, float* __restrict__ part_a,
                   float* __restrict__ part_bc, int B, int S, int Di, int n_seg) {
  using Ln = Lanes<N>;
  constexpr int NG = Ln::NG;
  __shared__ __align__(16) float4 s_h[kSeg][kThreads];      // h_{t-1} of each step
  __shared__ __align__(16) float s_bc[kSeg][kWarps][2 * N];  // the warps' dB, dC sums

  const int j = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = tid % NG, d = blockIdx.x * Ln::CH + tid / NG, n0 = ng * kSV;
  const bool live = d < Di;  // the lanes past Di still join the shuffles, with zeros
  const int s0 = j * kSeg, s1 = min(S, s0 + kSeg), tc = s1 - s0;
  const size_t plane = static_cast<size_t>(Di) * N, el = static_cast<size_t>(d) * N + n0;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t slot = (static_cast<size_t>(b) * n_seg + j) * plane + el;

  float a[kSV], a2[kSV], h[kSV], g_end[kSV];
  zero4(a); zero4(a2); zero4(h); zero4(g_end);
  if (live) {
    rates(a, a2, a_log, el);
    if (j > 0) load4(h, h_slots + slot);
    else if (h0 != nullptr) load4(h, h0 + b * plane + el);
    if (j < n_seg - 1) load4(g_end, g_slots + slot);
    else if (dh != nullptr) load4(g_end, dh + b * plane + el);
  }
  Step<T, N> in;
  // the forward walk: each step's h_{t-1} into shared memory (read back by
  // this thread alone)
  for (int i = 0; i < tc; ++i) {
    s_h[i][tid] = make_float4(h[0], h[1], h[2], h[3]);
    if (live) {
      in.load(dt, x, bm, cm, dy, row0 + s0 + i, Di, d, n0);
      const float dxv = in.dt * in.x;
#pragma unroll
      for (int q = 0; q < kSV; ++q) h[q] = fmaf(ex2(in.dt * a2[q]), h[q], dxv * in.b[q]);
    }
  }
  // the reverse walk; G is the adjoint reaching h_t from later steps
  float G[kSV] = {g_end[0], g_end[1], g_end[2], g_end[3]};
  float da_acc[kSV];
  zero4(da_acc);
  for (int i = tc - 1; i >= 0; --i) {
    const size_t rt = row0 + s0 + i;
    float db[kSV], dc[kSV], gb = 0.f, gd = 0.f;
    zero4(db); zero4(dc);
    if (live) {
      in.load(dt, x, bm, cm, dy, rt, Di, d, n0);
      const float4 hp4 = s_h[i][tid];
      const float hp[kSV] = {hp4.x, hp4.y, hp4.z, hp4.w};
      const float dxv = in.dt * in.x;
#pragma unroll
      for (int q = 0; q < kSV; ++q) {
        const float decay = ex2(in.dt * a2[q]);
        const float ht = fmaf(decay, hp[q], dxv * in.b[q]);
        const float g = fmaf(in.c[q], in.dy, G[q]);  // dL/dh_t
        const float gdecay = g * hp[q] * decay;      // dL/d(dt A)
        dc[q] = in.dy * ht;
        db[q] = g * dxv;
        gb = fmaf(g, in.b[q], gb);
        gd = fmaf(gdecay, a[q], gd);
        da_acc[q] = fmaf(gdecay, in.dt, da_acc[q]);
        G[q] = decay * g;
      }
    }
    // the channel's sums over its NG lanes
#pragma unroll
    for (int m = 1; m < NG; m <<= 1) {
      gb += __shfl_xor_sync(0xffffffffu, gb, m);
      gd += __shfl_xor_sync(0xffffffffu, gd, m);
    }
    if (live && ng == 0) {
      ddt[rt * Di + d] = from_f32<T>(fmaf(in.x, gb, gd));
      dx[rt * Di + d] = from_f32<T>(in.dt * gb);
    }
    // dB and dC: the warp's channels summed by shuffles
#pragma unroll
    for (int m = NG; m < 32; m <<= 1)
#pragma unroll
      for (int q = 0; q < kSV; ++q) {
        db[q] += __shfl_xor_sync(0xffffffffu, db[q], m);
        dc[q] += __shfl_xor_sync(0xffffffffu, dc[q], m);
      }
    if (lane < NG) {
      st4(&s_bc[i][warp][n0], make_float4(db[0], db[1], db[2], db[3]));
      st4(&s_bc[i][warp][N + n0], make_float4(dc[0], dc[1], dc[2], dc[3]));
    }
  }
  if (live) {
    if (j == 0) store4(dh0 + b * plane + el, G);
    store4(part_a + slot, da_acc);
  }
  __syncthreads();
  // the block's dB and dC: the warps' sums added in warp order
  const size_t cb = blockIdx.x;
  for (int e = tid; e < tc * 2 * N; e += kThreads) {
    const int i = e / (2 * N), n2 = e % (2 * N);
    float acc = s_bc[i][0][n2];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += s_bc[i][w][n2];
    part_bc[((cb * B + b) * S + s0 + i) * 2 * N + n2] = acc;
  }
}

// 4. dB and dC (B, S, N) in T: the n_cb channel blocks' partials added in
// block order; da_log (Di, N) f32: A times the (row, segment) shares of dA
// added in order.
template <typename T>
__global__ void __launch_bounds__(256)
ssmb_reduce_kernel(const float* __restrict__ a_log, const float* __restrict__ part_a,
                   const float* __restrict__ part_bc, T* __restrict__ dbm, T* __restrict__ dcm,
                   float* __restrict__ da_log, int B, int S, int Di, int N, int n_seg,
                   int n_cb) {
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long n_bc = static_cast<long long>(B) * S * 2 * N;
  if (e < n_bc) {
    const long long bt = e / (2 * N);
    const int n2 = static_cast<int>(e % (2 * N));
    const long long stride = static_cast<long long>(B) * S * 2 * N;
    float acc = 0.f;
    for (int cb = 0; cb < n_cb; ++cb) acc += part_bc[cb * stride + e];
    if (n2 < N) dbm[bt * N + n2] = from_f32<T>(acc);
    else dcm[bt * N + n2 - N] = from_f32<T>(acc);
    return;
  }
  const long long dn = e - n_bc;
  const long long plane = static_cast<long long>(Di) * N;
  if (dn >= plane) return;
  float acc = 0.f;
  for (long long bj = 0; bj < static_cast<long long>(B) * n_seg; ++bj) acc += part_a[bj * plane + dn];
  da_log[dn] = -expf(a_log[dn]) * acc;
}

template <typename T, int N>
cudaError_t launch_n(const void* dt_, const void* x_, const void* bm_, const void* cm_,
                     const float* a_log, const float* h0, const float* dy, const float* dh,
                     void* ddt, void* dx, void* dbm, void* dcm, float* da_log, float* dh0,
                     float* h_slots, float* g_slots, float* dsum, float* part_a, float* part_bc,
                     int B, int S, int Di, int n_seg, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(dt_);
  const T* x = static_cast<const T*>(x_);
  const T* bm = static_cast<const T*>(bm_);
  const T* cm = static_cast<const T*>(cm_);
  const int n_cb = (Di + Lanes<N>::CH - 1) / Lanes<N>::CH;
  const dim3 grid(n_cb, n_seg, B);
  cudaError_t err;
  if (n_seg > 1) {
    ssmb_local_kernel<T, N><<<grid, kThreads, 0, stream>>>(dt, x, bm, cm, a_log, dy, h_slots,
                                                           g_slots, dsum, S, Di, n_seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long threads = static_cast<long long>(B) * Di * (N / kSV);
    ssmb_carry_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                        stream>>>(a_log, h0, dh, h_slots, g_slots, dsum, B, Di, N, n_seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssmb_output_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      dt, x, bm, cm, a_log, h0, dy, dh, static_cast<T*>(ddt), static_cast<T*>(dx), h_slots,
      g_slots, dh0, part_a, part_bc, B, S, Di, n_seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long work = static_cast<long long>(B) * S * 2 * N + static_cast<long long>(Di) * N;
  ssmb_reduce_kernel<T><<<static_cast<unsigned>((work + 255) / 256), 256, 0, stream>>>(
      a_log, part_a, part_bc, static_cast<T*>(dbm), static_cast<T*>(dcm), da_log, B, S, Di, N,
      n_seg, n_cb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* dt, const void* x, const void* bm, const void* cm,
                   const float* a_log, const float* h0, const float* dy, const float* dh,
                   void* ddt, void* dx, void* dbm, void* dcm, float* da_log, float* dh0,
                   float* h_slots, float* g_slots, float* dsum, float* part_a, float* part_bc,
                   int B, int S, int Di, int N, int n_seg, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0) return cudaErrorInvalidValue;
  // segments of kSeg steps cover S exactly once
  if (n_seg < 1 || n_seg > 65535 || n_seg != (S + kSeg - 1) / kSeg) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * Di * (N / kSV) > 0x7fffffffLL * kThreads)
    return cudaErrorInvalidValue;
  if (N == 16)
    return launch_n<T, 16>(dt, x, bm, cm, a_log, h0, dy, dh, ddt, dx, dbm, dcm, da_log, dh0,
                           h_slots, g_slots, dsum, part_a, part_bc, B, S, Di, n_seg, stream);
  if (N == 8)
    return launch_n<T, 8>(dt, x, bm, cm, a_log, h0, dy, dh, ddt, dx, dbm, dcm, da_log, dh0,
                          h_slots, g_slots, dsum, part_a, part_bc, B, S, Di, n_seg, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 on success). dt, x, B, C and
// the gradients ddt, dx, dbm, dcm share one dtype (0: f32, 1: bf16);
// a_log, dy, da_log and the states are f32; h0 and dh may be null (zero).
// The scratch: h_slots and g_slots (B, n_seg, Di, N), dsum (B, n_seg, Di),
// part_a (B, n_seg, Di, N) and part_bc (n_cb, B, S, 2N), with n_seg =
// ceil(S / 16) and n_cb = ceil(Di / (512 / N)).
int ssmb_selective_scan_backward(int dtype, const void* dt, const void* x, const void* bm,
                                 const void* cm, const float* a_log, const float* h0,
                                 const float* dy, const float* dh, void* ddt, void* dx,
                                 void* dbm, void* dcm, float* da_log, float* dh0,
                                 float* h_slots, float* g_slots, float* dsum, float* part_a,
                                 float* part_bc, int B, int S, int Di, int N, int n_seg,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float>(dt, x, bm, cm, a_log, h0, dy, dh, ddt, dx, dbm, dcm,
                                            da_log, dh0, h_slots, g_slots, dsum, part_a, part_bc,
                                            B, S, Di, N, n_seg, st));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(dt, x, bm, cm, a_log, h0, dy, dh, ddt, dx,
                                                     dbm, dcm, da_log, dh0, h_slots, g_slots,
                                                     dsum, part_a, part_bc, B, S, Di, N, n_seg,
                                                     st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
