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
//   f32 they are the bound (chip_smoke.py scan_backward_work).
//
//   Design. No state is ever walked backward by division: a decay a_t
//   underflows to 0 for a strong decay, and h_{t-1} is then lost from h_t.
//   The states are recomputed forward from checkpoints instead, as
//   chunked_scan recomputes its inner steps. The time axis is cut into
//   n_seg segments of seg_len steps (the wrapper's ssm_backward_segments: as
//   many as one wave of the output pass holds), each a whole number of
//   kT-step chunks. A thread of the output pass holds 4 states of 2 channels
//   (the N / 4 lanes of a channel pair neighbouring), a 128-thread block
//   1024 / N channels; one of the local pass 2 states, so that it has twice
//   the blocks. A chunk's inputs are staged in shared memory as f32, the
//   next chunk's loads in flight. Three launches:
//   1. ssmb_local_kernel, one block per (channel block, segment, row): one
//      walk forward over the segment from a zero state, one exponential an
//      element and step, keeping the state h, the product p of the a's since
//      the segment's start, and the local adjoint sum_t p_t C_t dy_t (that of
//      the state before the segment, from a zero adjoint after it). At every
//      chunk start but the first, h and p go to ck_h, ck_p; at the end, h,
//      p and the adjoint to h_slot, decay, g_slot for the carry.
//   2. ssmb_output_kernel, one block per (channel block, segment, row): the
//      carry first (the segment's true start state from h0 over the earlier
//      segments, its true end adjoint from dh over the later ones: one FMA an
//      element a segment, no exponential), then its chunks in reverse: the
//      chunk's start state p h_start + h_loc (the checkpoint copied into the
//      thread's slot of shared memory by cp.async a chunk ahead), a walk
//      forward over the kT steps
//      keeping each step's h_{t-1} and a_t in registers (the chunk's one
//      exponential an element and step), and the walk back, which takes no
//      exponential. dB and dC: each thread first adds its two channels, then
//      the warp's channels by a transpose-reduce (three shuffles of halves,
//      each lane left with one (kind, n) sum), the warps' sums through shared
//      memory in warp order, written as the block's partials; ddt and dx: the
//      channel's lanes by a transpose-reduce of (g B, g h a A) as well; dA's
//      share of the segment stays in registers and goes out once.
//   3. ssmb_reduce_kernel: dB and dC add the channel blocks' partials, and
//      da_log the (row, segment) shares of dA, each in a fixed order.
//   Two exponentials an element and step in all (the local walk and the
//   output pass's forward walk), none in the carry. No atomics: every sum is
//   taken in one order, so two calls give the same bits.
#include "scan_common.cuh"

namespace {

using scan::cp_async16;
using scan::cp_async_commit;
using scan::cp_async_wait;
using scan::ld4;
using scan::st4;
using scan::to_f32;
using scan::Vec4;
using scan::zero_of;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSV = 4;         // states a thread of the output pass holds of a channel
constexpr int kSVL = 2;        // states a thread of the local pass holds of a channel
constexpr int kCPT = 2;        // channels a thread holds
constexpr int kCkStride = 2 * kCPT * kSV + 4;  // floats of a thread's checkpoint slot (padded)
constexpr int kT = 8;          // steps of a chunk (kernels.ssm_scan.BACKWARD_CHUNK): the history a thread keeps
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

// Thread tid holds states ng * SV .. + SV - 1 (ng = tid % NG) of the
// channels blockIdx.x * CH + 2 cp and + 1 (cp = tid / NG).
template <int N, int SV>
struct Lanes {
  static constexpr int NG = N / SV;                                     // lanes of a channel pair
  static constexpr int CP = kThreads / NG;                              // channel pairs of a block
  static constexpr int CH = CP * kCPT;                                  // channels of a block
  static constexpr int PD = kT * CH / kThreads;                         // dt, x, dy a thread stages
  static constexpr int PB = (kT * N + kThreads - 1) / kThreads;         // B, C a thread stages
  static_assert(N % SV == 0 && 32 % NG == 0 && PD >= 1, "state size");
};

// A chunk's inputs in shared memory: (dt, x) of both channels of a pair,
// dy of both, B and C of the row.
template <int N, int SV>
struct Staged {
  using Ln = Lanes<N, SV>;
  float d[kT * Ln::CP * 4];   // (t, pair): dt0, x0, dt1, x1
  float y[kT * Ln::CP * 2];   // (t, pair): dy0, dy1
  float b[kT * N];            // (t, n)
  float c[kT * N];
};

// The next chunk's inputs in registers: zeros past tc and past Di.
template <typename T, int N, int SV>
struct Prefetch {
  using Ln = Lanes<N, SV>;
  T dt[Ln::PD], x[Ln::PD], b[Ln::PB], c[Ln::PB];
  float dy[Ln::PD];
  __device__ __forceinline__ void load(const T* dtp, const T* xp, const T* bm, const T* cm,
                                       const float* dyp, size_t row0, int t0, int tc, int Di,
                                       int d0, int tid) {
#pragma unroll
    for (int i = 0; i < Ln::PD; ++i) {
      const int e = tid + i * kThreads, t = e / Ln::CH, ch = e % Ln::CH;
      dt[i] = x[i] = zero_of<T>();
      dy[i] = 0.f;
      if (t < tc && d0 + ch < Di) {
        const size_t off = (row0 + t0 + t) * Di + d0 + ch;
        dt[i] = dtp[off];
        x[i] = xp[off];
        dy[i] = dyp[off];
      }
    }
#pragma unroll
    for (int i = 0; i < Ln::PB; ++i) {
      const int e = tid + i * kThreads, t = e / N;
      b[i] = c[i] = zero_of<T>();
      if (e < kT * N && t < tc) {
        const size_t off = (row0 + t0 + t) * N + e % N;
        b[i] = bm[off];
        c[i] = cm[off];
      }
    }
  }
  __device__ __forceinline__ void stage(Staged<N, SV>& s, int tid) const {
#pragma unroll
    for (int i = 0; i < Ln::PD; ++i) {
      const int e = tid + i * kThreads, t = e / Ln::CH, ch = e % Ln::CH;
      const int pr = t * Ln::CP + ch / 2, odd = ch % 2;
      *reinterpret_cast<float2*>(s.d + pr * 4 + odd * 2) = make_float2(to_f32(dt[i]), to_f32(x[i]));
      s.y[pr * 2 + odd] = dy[i];
    }
#pragma unroll
    for (int i = 0; i < Ln::PB; ++i) {
      const int e = tid + i * kThreads;
      if (e < kT * N) {
        s.b[e] = to_f32(b[i]);
        s.c[e] = to_f32(c[i]);
      }
    }
  }
};

// SV consecutive f32 values (SV 4 or 2), aligned to their size.
template <int SV>
__device__ __forceinline__ void vload(float (&h)[SV], const float* p) {
  if constexpr (SV == 4) {
    const float4 x = ld4(p);
    h[0] = x.x; h[1] = x.y; h[2] = x.z; h[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    h[0] = x.x; h[1] = x.y;
  }
}
template <int SV>
__device__ __forceinline__ void vstore(float* p, const float (&h)[SV]) {
  if constexpr (SV == 4) st4(p, make_float4(h[0], h[1], h[2], h[3]));
  else *reinterpret_cast<float2*>(p) = make_float2(h[0], h[1]);
}

// A and A log2(e) of a thread's states of its two channels (zeros off Di).
template <int N, int SV>
__device__ __forceinline__ void rates(float (&a)[kCPT][SV], float (&a2)[kCPT][SV],
                                      const float* a_log, const int (&d)[kCPT],
                                      const bool (&live)[kCPT], int n0) {
#pragma unroll
  for (int e = 0; e < kCPT; ++e) {
    float v[SV];
#pragma unroll
    for (int q = 0; q < SV; ++q) v[q] = 0.f;
    if (live[e]) vload<SV>(v, a_log + static_cast<size_t>(d[e]) * N + n0);
#pragma unroll
    for (int q = 0; q < SV; ++q) {
      a[e][q] = live[e] ? -expf(v[q]) : 0.f;
      a2[e][q] = a[e][q] * kLog2e;
    }
  }
}

// 1. Block (channel block, j, b): segment j of row b from a zero state, a
// thread 2 states of 2 channels (twice the blocks of the output pass, whose
// threads hold 4). At each chunk start but the first, the state so far and
// the product of its a's into ck_h, ck_p [(b, chunk)]; at the end, for j <
// n_seg - 1 the state into h_slot[(b, j)], for j >= 1 the local adjoint
// sum_t p_t C_t dy_t into g_slot[(b, j)], for every j the product of the
// segment's a's into decay[(b, j)]. ck_h, ck_p are (B, n_chunk, Di, N), the
// slots (B, n_seg, Di, N).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssmb_local_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ a_log,
                  const float* __restrict__ dy, float* __restrict__ ck_h,
                  float* __restrict__ ck_p, float* __restrict__ h_slot,
                  float* __restrict__ g_slot, float* __restrict__ decay, int S, int Di,
                  int n_seg, int seg_len) {
  constexpr int SV = kSVL;
  using Ln = Lanes<N, SV>;
  __shared__ __align__(16) Staged<N, SV> s;
  const int j = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, d0 = blockIdx.x * Ln::CH;
  const int ng = tid % Ln::NG, cp = tid / Ln::NG, n0 = ng * SV;
  const int d[kCPT] = {d0 + 2 * cp, d0 + 2 * cp + 1};
  const bool live[kCPT] = {d[0] < Di, d[1] < Di};
  const int s0 = j * seg_len, s1 = min(S, s0 + seg_len), n_chunk = (S + kT - 1) / kT;
  const size_t row0 = static_cast<size_t>(b) * S, plane = static_cast<size_t>(Di) * N;

  float a[kCPT][SV], a2[kCPT][SV], h[kCPT][SV], p[kCPT][SV], gl[kCPT][SV];
  rates<N, SV>(a, a2, a_log, d, live, n0);
#pragma unroll
  for (int e = 0; e < kCPT; ++e)
#pragma unroll
    for (int q = 0; q < SV; ++q) h[e][q] = gl[e][q] = 0.f, p[e][q] = 1.f;

  Prefetch<T, N, SV> pf;
  pf.load(dt, x, bm, cm, dy, row0, s0, min(kT, s1 - s0), Di, d0, tid);
  for (int t0 = s0; t0 < s1; t0 += kT) {
    if (t0 > s0) {  // the checkpoint: the local state before this chunk
      const size_t c = (static_cast<size_t>(b) * n_chunk + t0 / kT) * plane;
#pragma unroll
      for (int e = 0; e < kCPT; ++e)
        if (live[e]) {
          vstore<SV>(ck_h + c + static_cast<size_t>(d[e]) * N + n0, h[e]);
          vstore<SV>(ck_p + c + static_cast<size_t>(d[e]) * N + n0, p[e]);
        }
    }
    __syncthreads();  // the previous chunk is done with the staged inputs
    pf.stage(s, tid);
    __syncthreads();
    if (t0 + kT < s1) pf.load(dt, x, bm, cm, dy, row0, t0 + kT, min(kT, s1 - t0 - kT), Di, d0, tid);
    // the chunk's decays first (they do not depend on the state), then the
    // walk; steps past tc: dt = 0, so a = 1 and nothing moves
    float at[kT][kCPT][SV];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const float4 dd = ld4(s.d + (i * Ln::CP + cp) * 4);
      const float dtv[kCPT] = {dd.x, dd.z};
#pragma unroll
      for (int e = 0; e < kCPT; ++e)
#pragma unroll
        for (int q = 0; q < SV; ++q) at[i][e][q] = ex2(dtv[e] * a2[e][q]);
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const float4 dd = ld4(s.d + (i * Ln::CP + cp) * 4);
      const float2 y2 = *reinterpret_cast<const float2*>(s.y + (i * Ln::CP + cp) * 2);
      const float dxv[kCPT] = {dd.x * dd.y, dd.z * dd.w}, dyv[kCPT] = {y2.x, y2.y};
      float bv[SV], cv[SV];
      vload<SV>(bv, s.b + i * N + n0);
      vload<SV>(cv, s.c + i * N + n0);
#pragma unroll
      for (int e = 0; e < kCPT; ++e)
#pragma unroll
        for (int q = 0; q < SV; ++q) {
          h[e][q] = fmaf(at[i][e][q], h[e][q], dxv[e] * bv[q]);
          p[e][q] *= at[i][e][q];
          gl[e][q] = fmaf(p[e][q], cv[q] * dyv[e], gl[e][q]);
        }
    }
  }
#pragma unroll
  for (int e = 0; e < kCPT; ++e) {
    if (!live[e]) continue;
    const size_t el = (static_cast<size_t>(b) * n_seg + j) * plane + static_cast<size_t>(d[e]) * N + n0;
    if (j < n_seg - 1) vstore<SV>(h_slot + el, h[e]);
    if (j >= 1) vstore<SV>(g_slot + el, gl[e]);
    vstore<SV>(decay + el, p[e]);
  }
}

// 2. Block (channel block, j, b): segment j's gradients. ddt and dx (B, S,
// Di) in T; dh0 (segment 0); part_a (B, n_seg, Di, N) the segment's share
// of dA; part_bc (n_cb, B, S, 2N) the block's shares of dB (n < N) and dC.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssmb_output_kernel(const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ bm,
                   const T* __restrict__ cm, const float* __restrict__ a_log,
                   const float* __restrict__ h0, const float* __restrict__ dy,
                   const float* __restrict__ dh, T* __restrict__ ddt, T* __restrict__ dx,
                   const float* __restrict__ ck_h, const float* __restrict__ ck_p,
                   const float* __restrict__ h_slot, const float* __restrict__ g_slot,
                   const float* __restrict__ decay, float* __restrict__ dh0,
                   float* __restrict__ part_a, float* __restrict__ part_bc, int B, int S, int Di,
                   int n_seg, int seg_len) {
  using Ln = Lanes<N, kSV>;
  constexpr int NG = Ln::NG;
  static_assert(NG == 2 || NG == 4, "state size");
  __shared__ __align__(16) Staged<N, kSV> s;
  __shared__ __align__(16) float s_bc[kT][kWarps][2 * N];  // the warps' dB, dC sums
  __shared__ __align__(16) float s_g[kT][Ln::CH][2];       // each channel's g B and g h a A sums
  __shared__ __align__(16) float s_ck[kThreads * kCkStride];  // each thread's next checkpoint

  const int j = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * Ln::CH, ng = tid % NG, cp = tid / NG, n0 = ng * kSV;
  const int d[kCPT] = {d0 + 2 * cp, d0 + 2 * cp + 1};
  const bool live[kCPT] = {d[0] < Di, d[1] < Di};  // the lanes past Di join the shuffles with zeros
  const int s0 = j * seg_len, s1 = min(S, s0 + seg_len), n_chunk = (S + kT - 1) / kT;
  const size_t row0 = static_cast<size_t>(b) * S, plane = static_cast<size_t>(Di) * N;

  float a[kCPT][kSV], a2[kCPT][kSV], hs[kCPT][kSV], G[kCPT][kSV], dA[kCPT][kSV];
  rates<N, kSV>(a, a2, a_log, d, live, n0);
  // the carry: the segment's true start state hs and end adjoint G
#pragma unroll
  for (int e = 0; e < kCPT; ++e) {
#pragma unroll
    for (int q = 0; q < kSV; ++q) hs[e][q] = G[e][q] = dA[e][q] = 0.f;
    if (!live[e]) continue;
    const size_t el = static_cast<size_t>(d[e]) * N + n0;
    if (h0 != nullptr) vload<kSV>(hs[e], h0 + b * plane + el);
    for (int i = 0; i < j; ++i) {
      float dc[kSV], hl[kSV];
      const size_t o = (static_cast<size_t>(b) * n_seg + i) * plane + el;
      vload<kSV>(dc, decay + o);
      vload<kSV>(hl, h_slot + o);
#pragma unroll
      for (int q = 0; q < kSV; ++q) hs[e][q] = fmaf(dc[q], hs[e][q], hl[q]);
    }
    if (dh != nullptr) vload<kSV>(G[e], dh + b * plane + el);
    for (int i = n_seg - 1; i > j; --i) {
      float dc[kSV], gl[kSV];
      const size_t o = (static_cast<size_t>(b) * n_seg + i) * plane + el;
      vload<kSV>(dc, decay + o);
      vload<kSV>(gl, g_slot + o);
#pragma unroll
      for (int q = 0; q < kSV; ++q) G[e][q] = fmaf(dc[q], G[e][q], gl[q]);
    }
  }

  Prefetch<T, N, kSV> pf;
  // a chunk's checkpoint (the product of the a's from the segment's start,
  // then the local state, of each channel) copied into this thread's slot
  // of shared memory a chunk ahead
  float* ck = s_ck + tid * kCkStride;
  auto fetch_ck = [&](int qc) {
#pragma unroll
    for (int e = 0; e < kCPT; ++e)
      if (live[e]) {
        const size_t o = (static_cast<size_t>(b) * n_chunk + qc) * plane +
                         static_cast<size_t>(d[e]) * N + n0;
        cp_async16(ck + 8 * e, ck_p + o, 16);
        cp_async16(ck + 8 * e + 4, ck_h + o, 16);
      }
    cp_async_commit();
  };
  const int q_first = s0 / kT, q_last = (s1 - 1) / kT;
  pf.load(dt, x, bm, cm, dy, row0, q_last * kT, s1 - q_last * kT, Di, d0, tid);
  if (q_last > q_first) fetch_ck(q_last);
  for (int qc = q_last; qc >= q_first; --qc) {
    const int t0 = qc * kT, tc = min(kT, s1 - t0);
    __syncthreads();  // the previous chunk is done with the staged inputs and sums
    pf.stage(s, tid);
    // the chunk's start state: the segment's, or its decay times it plus the
    // chunk's local state
    float h[kCPT][kSV];
    if (qc > q_first) cp_async_wait<0>();
#pragma unroll
    for (int e = 0; e < kCPT; ++e) {
#pragma unroll
      for (int q = 0; q < kSV; ++q) h[e][q] = hs[e][q];
      if (qc > q_first && live[e]) {
        float pc[kSV], hl[kSV];
        vload<kSV>(pc, ck + 8 * e);
        vload<kSV>(hl, ck + 8 * e + 4);
#pragma unroll
        for (int q = 0; q < kSV; ++q) h[e][q] = fmaf(pc[q], hs[e][q], hl[q]);
      }
    }
    __syncthreads();
    if (qc > q_first) pf.load(dt, x, bm, cm, dy, row0, (qc - 1) * kT, kT, Di, d0, tid);
    if (qc - 1 > q_first) fetch_ck(qc - 1);  // this thread has read its slot
    // the walk forward: each step's a_t first (they do not depend on the
    // state), then h_{t-1} of each step kept; steps past tc: dt = 0, so a =
    // 1 and h stays
    float hp[kT][kCPT][kSV], av[kT][kCPT][kSV];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const float4 dd = ld4(s.d + (i * Ln::CP + cp) * 4);
      const float dtv[kCPT] = {dd.x, dd.z};
#pragma unroll
      for (int e = 0; e < kCPT; ++e)
#pragma unroll
        for (int q = 0; q < kSV; ++q) av[i][e][q] = ex2(dtv[e] * a2[e][q]);
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const float4 dd = ld4(s.d + (i * Ln::CP + cp) * 4);
      const float4 b4 = ld4(s.b + i * N + n0);
      const float dxv[kCPT] = {dd.x * dd.y, dd.z * dd.w};
      const float bv[kSV] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int e = 0; e < kCPT; ++e)
#pragma unroll
        for (int q = 0; q < kSV; ++q) {
          hp[i][e][q] = h[e][q];
          h[e][q] = fmaf(av[i][e][q], h[e][q], dxv[e] * bv[q]);
        }
    }
    // the walk back; G is the adjoint reaching h_t from later steps
#pragma unroll
    for (int i = kT - 1; i >= 0; --i) {
      const float4 dd = ld4(s.d + (i * Ln::CP + cp) * 4);
      const float4 b4 = ld4(s.b + i * N + n0), c4 = ld4(s.c + i * N + n0);
      const float2 y2 = *reinterpret_cast<const float2*>(s.y + (i * Ln::CP + cp) * 2);
      const float dtv[kCPT] = {dd.x, dd.z}, dxv[kCPT] = {dd.x * dd.y, dd.z * dd.w};
      const float dyv[kCPT] = {y2.x, y2.y};
      const float bv[kSV] = {b4.x, b4.y, b4.z, b4.w}, cv[kSV] = {c4.x, c4.y, c4.z, c4.w};
      float v[2 * kSV];  // dB[n0 ..], dC[n0 ..] over this thread's channels
      float w4[2 * kCPT] = {0.f, 0.f, 0.f, 0.f};  // g B, g h a A of each channel
#pragma unroll
      for (int q = 0; q < 2 * kSV; ++q) v[q] = 0.f;
#pragma unroll
      for (int e = 0; e < kCPT; ++e)
#pragma unroll
        for (int q = 0; q < kSV; ++q) {
          const float ht = i == kT - 1 ? h[e][q] : hp[i + 1 < kT ? i + 1 : i][e][q];
          const float g = fmaf(cv[q], dyv[e], G[e][q]);  // dL/dh_t
          const float gdecay = g * hp[i][e][q] * av[i][e][q];  // dL/d(dt A)
          v[q] = fmaf(g, dxv[e], v[q]);
          v[kSV + q] = fmaf(dyv[e], ht, v[kSV + q]);
          w4[2 * e] = fmaf(g, bv[q], w4[2 * e]);
          w4[2 * e + 1] = fmaf(gdecay, a[e][q], w4[2 * e + 1]);
          dA[e][q] = fmaf(gdecay, dtv[e], dA[e][q]);
          G[e][q] = av[i][e][q] * g;
        }
      // dB, dC: the warp's channel pairs (lanes of one ng) by a transpose-
      // reduce; each lane ends with the sum of value 4 b4 + 2 b3 + b2 (bits
      // of the lane)
#pragma unroll
      for (int m = 16, c = 2 * kSV; m >= NG; m >>= 1) {
        if (c > 1) {
          const bool up = (lane & m) != 0;
#pragma unroll
          for (int jj = 0; jj < c / 2; ++jj) {
            const float send = up ? v[jj] : v[jj + c / 2], keep = up ? v[jj + c / 2] : v[jj];
            v[jj] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
          c /= 2;
        } else {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
        }
      }
      if ((lane & 3 & ~(NG - 1)) == 0) {
        const int vi = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
        s_bc[i][warp][(vi >> 2) * N + n0 + (vi & 3)] = v[0];
      }
      // g B and g h a A: a channel pair's NG lanes by a transpose-reduce
      if constexpr (NG == 4) {
        const bool up1 = (lane & 2) != 0, up0 = (lane & 1) != 0;
        float x0 = (up1 ? w4[0] : w4[2]), x1 = (up1 ? w4[1] : w4[3]);
        float k0 = (up1 ? w4[2] : w4[0]) + __shfl_xor_sync(0xffffffffu, x0, 2);
        float k1 = (up1 ? w4[3] : w4[1]) + __shfl_xor_sync(0xffffffffu, x1, 2);
        const float sum = (up0 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, up0 ? k0 : k1, 1);
        s_g[i][2 * cp + (up1 ? 1 : 0)][up0 ? 1 : 0] = sum;
      } else {
        const bool up0 = (lane & 1) != 0;
        const float x0 = up0 ? w4[0] : w4[2], x1 = up0 ? w4[1] : w4[3];
        const float k0 = (up0 ? w4[2] : w4[0]) + __shfl_xor_sync(0xffffffffu, x0, 1);
        const float k1 = (up0 ? w4[3] : w4[1]) + __shfl_xor_sync(0xffffffffu, x1, 1);
        s_g[i][2 * cp + (up0 ? 1 : 0)][0] = k0;
        s_g[i][2 * cp + (up0 ? 1 : 0)][1] = k1;
      }
    }
    __syncthreads();
    // ddt and dx of the chunk's steps
    for (int e = tid; e < tc * Ln::CH; e += kThreads) {
      const int i = e / Ln::CH, ch = e % Ln::CH;
      if (d0 + ch >= Di) continue;
      const float2 dxp = *reinterpret_cast<const float2*>(s.d + (i * Ln::CP + ch / 2) * 4 + (ch % 2) * 2);
      const size_t o = (row0 + t0 + i) * Di + d0 + ch;
      ddt[o] = from_f32<T>(fmaf(dxp.y, s_g[i][ch][0], s_g[i][ch][1]));
      dx[o] = from_f32<T>(dxp.x * s_g[i][ch][0]);
    }
    // the block's dB and dC: the warps' sums added in warp order
    for (int e = tid; e < tc * 2 * N; e += kThreads) {
      const int i = e / (2 * N), n2 = e % (2 * N);
      float acc = s_bc[i][0][n2];
#pragma unroll
      for (int wv = 1; wv < kWarps; ++wv) acc += s_bc[i][wv][n2];
      part_bc[((static_cast<size_t>(blockIdx.x) * B + b) * S + t0 + i) * 2 * N + n2] = acc;
    }
  }
#pragma unroll
  for (int e = 0; e < kCPT; ++e) {
    if (!live[e]) continue;
    const size_t el = static_cast<size_t>(d[e]) * N + n0;
    if (j == 0) vstore<kSV>(dh0 + b * plane + el, G[e]);
    vstore<kSV>(part_a + (static_cast<size_t>(b) * n_seg + j) * plane + el, dA[e]);
  }
}

// 3. dB and dC (B, S, N) in T: the n_cb channel blocks' partials added in
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
                     float* ck_h, float* ck_p, float* h_slot, float* g_slot, float* decay,
                     float* part_a, float* part_bc, int B, int S, int Di, int n_seg, int seg_len,
                     cudaStream_t stream) {
  const T* dt = static_cast<const T*>(dt_);
  const T* x = static_cast<const T*>(x_);
  const T* bm = static_cast<const T*>(bm_);
  const T* cm = static_cast<const T*>(cm_);
  const int n_cb = (Di + Lanes<N, kSV>::CH - 1) / Lanes<N, kSV>::CH;
  const int n_cb_local = (Di + Lanes<N, kSVL>::CH - 1) / Lanes<N, kSVL>::CH;
  const dim3 grid(n_cb, n_seg, B);
  cudaError_t err;
  if (S > kT) {  // more than one chunk: checkpoints (and, with n_seg > 1, slots)
    ssmb_local_kernel<T, N><<<dim3(n_cb_local, n_seg, B), kThreads, 0, stream>>>(
        dt, x, bm, cm, a_log, dy, ck_h, ck_p, h_slot, g_slot, decay, S, Di, n_seg, seg_len);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssmb_output_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      dt, x, bm, cm, a_log, h0, dy, dh, static_cast<T*>(ddt), static_cast<T*>(dx), ck_h, ck_p,
      h_slot, g_slot, decay, dh0, part_a, part_bc, B, S, Di, n_seg, seg_len);
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
                   float* ck_h, float* ck_p, float* h_slot, float* g_slot, float* decay,
                   float* part_a, float* part_bc, int B, int S, int Di, int N, int n_seg,
                   int seg_len, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0) return cudaErrorInvalidValue;
  // whole chunks a segment; the segments cover S exactly once, none empty
  if (n_seg < 1 || n_seg > 65535 || seg_len < kT || seg_len % kT != 0 ||
      static_cast<long long>(n_seg - 1) * seg_len >= S ||
      static_cast<long long>(n_seg) * seg_len < S)
    return cudaErrorInvalidValue;
  if (N == 16)
    return launch_n<T, 16>(dt, x, bm, cm, a_log, h0, dy, dh, ddt, dx, dbm, dcm, da_log, dh0, ck_h,
                           ck_p, h_slot, g_slot, decay, part_a, part_bc, B, S, Di, n_seg,
                           seg_len, stream);
  if (N == 8)
    return launch_n<T, 8>(dt, x, bm, cm, a_log, h0, dy, dh, ddt, dx, dbm, dcm, da_log, dh0, ck_h,
                          ck_p, h_slot, g_slot, decay, part_a, part_bc, B, S, Di, n_seg, seg_len,
                          stream);
  return cudaErrorInvalidValue;
}

template <typename T>
int output_blocks_per_sm(int N) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (N == 16)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssmb_output_kernel<T, 16>, kThreads,
                                                        0);
  if (N == 8)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssmb_output_kernel<T, 8>, kThreads,
                                                        0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Output-pass blocks one SM holds at once (the wrapper's segment rule fills
// one wave of them); a cudaError_t, negated, on failure.
int ssmb_output_blocks_per_sm(int dtype, int N) {
  if (dtype == kF32) return output_blocks_per_sm<float>(N);
  if (dtype == kBF16) return output_blocks_per_sm<__nv_bfloat16>(N);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Returns the cudaError_t of the launches (0 on success). dt, x, B, C and
// the gradients ddt, dx, dbm, dcm share one dtype (0: f32, 1: bf16);
// a_log, dy, da_log and the states are f32; h0 and dh may be null (zero).
// The time axis runs as n_seg segments of seg_len steps (a multiple of 8;
// the last may be shorter). The scratch, f32: ck_h and ck_p (B, n_chunk,
// Di, N) with n_chunk = ceil(S / 8), h_slot, g_slot and decay (B, n_seg,
// Di, N), part_a (B, n_seg, Di, N) and part_bc (n_cb, B, S, 2N) with n_cb =
// ceil(Di / (512 / N)).
int ssmb_selective_scan_backward(int dtype, const void* dt, const void* x, const void* bm,
                                 const void* cm, const float* a_log, const float* h0,
                                 const float* dy, const float* dh, void* ddt, void* dx,
                                 void* dbm, void* dcm, float* da_log, float* dh0, float* ck_h,
                                 float* ck_p, float* h_slot, float* g_slot, float* decay,
                                 float* part_a, float* part_bc, int B, int S, int Di, int N,
                                 int n_seg, int seg_len, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float>(dt, x, bm, cm, a_log, h0, dy, dh, ddt, dx, dbm, dcm,
                                            da_log, dh0, ck_h, ck_p, h_slot, g_slot, decay,
                                            part_a, part_bc, B, S, Di, N, n_seg, seg_len, st));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(dt, x, bm, cm, a_log, h0, dy, dh, ddt, dx,
                                                     dbm, dcm, da_log, dh0, ck_h, ck_p, h_slot,
                                                     g_slot, decay, part_a, part_bc, B, S, Di, N,
                                                     n_seg, seg_len, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
