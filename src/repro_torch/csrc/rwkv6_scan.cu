// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes). Built by
// repro_torch/kernels/_build.py. It backs every WKV recurrence of the dense
// backend's RWKV-6 stacks: the whole-prompt prefill and each decode step.
//
// rwkv6_chunked
//   Replaces the Pallas kernel repro/kernels/rwkv6_scan.py::rwkv6_chunked
//   (body _wkv_kernel). Per batch row b and head h, with a (hd x hd) state S
//   (key index k, value index v) carried from state0 (zero when absent):
//     y_t[v] = sum_k r_t[k] * (S[k,v] + u[k] * k_t[k] * v_t[v])
//     S[k,v] <- w_t[k] * S[k,v] + k_t[k] * v_t[v]
//   r, k, v (B, S, H, hd) in f32 or bf16; w (B, S, H, hd) f32 in (0, 1);
//   u (H, hd) f32; y (B, S, H, hd) and the final state (B, H, hd, hd) f32.
//   hd is 32 or 64; any S >= 1.
//   The contract is the sequential recurrence (repro/kernels/ref.py::
//   rwkv6_ref), not the Pallas kernel's chunked form: that form divides by
//   a running product of decays, which underflows to 0 in f32 for strong
//   decays, and it ignores state0. Nothing here divides, so the kernel
//   stays finite for any w in (0, 1).
//   Bound on the H100: operations at prefill (5 f32 operations per state
//   element per step: the y product 2, the decay and the k v^T update 3),
//   bytes at decode (S = 1: the f32 state is read and written once, 8.4 MB
//   at B = 8).
//
//   Design. One sequential loop per (row, head) left 4-16 warps an SM at
//   B = 1. The time axis is now cut into n_seg segments of seg_len steps
//   (the wrapper's wkv_segments: as many as one wave of the output pass
//   holds, 8 of 256 steps at B 1, H 64, S 2048 on the H100). Two launches:
//   1. wkv_segment_kernel, segments 0 .. n_seg - 2: each segment's end
//      state from a zero state (segment 0 from state0, which it also copies
//      to the scratch) and its decay D = prod_t w_t, chunk by chunk in the
//      form S_c' = diag(prod_t w_t) S_c + K~^T V with K~_t = k_t * prod_{s >
//      t} w_s. The product K~^T V runs on the tensor cores in split tf32
//      (K~ = hi + lo, both tf32; (hi + lo) V less the lo-lo term, V split as
//      well when it is f32: bf16 V is exact in tf32), each warp holding 16
//      keys of the state as m16n8 accumulators; one thread per key scales
//      k by the decays as it stages the chunk.
//   2. wkv_output_kernel, every segment: the carry first, S_start[j] =
//      D[j-1] * S_start[j-1] + S_loc[j-1] from segment 0's end state (at
//      most n_seg - 2 FMAs an element, from L2), then the sequential
//      recurrence over the segment with y on CUDA cores, as the one-loop
//      kernel ran it (the f32 contract rules out TF32 for a step-by-step
//      product). A thread holds an 8-key x 4-column tile of the state in
//      registers, so one set of 16-byte shared loads of r, k, w and v feeds
//      32 elements. Time runs in chunks of 16 steps: r, k, w and v staged in
//      shared memory as f32, the next chunk's loads in flight in registers;
//      each step leaves a thread's partial sums of y_t over its 8 keys in
//      shared memory and goes on, and a pass after the chunk adds the 8 key
//      groups' partials and v_t * bonus_t.
//   Every decay factor either pass uses is a product of w's, so it can only
//   underflow to 0, the right value. Each state element sees the sequential
//   form's operations in the output pass; the segment pass and the carry
//   regroup the sums.
//   Decode (n_seg = 1, S <= 16): wkv_direct_kernel reads r, k, w and v of
//   each step straight from global memory (no staging), the state once
//   with 16-byte loads, and sums y through shared memory, one barrier a
//   step.
//   Only the segment pass reads state0 (or, with one segment, the thread
//   that also writes the element), and only the last segment writes
//   state_out, so state_out may be state0 itself: the decode step updates
//   the cache's state slice in place.
#include "scan_common.cuh"
#include "tf32_mma.cuh"

namespace {

using scan::ld4;
using scan::st4;
using scan::to_f32;
using scan::Vec4;
using tf32::mma;
using tf32::split;

constexpr int kKT = 8;          // keys of a thread's state tile (output pass, decode)
constexpr int kVT = 4;          // value columns of a thread's state tile
constexpr int kT = 16;          // time steps per staged chunk (both passes)
constexpr int kDirectMax = 16;  // one segment of at most this many steps: the direct kernel

enum DType { kF32 = 0, kBF16 = 1 };

// Eight consecutive f32 values of a row (shared or global), 16-byte aligned.
__device__ __forceinline__ void ld8(float (&d)[kKT], const float* p) {
  const float4 a = ld4(p), b = ld4(p + 4);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

// ---------------------------------------------------------------------------
// 1. the segment pass: chunks of K~^T V on the tensor cores, in split tf32
// ---------------------------------------------------------------------------

// The segment pass's block: hd / 16 warps, each holding 16 keys (rows) of
// the (hd x hd) state as m16n8 accumulator fragments. Shared memory, in
// floats (rows padded so that the fragment loads and the per-key walks meet
// 32 different banks): k and w (t, key), V (t, column), K~^T (key, t) and
// the chunk's decay of each key.
template <int HD>
struct SegLayout {
  static constexpr int NW = HD / 16;          // warps
  static constexpr int NT = 32 * NW;          // threads: 2 hd
  static constexpr int NN = HD / 8;           // n8 tiles of a warp's state rows
  static constexpr int RS = HD + 4;           // rows of k, w
  static constexpr int BS = HD + 8;           // rows of V
  static constexpr int KTS = kT + 4;          // rows of K~^T
  static constexpr int G4 = kT * HD / 4 / NT; // float4 groups a thread stages per array
  static constexpr int SK = 0, SW = kT * RS, SV = 2 * kT * RS, SKT = SV + kT * BS;
  static constexpr int SPA = SKT + HD * KTS;
  static constexpr int FLOATS = SPA + HD;
  static_assert(G4 >= 1 && NT == 2 * HD && kT % 8 == 0, "unsupported head_dim");
};

// Block (j, h, b), j < n_seg - 1: the end state of segment j from a zero
// state (j = 0: from state0, which it copies to slot 0) into seg_state
// slot j + 1 of (b, h), and the segment's decay prod_t w_t into
// seg_decay[(b, h, j)]. seg_state is (B, H, n_seg, HD, HD), seg_decay (B, H,
// n_seg, HD). Per chunk of kT steps, with S_c the state at its start:
//   S_c' = diag(prod_t w_t) S_c + K~^T V,  K~_t = k_t * prod_{s > t} w_s,
// the decays products of w's in (0, 1) and the product on the tensor cores
// as (K~_hi + K~_lo) (V_hi + V_lo) less the lo-lo term (bf16 V is exact
// in tf32: two products; f32 V: three).
template <typename T, int HD>
__global__ void __launch_bounds__(SegLayout<HD>::NT)
wkv_segment_kernel(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
                   const float* state0, float* seg_state, float* __restrict__ seg_decay, int S,
                   int H, int n_seg, int seg_len) {
  using C = SegLayout<HD>;
  using V4 = Vec4<T>;
  __shared__ __align__(16) float smem[C::FLOATS];
  float* sk = smem + C::SK;
  float* sw = smem + C::SW;
  float* sv = smem + C::SV;
  float* skt = smem + C::SKT;
  float* spa = smem + C::SPA;

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int s0 = j * seg_len, s1 = min(S, s0 + seg_len);
  const size_t row = static_cast<size_t>(H) * HD;  // one time step
  const size_t head_off = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * HD;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t mat = static_cast<size_t>(HD) * HD;
  float* slots = seg_state + bh * n_seg * mat;
  const int k0 = 16 * wp + g, k1 = k0 + 8;  // the thread's two state rows (keys)

  // the state: rows k0 (fragment elements 0, 1) and k1 (2, 3) of columns
  // 8 n + 2 t4 and + 1
  float st[C::NN][4];
#pragma unroll
  for (int n = 0; n < C::NN; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
  if (j == 0 && state0 != nullptr) {
#pragma unroll
    for (int n = 0; n < C::NN; ++n) {
      const float* m = state0 + bh * mat + 8 * n + 2 * t4;
      const float2 a = *reinterpret_cast<const float2*>(m + k0 * HD);
      const float2 c = *reinterpret_cast<const float2*>(m + k1 * HD);
      st[n][0] = a.x; st[n][1] = a.y; st[n][2] = c.x; st[n][3] = c.y;
      *reinterpret_cast<float2*>(slots + k0 * HD + 8 * n + 2 * t4) = a;  // slot 0
      *reinterpret_cast<float2*>(slots + k1 * HD + 8 * n + 2 * t4) = c;
    }
  }

  // the next chunk's k, w and v in registers: k and v zero and w one past
  // the segment
  typename V4::Raw pk[C::G4], pv[C::G4];
  float4 pw[C::G4];
  auto fetch = [&](int t0, int tc) {
#pragma unroll
    for (int i = 0; i < C::G4; ++i) {
      const int gi = tid + i * C::NT, t = gi / (HD / 4), c4 = (gi % (HD / 4)) * 4;
      pk[i] = pv[i] = typename V4::Raw{};
      pw[i] = make_float4(1.f, 1.f, 1.f, 1.f);
      if (t < tc) {
        const size_t off = head_off + static_cast<size_t>(t0 + t) * row + c4;
        pk[i] = V4::load(k + off);
        pv[i] = V4::load(v + off);
        pw[i] = ld4(w + off);
      }
    }
  };

  float dseg = 1.f;  // key (tid - HD)'s decay over the segment
  fetch(s0, min(kT, s1 - s0));
  for (int t0 = s0; t0 < s1; t0 += kT) {
    __syncthreads();  // the previous chunk's products are done with shared memory
#pragma unroll
    for (int i = 0; i < C::G4; ++i) {
      const int gi = tid + i * C::NT, t = gi / (HD / 4), c4 = (gi % (HD / 4)) * 4;
      st4(sk + t * C::RS + c4, V4::widen(pk[i]));
      st4(sw + t * C::RS + c4, pw[i]);
      st4(sv + t * C::BS + c4, V4::widen(pv[i]));
    }
    __syncthreads();
    if (t0 + kT < s1) fetch(t0 + kT, min(kT, s1 - t0 - kT));  // in flight during the chunk
    if (tid >= HD) {  // key tid - HD: K~ backward over the chunk, and its decay
      const int key = tid - HD;
      float q = 1.f;
#pragma unroll
      for (int t = kT - 1; t >= 0; --t) {
        skt[key * C::KTS + t] = sk[t * C::RS + key] * q;
        q *= sw[t * C::RS + key];
      }
      spa[key] = q;
      dseg *= q;
    }
    __syncthreads();
    // S_c <- diag(D_chunk) S_c + K~^T V: this warp's 16 keys
    const float d0 = spa[k0], d1 = spa[k1];
#pragma unroll
    for (int n = 0; n < C::NN; ++n) {
      st[n][0] *= d0; st[n][1] *= d0; st[n][2] *= d1; st[n][3] *= d1;
    }
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      uint32_t ah[4], al[4];
      split(skt[k0 * C::KTS + 8 * kk + t4], ah[0], al[0]);
      split(skt[k1 * C::KTS + 8 * kk + t4], ah[1], al[1]);
      split(skt[k0 * C::KTS + 8 * kk + t4 + 4], ah[2], al[2]);
      split(skt[k1 * C::KTS + 8 * kk + t4 + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < C::NN; ++n) {
        const float x0 = sv[(8 * kk + t4) * C::BS + 8 * n + g];
        const float x1 = sv[(8 * kk + t4 + 4) * C::BS + 8 * n + g];
        if constexpr (sizeof(T) == 2) {
          mma(st[n], al, __float_as_uint(x0), __float_as_uint(x1));
          mma(st[n], ah, __float_as_uint(x0), __float_as_uint(x1));
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split(x0, bh0, bl0);
          split(x1, bh1, bl1);
          mma(st[n], al, bh0, bh1);
          mma(st[n], ah, bl0, bl1);
          mma(st[n], ah, bh0, bh1);
        }
      }
    }
  }

  float* out = slots + static_cast<size_t>(j + 1) * mat;
#pragma unroll
  for (int n = 0; n < C::NN; ++n) {
    *reinterpret_cast<float2*>(out + k0 * HD + 8 * n + 2 * t4) = make_float2(st[n][0], st[n][1]);
    *reinterpret_cast<float2*>(out + k1 * HD + 8 * n + 2 * t4) = make_float2(st[n][2], st[n][3]);
  }
  if (tid >= HD) seg_decay[(bh * n_seg + j) * HD + tid - HD] = dseg;
}

// ---------------------------------------------------------------------------
// 2. the output pass: the recurrence on CUDA cores
// ---------------------------------------------------------------------------

// A block's threads: thread tid holds keys kq * 8 .. + 7 and value columns
// vq * 4 .. + 3, vq = tid % NVQ (a warp's 32 lanes: 16 column groups of two
// key groups at hd 64, so its state rows are 64-byte runs and its loads of
// r, k and w broadcast).
template <int HD>
struct Tile {
  static constexpr int NKQ = HD / kKT;   // key groups
  static constexpr int NVQ = HD / kVT;   // column groups
  static constexpr int NT = NKQ * NVQ;   // threads: 128 at hd 64, 32 at hd 32
};

// The thread's tile of a row-major (HD x HD) matrix.
template <int HD>
__device__ __forceinline__ void load_tile(float (&s)[kKT][kVT], const float* m, int kq, int vq) {
#pragma unroll
  for (int i = 0; i < kKT; ++i) {
    const float4 x = ld4(m + (kq * kKT + i) * HD + vq * kVT);
    s[i][0] = x.x; s[i][1] = x.y; s[i][2] = x.z; s[i][3] = x.w;
  }
}
template <int HD>
__device__ __forceinline__ void store_tile(float* m, const float (&s)[kKT][kVT], int kq, int vq) {
#pragma unroll
  for (int i = 0; i < kKT; ++i)
    st4(m + (kq * kKT + i) * HD + vq * kVT, make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
}

template <int HD>
struct OutLayout {
  using L = Tile<HD>;
  static constexpr int RG = kT * HD / 4 / L::NT;  // float4 groups a thread stages per array
  static constexpr int BT = L::NT / kT;           // bonus: threads per step
  static constexpr int BK = HD / BT;              // bonus: keys per thread
  static_assert(RG >= 1 && BK % 4 == 0 && L::NT % kT == 0, "unsupported head_dim");
  // dynamic shared memory, in floats: r, k, w, v (t, key or column), the
  // bonus (t), and the partial sums of y (t, key group, column)
  static constexpr int SR = 0, SK = kT * HD, SW = 2 * kT * HD, SV = 3 * kT * HD;
  static constexpr int SB = 4 * kT * HD, SY = SB + kT;
  static constexpr int FLOATS = SY + kT * L::NKQ * HD;
  static constexpr int BYTES = FLOATS * static_cast<int>(sizeof(float));
};

// Block (j, h, b): segment j of (b, h) from its true start state, writing y
// (and, for the last segment, the final state). Segment 0 starts from
// init[(b, h) * init_stride] (zero when init is null); segment j >= 1 from
// the carry over seg_state and seg_decay.
template <typename T, int HD>
__global__ void __launch_bounds__(Tile<HD>::NT)
wkv_output_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u, const float* init,
                  size_t init_stride, const float* __restrict__ seg_state,
                  const float* __restrict__ seg_decay, float* __restrict__ y, float* state_out,
                  int S, int H, int n_seg, int seg_len) {
  using L = Tile<HD>;
  using O = OutLayout<HD>;
  using V4 = Vec4<T>;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem + O::SR;
  float* sk = smem + O::SK;
  float* sw = smem + O::SW;
  float* sv = smem + O::SV;
  float* sb = smem + O::SB;
  float* sy = smem + O::SY;

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, vq = tid % L::NVQ, kq = tid / L::NVQ;
  const int s0 = j * seg_len, s1 = min(S, s0 + seg_len);
  const size_t row = static_cast<size_t>(H) * HD;
  const size_t head_off = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * HD;
  const size_t bh = static_cast<size_t>(b) * H + h;

  // the start state of segment j
  float s[kKT][kVT];
  if (j == 0) {
    if (init != nullptr) {
      load_tile<HD>(s, init + bh * init_stride, kq, vq);
    } else {
#pragma unroll
      for (int i = 0; i < kKT; ++i)
#pragma unroll
        for (int c = 0; c < kVT; ++c) s[i][c] = 0.f;
    }
  } else {  // the carry: S_start[j] = D[j-1] S_start[j-1] + S_loc[j-1], from slot 1
    const float* slots = seg_state + bh * n_seg * HD * HD;
    load_tile<HD>(s, slots + HD * HD, kq, vq);
    for (int i = 1; i < j; ++i) {
      float d[kKT], x[kKT][kVT];
      ld8(d, seg_decay + (bh * n_seg + i) * HD + kq * kKT);
      load_tile<HD>(x, slots + static_cast<size_t>(i + 1) * HD * HD, kq, vq);
#pragma unroll
      for (int a = 0; a < kKT; ++a)
#pragma unroll
        for (int c = 0; c < kVT; ++c) s[a][c] = fmaf(d[a], s[a][c], x[a][c]);
    }
  }

  // the bonus pass: thread (step tb, key group bg) sums keys bg*BK .. +BK-1
  const int tb = tid / O::BT, bg = tid % O::BT;
  float ub[O::BK];
#pragma unroll
  for (int i = 0; i < O::BK; ++i) ub[i] = u[h * HD + bg * O::BK + i];

  typename V4::Raw pr[O::RG], pk[O::RG], pv[O::RG];
  float4 pw[O::RG];
  auto fetch = [&](int t0, int tc) {  // steps t0 .. t0 + tc - 1 into registers
#pragma unroll
    for (int i = 0; i < O::RG; ++i) {
      const int g = tid + i * L::NT, t = g / (HD / 4);
      if (t < tc) {
        const size_t off = head_off + static_cast<size_t>(t0 + t) * row + (g % (HD / 4)) * 4;
        pr[i] = V4::load(r + off);
        pk[i] = V4::load(k + off);
        pv[i] = V4::load(v + off);
        pw[i] = ld4(w + off);
      }
    }
  };

  fetch(s0, min(kT, s1 - s0));
  for (int t0 = s0; t0 < s1; t0 += kT) {
    const int tc = min(kT, s1 - t0);
    __syncthreads();  // the previous chunk's y pass is done with shared memory
#pragma unroll
    for (int i = 0; i < O::RG; ++i) {
      const int g = tid + i * L::NT;  // (t, key) rows are contiguous
      if (g / (HD / 4) < tc) {
        st4(sr + g * 4, V4::widen(pr[i]));
        st4(sk + g * 4, V4::widen(pk[i]));
        st4(sv + g * 4, V4::widen(pv[i]));
        st4(sw + g * 4, pw[i]);
      }
    }
    __syncthreads();
    if (t0 + kT < s1) fetch(t0 + kT, min(kT, s1 - t0 - kT));  // in flight during the steps
    // bonus_t = sum_k r_t[k] u[k] k_t[k]: BT threads per step, BK keys each
    {
      float a = 0.f;
      if (tb < tc) {
#pragma unroll
        for (int i = 0; i < O::BK; i += 4) {
          const float4 r4 = ld4(sr + tb * HD + bg * O::BK + i);
          const float4 k4 = ld4(sk + tb * HD + bg * O::BK + i);
          a = fmaf(r4.x * k4.x, ub[i], a);
          a = fmaf(r4.y * k4.y, ub[i + 1], a);
          a = fmaf(r4.z * k4.z, ub[i + 2], a);
          a = fmaf(r4.w * k4.w, ub[i + 3], a);
        }
      }
#pragma unroll
      for (int m = 1; m < O::BT; m <<= 1) a += __shfl_xor_sync(0xffffffffu, a, m);
      if (bg == 0 && tb < tc) sb[tb] = a;
    }
    // the steps: y reads the state before the step's update
    const int ko = kq * kKT, vo = vq * kVT;
#pragma unroll 4
    for (int t = 0; t < tc; ++t) {
      float rt[kKT], kt[kKT], wt[kKT];
      ld8(rt, sr + t * HD + ko);
      ld8(kt, sk + t * HD + ko);
      ld8(wt, sw + t * HD + ko);
      const float4 v4 = ld4(sv + t * HD + vo);
      const float vt[kVT] = {v4.x, v4.y, v4.z, v4.w};
      float yp[kVT];
#pragma unroll
      for (int c = 0; c < kVT; ++c) {
        yp[c] = rt[0] * s[0][c];
#pragma unroll
        for (int i = 1; i < kKT; ++i) yp[c] = fmaf(rt[i], s[i][c], yp[c]);
      }
#pragma unroll
      for (int i = 0; i < kKT; ++i)
#pragma unroll
        for (int c = 0; c < kVT; ++c) s[i][c] = fmaf(s[i][c], wt[i], kt[i] * vt[c]);
      st4(sy + (t * L::NKQ + kq) * HD + vo, make_float4(yp[0], yp[1], yp[2], yp[3]));
    }
    __syncthreads();
    // y_t[v] = the key groups' partial sums + v_t[v] * bonus_t
    for (int e = tid; e < tc * (HD / 4); e += L::NT) {
      const int t = e / (HD / 4), c4 = (e % (HD / 4)) * 4;
      float4 a = ld4(sy + t * L::NKQ * HD + c4);
#pragma unroll
      for (int q = 1; q < L::NKQ; ++q) {
        const float4 p = ld4(sy + (t * L::NKQ + q) * HD + c4);
        a.x += p.x; a.y += p.y; a.z += p.z; a.w += p.w;
      }
      const float4 v4 = ld4(sv + t * HD + c4);
      const float bt = sb[t];
      st4(y + head_off + static_cast<size_t>(t0 + t) * row + c4,
          make_float4(fmaf(v4.x, bt, a.x), fmaf(v4.y, bt, a.y), fmaf(v4.z, bt, a.z),
                      fmaf(v4.w, bt, a.w)));
    }
  }
  if (j == n_seg - 1) store_tile<HD>(state_out + bh * HD * HD, s, kq, vq);
}

// ---------------------------------------------------------------------------
// decode: a few steps, no staging
// ---------------------------------------------------------------------------

// Block (h, b) runs steps 0 .. S - 1 of (b, h) with the output pass's tile:
// r, k, w and v straight from global memory, y summed over the key groups
// through shared memory (one barrier a step, two buffers).
template <typename T, int HD>
__global__ void __launch_bounds__(Tile<HD>::NT)
wkv_direct_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u, const float* state0,
                  float* __restrict__ y, float* state_out, int S, int H) {
  using L = Tile<HD>;
  using V4 = Vec4<T>;
  __shared__ __align__(16) float sy[2][L::NKQ * HD];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, vq = tid % L::NVQ, kq = tid / L::NVQ;
  const int ko = kq * kKT, vo = vq * kVT;
  const size_t row = static_cast<size_t>(H) * HD;
  const size_t head_off = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * HD;
  const size_t bh = static_cast<size_t>(b) * H + h;

  float s[kKT][kVT];
  if (state0 != nullptr) {
    load_tile<HD>(s, state0 + bh * HD * HD, kq, vq);
  } else {
#pragma unroll
    for (int i = 0; i < kKT; ++i)
#pragma unroll
      for (int c = 0; c < kVT; ++c) s[i][c] = 0.f;
  }
  float ut[kKT];
  ld8(ut, u + h * HD + ko);

  for (int t = 0; t < S; ++t) {
    const size_t off = head_off + static_cast<size_t>(t) * row;
    const float4 r0 = V4::widen(V4::load(r + off + ko)), r1 = V4::widen(V4::load(r + off + ko + 4));
    const float4 k0 = V4::widen(V4::load(k + off + ko)), k1 = V4::widen(V4::load(k + off + ko + 4));
    const float4 v4 = V4::widen(V4::load(v + off + vo));
    float wt[kKT];
    ld8(wt, w + off + ko);
    const float rt[kKT] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const float kt[kKT] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
    const float vt[kVT] = {v4.x, v4.y, v4.z, v4.w};
    // this key group's share of the bonus: sum over its keys of r u k
    float bonus = 0.f;
#pragma unroll
    for (int i = 0; i < kKT; ++i) bonus = fmaf(rt[i] * kt[i], ut[i], bonus);
    float yp[kVT];
#pragma unroll
    for (int c = 0; c < kVT; ++c) {
      yp[c] = vt[c] * bonus;
#pragma unroll
      for (int i = 0; i < kKT; ++i) yp[c] = fmaf(rt[i], s[i][c], yp[c]);
    }
#pragma unroll
    for (int i = 0; i < kKT; ++i)
#pragma unroll
      for (int c = 0; c < kVT; ++c) s[i][c] = fmaf(s[i][c], wt[i], kt[i] * vt[c]);
    float* buf = sy[t & 1];
    st4(buf + kq * HD + vo, make_float4(yp[0], yp[1], yp[2], yp[3]));
    __syncthreads();
    if (tid < HD / 4) {
      float4 a = ld4(buf + tid * 4);
#pragma unroll
      for (int q = 1; q < L::NKQ; ++q) {
        const float4 p = ld4(buf + q * HD + tid * 4);
        a.x += p.x; a.y += p.y; a.z += p.z; a.w += p.w;
      }
      st4(y + off + tid * 4, a);
    }
  }
  store_tile<HD>(state_out + bh * HD * HD, s, kq, vq);
}

template <typename T, int HD>
cudaError_t allow_output_smem() {  // above 48 KB dynamic shared memory must be allowed first
  if (OutLayout<HD>::BYTES <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(wkv_output_kernel<T, HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, OutLayout<HD>::BYTES);
}

template <typename T, int HD>
cudaError_t launch_wkv_hd(const void* r_, const void* k_, const void* v_, const float* w,
                          const float* u, const float* state0, float* y, float* state_out,
                          float* seg_state, float* seg_decay, int B, int S, int H, int n_seg,
                          int seg_len, cudaStream_t stream) {
  const T* r = static_cast<const T*>(r_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  if (n_seg == 1 && S <= kDirectMax) {
    wkv_direct_kernel<T, HD><<<dim3(H, B), Tile<HD>::NT, 0, stream>>>(r, k, v, w, u, state0, y,
                                                                        state_out, S, H);
    return cudaGetLastError();
  }
  const float* init = state0;
  size_t init_stride = static_cast<size_t>(HD) * HD;
  cudaError_t err;
  if (n_seg > 1) {
    if (seg_state == nullptr || seg_decay == nullptr) return cudaErrorInvalidValue;
    wkv_segment_kernel<T, HD><<<dim3(n_seg - 1, H, B), SegLayout<HD>::NT, 0, stream>>>(
        k, v, w, state0, seg_state, seg_decay, S, H, n_seg, seg_len);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    init = state0 != nullptr ? seg_state : nullptr;  // slot 0: the copy of state0
    init_stride *= n_seg;
  }
  if ((err = allow_output_smem<T, HD>()) != cudaSuccess) return err;
  wkv_output_kernel<T, HD><<<dim3(n_seg, H, B), Tile<HD>::NT, OutLayout<HD>::BYTES, stream>>>(
      r, k, v, w, u, init, init_stride, seg_state, seg_decay, y, state_out, S, H, n_seg,
      seg_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wkv(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* state0, float* y, float* state_out,
                       float* seg_state, float* seg_decay, int B, int S, int H, int hd,
                       int n_seg, int seg_len, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  // the segments cover S exactly once, none empty
  if (n_seg < 1 || n_seg > 65535 || seg_len < 1 ||
      static_cast<long long>(n_seg - 1) * seg_len >= S ||
      static_cast<long long>(n_seg) * seg_len < S)
    return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_wkv_hd<T, 64>(r, k, v, w, u, state0, y, state_out, seg_state, seg_decay, B,
                                S, H, n_seg, seg_len, stream);
  if (hd == 32)
    return launch_wkv_hd<T, 32>(r, k, v, w, u, state0, y, state_out, seg_state, seg_decay, B,
                                S, H, n_seg, seg_len, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int HD>
int output_blocks_per_sm_hd() {
  int n = 0;
  cudaError_t err = allow_output_smem<T, HD>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv_output_kernel<T, HD>,
                                                        Tile<HD>::NT, OutLayout<HD>::BYTES);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int output_blocks_per_sm(int hd) {
  if (hd == 64) return output_blocks_per_sm_hd<T, 64>();
  if (hd == 32) return output_blocks_per_sm_hd<T, 32>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Output-pass blocks one SM holds at once (the wrapper's segment rule fills
// one wave of them); a cudaError_t, negated, on failure.
int wkv_output_blocks_per_sm(int dtype, int hd) {
  if (dtype == kF32) return output_blocks_per_sm<float>(hd);
  if (dtype == kBF16) return output_blocks_per_sm<__nv_bfloat16>(hd);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Returns the cudaError_t of the launches (0 on success). r, k and v share
// one dtype (0: f32, 1: bf16); state0 may be null (a zero state) and may
// equal state_out (updated in place). The time axis runs as n_seg segments
// of seg_len steps (the last may be shorter); with n_seg > 1, seg_state
// (B, H, n_seg, hd, hd) and seg_decay (B, H, n_seg, hd) are f32 scratch.
int wkv_rwkv6(int dtype, const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* state0, float* y, float* state_out, float* seg_state,
              float* seg_decay, int B, int S, int H, int hd, int n_seg, int seg_len,
              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_wkv<float>(r, k, v, w, u, state0, y, state_out, seg_state,
                                                seg_decay, B, S, H, hd, n_seg, seg_len, st));
    case kBF16:
      return static_cast<int>(launch_wkv<__nv_bfloat16>(r, k, v, w, u, state0, y, state_out,
                                                        seg_state, seg_decay, B, S, H, hd,
                                                        n_seg, seg_len, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
