// Backward of the RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a), bound
// to PyTorch through a plain C interface (ctypes). Built by
// repro_torch/kernels/_build.py. It backs the backward of
// kernels.rwkv6_scan.WKV6, which models/rwkv6.py::apply_rwkv6 runs under
// grad: every time-mixing layer of an RWKV-6 stack in training.
//
// rwkv6_chunked_backward
//   Replaces no Pallas kernel: JAX differentiates the plain recurrence
//   (autodiff of repro/models/layers.py::chunked_scan over the step of
//   repro/models/rwkv6.py::wkv_scan; no JAX caller routes training through
//   its Pallas kernel). It computes that gradient: the exact gradient of
//   the sequential f32 recurrence of rwkv6_scan.cu, per (row b, head h),
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//   for the cotangents dy (B, S, H, hd) f32 and dstate of the final state
//   (B, H, hd, hd) f32 (null: zero). With the adjoint G_t = dL/dS_t, run
//   backward in time,
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   G_{S-1} = dstate,
//   and beta_t = v_t . dy_t, gamma_t = sum_k r_t u k_t:
//     dr_t = S_{t-1} dy_t + u k_t beta_t        dk_t = G_t v_t + r_t u beta_t
//     dv_t = G_t^T k_t + gamma_t dy_t           dw_t[k] = sum_v G_t[k,v] S_{t-1}[k,v]
//     du   = sum_{b,t} r_t k_t beta_t           dstate0 = G_{-1}.
//   r, k, v in f32 or bf16 (dr, dk, dv in the same dtype, computed in f32);
//   w, u, dw, du and the states f32. hd is 32 or 64; any S >= 1.
//   Bound on the H100: the f32 operations at 67 TFLOP/s (the contract's ~12
//   an element of the state and step: the state and the adjoint updates 2
//   each, the four sums over the state 2 each); the bytes (the inputs read
//   once, the gradients written once) are smaller.
//
//   Design. No state is ever walked backward by division: a decay w_t
//   underflows to 0 for a strong decay, and S_{t-1} is then lost from S_t.
//   Every decay factor below is a product of w's, which can only underflow
//   to 0, the right value. The time axis is cut into n_seg segments of
//   seg_len steps (the wrapper's wkv_backward_segments: as many as one wave
//   of the output pass holds), each a whole number of kT-step chunks. Within
//   a chunk, with S_c the state before it and G_e the adjoint after it, and
//   P_i, Q_i the decays from the chunk's start to step i and from step i to
//   its end (exclusive), W(i, l) those strictly between steps i and l, and
//   M[i, l] = v_i . dy_l, every gradient is a product of S_c or G_e with the
//   chunk's inputs plus sums that stay inside the chunk:
//     dr_i = P_i (S_c dy_i) + sum_{tau<i} W(tau,i) k_tau M[tau,i] + u k_i beta_i
//     dk_i = Q_i (G_e v_i) + sum_{l>i} W(i,l) r_l M[i,l] + r_i u beta_i
//     dv_i = G_e^T (Q_i k_i) + sum_{l>=i} A[i,l] dy_l,
//            A[i,l] = sum_k W(i,l) r_l k_i (l > i),  A[i,i] = gamma_i
//     dw_i = P_i Q_i rowsum(G_e * S_c) + Q_i sum_{tau<i} W(tau,i) k_tau (G_e v_tau)
//            + P_i sum_{l>i} W(i,l) r_l (S_c dy_l)
//            + sum_{tau<i<l} W(tau,i) W(i,l) k_tau r_l M[tau,l]
//   and the adjoint before the chunk is G_e' = diag(P_kT) G_e + sum_l (P_l r_l) dy_l^T.
//   So no step's state is ever kept: a chunk needs only S_c and G_e. Three
//   launches:
//   1. wkvb_local_kernel, 2 n_seg - 1 blocks per (head, row), side by side.
//      One per segment takes the segment's states from a zero state, chunk
//      by chunk as the forward's segment pass runs them (S' = diag(prod_t
//      w_t) S + K~^T V, K~_t = k_t prod_{s>t} w_s, on the tensor cores in
//      split tf32), written at every chunk start but the first (ck_state,
//      with the decay from the segment's start, ck_decay), and the segment's
//      end state and decay (s_slot, decay). One per segment >= 1 takes the
//      segment's adjoint from a zero adjoint at its end, chunk by chunk in
//      reverse (G_e' above, on the tensor cores), into g_slot.
//   2. wkvb_output_kernel, one block per (segment, head, row): the carry
//      first (the segment's true start state from state0 over the earlier
//      segments, its true end adjoint from dstate over the later ones, at
//      most n_seg - 1 FMAs an element each), then its chunks in reverse,
//      r, k, v, w and dy staged in shared memory as f32 with the next chunk's
//      loads in flight: S_c from the start state and the chunk's checkpoint;
//      S_c dY^T, G_e V^T and G_e^T (Q k) on the tensor cores in split tf32
//      (x = hi + lo, hi truncated to tf32: three products, two where bf16 v
//      is exact in tf32), a warp 16 rows, G held as m16n8 accumulators;
//      rowsum(G_e * S_c) from the registers; the sums inside the chunk by two
//      threads a key with their 16-wide vectors in registers, one walking
//      the chunk forward (dr, dw, du) and one back (dk, A's terms); A's sums
//      over the keys in a fixed order; dv; then G_e' on the tensor cores.
//   3. wkvb_du_kernel: du adds the (row, segment) shares in a fixed order.
//   Work: five multiply-adds an element of the state and step on the tensor
//   cores (the state's and the adjoint's chunk updates and the three
//   products of the output pass, each taken as two or three tf32 products);
//   on the CUDA cores two FMAs an element a chunk (the checkpoint and
//   rowsum(G_e * S_c)) and the walks, O(kT) an element of a key and step.
//   No atomics: every sum is taken in one order, so two calls give the same
//   bits.
#include "scan_common.cuh"
#include "tf32_mma.cuh"

namespace {

using scan::ld4;
using scan::st4;
using scan::to_f32;
using scan::Vec4;
using tf32::mma;
using tf32::split_trunc;

constexpr int kT = 16;                       // steps of a chunk (kernels.rwkv6_scan.BACKWARD_CHUNK)
constexpr int kPairs = kT * (kT + 1) / 2;    // (i, l >= i) pairs of a chunk

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// The blocks: hd / 16 warps, 2 hd threads. Warp wp holds rows 16 wp .. + 15
// of an (hd x hd) matrix as m16n8 accumulator fragments: rows k0 = 16 wp + g
// (elements 0, 1) and k1 = k0 + 8 (2, 3) of columns 8 n + 2 t4 and + 1.
template <int HD>
struct Frag {
  static constexpr int NW = HD / 16;          // warps
  static constexpr int NT = 32 * NW;          // threads: 2 hd
  static constexpr int NN = HD / 8;           // n8 tiles of a warp's rows
  static constexpr int G4 = kT * HD / 4 / NT; // float4 groups a thread stages per array
  static_assert(G4 >= 1 && NT == 2 * HD && kT % 8 == 0, "unsupported head_dim");
};

template <int HD>
__device__ __forceinline__ void frag_load(float (&f)[HD / 8][4], const float* m, int k0, int t4) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const float2 a = *reinterpret_cast<const float2*>(m + k0 * HD + 8 * n + 2 * t4);
    const float2 c = *reinterpret_cast<const float2*>(m + (k0 + 8) * HD + 8 * n + 2 * t4);
    f[n][0] = a.x; f[n][1] = a.y; f[n][2] = c.x; f[n][3] = c.y;
  }
}
template <int HD>
__device__ __forceinline__ void frag_store(float* m, const float (&f)[HD / 8][4], int k0, int t4,
                                           int stride) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(m + k0 * stride + 8 * n + 2 * t4) = make_float2(f[n][0], f[n][1]);
    *reinterpret_cast<float2*>(m + (k0 + 8) * stride + 8 * n + 2 * t4) =
        make_float2(f[n][2], f[n][3]);
  }
}
template <int HD>
__device__ __forceinline__ void frag_zero(float (&f)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) f[n][0] = f[n][1] = f[n][2] = f[n][3] = 0.f;
}
// f = diag(d) f + x, rows k0 and k0 + 8 scaled by d[k0], d[k0 + 8]
template <int HD>
__device__ __forceinline__ void frag_carry(float (&f)[HD / 8][4], const float* d, const float* x,
                                           int k0, int t4) {
  float m[HD / 8][4];
  frag_load<HD>(m, x, k0, t4);
  const float d0 = d[k0], d1 = d[k0 + 8];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    f[n][0] = fmaf(d0, f[n][0], m[n][0]);
    f[n][1] = fmaf(d0, f[n][1], m[n][1]);
    f[n][2] = fmaf(d1, f[n][2], m[n][2]);
    f[n][3] = fmaf(d1, f[n][3], m[n][3]);
  }
}

// ---------------------------------------------------------------------------
// 1. the segments' local states and adjoints, chunk by chunk
// ---------------------------------------------------------------------------

// Shared memory of the two local passes, in floats (rows padded so that the
// fragment loads and the per-key walks meet 32 different banks): the A
// side's two inputs (t, key), the B side's input (t, column), the A operand
// transposed (key, t) and each key's decay over the chunk.
template <int HD>
struct LocalLayout {
  static constexpr int RS = HD + 4;   // rows of the A side's inputs
  static constexpr int BS = HD + 8;   // rows of the B side's input
  static constexpr int KTS = kT + 4;  // rows of the A operand
  static constexpr int SA = 0, SW = kT * RS, SB = 2 * kT * RS, SAT = SB + kT * BS;
  static constexpr int SPA = SAT + HD * KTS;
  static constexpr int FLOATS = SPA + HD;
};

// Segment j of (b, h) from a zero state. At the start of each chunk but the
// first, the state so far into ck_state[(b, h, chunk)] and its decay into
// ck_decay[(b, h, chunk)]; at the end, for j < n_seg - 1, the state into
// s_slot[(b, h, j)]; and for every j the segment's decay into decay[(b, h,
// j)]. ck_state is (B, H, n_chunk, HD, HD), s_slot (B, H, n_seg, HD, HD).
template <typename T, int HD>
__device__ __forceinline__ void local_states(float* smem, int j, int h, int b,
                                             const T* __restrict__ k, const T* __restrict__ v,
                                             const float* __restrict__ w,
                                             float* __restrict__ ck_state,
                                             float* __restrict__ ck_decay,
                                             float* __restrict__ s_slot,
                                             float* __restrict__ decay, int S, int H, int n_seg,
                                             int seg_len) {
  using F = Frag<HD>;
  using C = LocalLayout<HD>;
  using V4 = Vec4<T>;
  float* sk = smem + C::SA;
  float* sw = smem + C::SW;
  float* sv = smem + C::SB;
  float* skt = smem + C::SAT;
  float* spa = smem + C::SPA;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int s0 = j * seg_len, s1 = min(S, s0 + seg_len), n_chunk = (S + kT - 1) / kT;
  const size_t row = static_cast<size_t>(H) * HD;
  const size_t head_off = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * HD;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t mat = static_cast<size_t>(HD) * HD;
  const int k0 = 16 * wp + g;

  float st[F::NN][4];
  frag_zero<HD>(st);
  typename V4::Raw pk[F::G4], pv[F::G4];
  float4 pw[F::G4];
  auto fetch = [&](int t0, int tc) {  // k and v zero, w one past tc
#pragma unroll
    for (int i = 0; i < F::G4; ++i) {
      const int gi = tid + i * F::NT, t = gi / (HD / 4), c4 = (gi % (HD / 4)) * 4;
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

  float dseg = 1.f;  // key (tid - HD)'s decay from the segment's start
  fetch(s0, min(kT, s1 - s0));
  for (int t0 = s0; t0 < s1; t0 += kT) {
    if (t0 > s0) {  // the checkpoint: the local state before this chunk
      const size_t q = bh * n_chunk + t0 / kT;
      frag_store<HD>(ck_state + q * mat, st, k0, t4, HD);
      if (tid >= HD) ck_decay[q * HD + tid - HD] = dseg;
    }
    __syncthreads();  // the previous chunk's products are done with shared memory
#pragma unroll
    for (int i = 0; i < F::G4; ++i) {
      const int gi = tid + i * F::NT, t = gi / (HD / 4), c4 = (gi % (HD / 4)) * 4;
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
    // S <- diag(D_chunk) S + K~^T V: this warp's 16 keys
    const float d0 = spa[k0], d1 = spa[k0 + 8];
#pragma unroll
    for (int n = 0; n < F::NN; ++n) {
      st[n][0] *= d0; st[n][1] *= d0; st[n][2] *= d1; st[n][3] *= d1;
    }
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_trunc(skt[k0 * C::KTS + 8 * kk + t4], ah[0], al[0]);
      split_trunc(skt[(k0 + 8) * C::KTS + 8 * kk + t4], ah[1], al[1]);
      split_trunc(skt[k0 * C::KTS + 8 * kk + t4 + 4], ah[2], al[2]);
      split_trunc(skt[(k0 + 8) * C::KTS + 8 * kk + t4 + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < F::NN; ++n) {
        const float x0 = sv[(8 * kk + t4) * C::BS + 8 * n + g];
        const float x1 = sv[(8 * kk + t4 + 4) * C::BS + 8 * n + g];
        if constexpr (sizeof(T) == 2) {  // bf16 v is exact in tf32
          mma(st[n], al, __float_as_uint(x0), __float_as_uint(x1));
          mma(st[n], ah, __float_as_uint(x0), __float_as_uint(x1));
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split_trunc(x0, bh0, bl0);
          split_trunc(x1, bh1, bl1);
          mma(st[n], al, bh0, bh1);
          mma(st[n], ah, bl0, bl1);
          mma(st[n], ah, bh0, bh1);
        }
      }
    }
  }
  if (j < n_seg - 1) frag_store<HD>(s_slot + (bh * n_seg + j) * mat, st, k0, t4, HD);
  if (tid >= HD) decay[(bh * n_seg + j) * HD + tid - HD] = dseg;
}

// Segment j >= 1 of (b, h): its adjoint before its first step from a zero
// adjoint after its last, G' = diag(prod_t w_t) G + R~^T dY with R~_t = r_t
// prod_{s<t} w_s over the chunks in reverse, into g_slot[(b, h, j)] (B, H,
// n_seg, HD, HD).
template <typename T, int HD>
__device__ __forceinline__ void local_adjoint(float* smem, int j, int h, int b,
                                              const T* __restrict__ r,
                                              const float* __restrict__ w,
                                              const float* __restrict__ dy,
                                              float* __restrict__ g_slot, int S, int H,
                                              int n_seg, int seg_len) {
  using F = Frag<HD>;
  using C = LocalLayout<HD>;
  using V4 = Vec4<T>;
  float* sr = smem + C::SA;
  float* sw = smem + C::SW;
  float* sd = smem + C::SB;
  float* srt = smem + C::SAT;
  float* spa = smem + C::SPA;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int s0 = j * seg_len, s1 = min(S, s0 + seg_len);
  const size_t row = static_cast<size_t>(H) * HD;
  const size_t head_off = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * HD;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t mat = static_cast<size_t>(HD) * HD;
  const int k0 = 16 * wp + g;

  float gg[F::NN][4];
  frag_zero<HD>(gg);
  typename V4::Raw pr[F::G4];
  float4 pw[F::G4], pd[F::G4];
  auto fetch = [&](int t0, int tc) {  // r and dy zero, w one past tc
#pragma unroll
    for (int i = 0; i < F::G4; ++i) {
      const int gi = tid + i * F::NT, t = gi / (HD / 4), c4 = (gi % (HD / 4)) * 4;
      pr[i] = typename V4::Raw{};
      pw[i] = make_float4(1.f, 1.f, 1.f, 1.f);
      pd[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < tc) {
        const size_t off = head_off + static_cast<size_t>(t0 + t) * row + c4;
        pr[i] = V4::load(r + off);
        pw[i] = ld4(w + off);
        pd[i] = ld4(dy + off);
      }
    }
  };

  const int q_first = s0 / kT, q_last = (s1 - 1) / kT;
  fetch(q_last * kT, s1 - q_last * kT);
  for (int q = q_last; q >= q_first; --q) {
    __syncthreads();  // the previous chunk's products are done with shared memory
#pragma unroll
    for (int i = 0; i < F::G4; ++i) {
      const int gi = tid + i * F::NT, t = gi / (HD / 4), c4 = (gi % (HD / 4)) * 4;
      st4(sr + t * C::RS + c4, V4::widen(pr[i]));
      st4(sw + t * C::RS + c4, pw[i]);
      st4(sd + t * C::BS + c4, pd[i]);
    }
    __syncthreads();
    if (q > q_first) fetch((q - 1) * kT, kT);  // in flight during the chunk
    if (tid >= HD) {  // key tid - HD: R~ forward over the chunk, and its decay
      const int key = tid - HD;
      float p = 1.f;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        srt[key * C::KTS + t] = sr[t * C::RS + key] * p;
        p *= sw[t * C::RS + key];
      }
      spa[key] = p;
    }
    __syncthreads();
    const float d0 = spa[k0], d1 = spa[k0 + 8];
#pragma unroll
    for (int n = 0; n < F::NN; ++n) {
      gg[n][0] *= d0; gg[n][1] *= d0; gg[n][2] *= d1; gg[n][3] *= d1;
    }
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_trunc(srt[k0 * C::KTS + 8 * kk + t4], ah[0], al[0]);
      split_trunc(srt[(k0 + 8) * C::KTS + 8 * kk + t4], ah[1], al[1]);
      split_trunc(srt[k0 * C::KTS + 8 * kk + t4 + 4], ah[2], al[2]);
      split_trunc(srt[(k0 + 8) * C::KTS + 8 * kk + t4 + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < F::NN; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_trunc(sd[(8 * kk + t4) * C::BS + 8 * n + g], bh0, bl0);
        split_trunc(sd[(8 * kk + t4 + 4) * C::BS + 8 * n + g], bh1, bl1);
        mma(gg[n], al, bh0, bh1);
        mma(gg[n], ah, bl0, bl1);
        mma(gg[n], ah, bh0, bh1);
      }
    }
  }
  frag_store<HD>(g_slot + (bh * n_seg + j) * mat, gg, k0, t4, HD);
}

// 1-2. Blocks (j, h, b): j < n_seg the local states of segment j, j >= n_seg
// the local adjoint of segment j - n_seg + 1, side by side in one launch.
template <typename T, int HD>
__global__ void __launch_bounds__(Frag<HD>::NT)
wkvb_local_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ dy,
                  float* __restrict__ ck_state, float* __restrict__ ck_decay,
                  float* __restrict__ s_slot, float* __restrict__ g_slot,
                  float* __restrict__ decay, int S, int H, int n_seg, int seg_len) {
  __shared__ __align__(16) float smem[LocalLayout<HD>::FLOATS];
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (j < n_seg)
    local_states<T, HD>(smem, j, h, b, k, v, w, ck_state, ck_decay, s_slot, decay, S, H, n_seg,
                        seg_len);
  else
    local_adjoint<T, HD>(smem, j - n_seg + 1, h, b, r, w, dy, g_slot, S, H, n_seg, seg_len);
}

// ---------------------------------------------------------------------------
// 2. the output pass
// ---------------------------------------------------------------------------

// (i, l >= i) -> its row of A's terms
__host__ __device__ constexpr int pair_index(int i, int l) {
  return i * kT - i * (i - 1) / 2 + (l - i);
}

// Shared memory of the output pass, in floats: the chunk's r, k, w, v, dy
// (t, key or column); P_i (i = 0 .. kT) and Q_i (t, key); R~^T (key, t);
// S_c dY^T, G_e V^T (t, key) and G_e^T K^ (t, column); M (t, l);
// rowsum(G_e * S_c); the forward walk's part of dw (t, key); A summed over
// the keys; and a union of {S_c, G_e (key, column), K^ (t, key)}, read by
// the products, with A's terms (pair, key), written by the walks after
// them.
template <int HD>
struct OutLayout {
  static constexpr int RS = HD + 4;    // rows of (t, key or column) arrays
  static constexpr int SS = HD + 4;    // rows of S_c and G_e
  static constexpr int KTS = kT + 4;   // rows of R~^T
  static constexpr int MS = kT + 1;    // rows of M
  static constexpr int AR = HD + 4;    // rows of A's terms
  static constexpr int SR = 0, SK = SR + kT * RS, SW = SK + kT * RS, SV = SW + kT * RS;
  static constexpr int SD = SV + kT * RS, SP = SD + kT * RS, SQ = SP + (kT + 1) * HD;
  static constexpr int SRT = SQ + kT * HD, SU = SRT + HD * KTS, SVG = SU + kT * RS;
  static constexpr int SZ = SVG + kT * RS, SM = SZ + kT * RS, SMR = SM + ((kT * MS + 3) & ~3);
  static constexpr int SDW = SMR + HD, SAS = SDW + kT * HD, SX = SAS + ((kPairs + 3) & ~3);
  static constexpr int SG = SX + HD * SS, SKH = SG + HD * SS;
  static constexpr int XA = 2 * HD * SS + kT * RS, XB = kPairs * AR;
  static constexpr int FLOATS = SX + (XA > XB ? XA : XB);
  static constexpr int BYTES = FLOATS * static_cast<int>(sizeof(float));
};

// Block (j, h, b): segment j's dr, dk, dv (T), dw (f32) and, for segment 0,
// dstate0; part_u (B, n_seg, H, HD) the segment's share of du.
template <typename T, int HD>
__global__ void __launch_bounds__(Frag<HD>::NT)
wkvb_output_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, const float* __restrict__ u,
                   const float* __restrict__ state0, const float* __restrict__ dy,
                   const float* __restrict__ dstate, T* __restrict__ dr, T* __restrict__ dk,
                   T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ dstate0,
                   const float* __restrict__ ck_state, const float* __restrict__ ck_decay,
                   const float* __restrict__ s_slot, const float* __restrict__ g_slot,
                   const float* __restrict__ decay, float* __restrict__ part_u, int S, int H,
                   int n_seg, int seg_len) {
  using F = Frag<HD>;
  using O = OutLayout<HD>;
  using V4 = Vec4<T>;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem + O::SR;
  float* sk = smem + O::SK;
  float* sw = smem + O::SW;
  float* sv = smem + O::SV;
  float* sd = smem + O::SD;
  float* sp = smem + O::SP;
  float* sq = smem + O::SQ;
  float* srt = smem + O::SRT;
  float* su = smem + O::SU;
  float* svg = smem + O::SVG;
  float* sz = smem + O::SZ;
  float* sm = smem + O::SM;
  float* smr = smem + O::SMR;
  float* sdw = smem + O::SDW;
  float* sas = smem + O::SAS;
  float* ss_ = smem + O::SX;   // S_c
  float* sg = smem + O::SG;    // G_e
  float* skh = smem + O::SKH;  // K^_i = Q_i k_i
  float* sa = smem + O::SX;    // A's terms, after the products

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int k0 = 16 * wp + g, k1 = k0 + 8;
  const int s0 = j * seg_len, s1 = min(S, s0 + seg_len), n_chunk = (S + kT - 1) / kT;
  const size_t row = static_cast<size_t>(H) * HD;
  const size_t head_off = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * HD;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t mat = static_cast<size_t>(HD) * HD;
  const int key = tid % HD;
  const bool fwd = tid < HD;  // this thread walks key's chunk forward (else back)
  const float uk = u[h * HD + key];

  // the carry: the segment's true start state (ss) and end adjoint (gg)
  float ss[F::NN][4], gg[F::NN][4];
  if (state0 != nullptr) frag_load<HD>(ss, state0 + bh * mat, k0, t4);
  else frag_zero<HD>(ss);
  for (int i = 0; i < j; ++i)
    frag_carry<HD>(ss, decay + (bh * n_seg + i) * HD, s_slot + (bh * n_seg + i) * mat, k0, t4);
  if (dstate != nullptr) frag_load<HD>(gg, dstate + bh * mat, k0, t4);
  else frag_zero<HD>(gg);
  for (int i = n_seg - 1; i > j; --i)
    frag_carry<HD>(gg, decay + (bh * n_seg + i) * HD, g_slot + (bh * n_seg + i) * mat, k0, t4);

  typename V4::Raw pr[F::G4], pk[F::G4], pv[F::G4];
  float4 pw[F::G4], pd[F::G4];
  auto fetch = [&](int t0, int tc) {  // r, k, v and dy zero, w one past tc
#pragma unroll
    for (int i = 0; i < F::G4; ++i) {
      const int gi = tid + i * F::NT, t = gi / (HD / 4), c4 = (gi % (HD / 4)) * 4;
      pr[i] = pk[i] = pv[i] = typename V4::Raw{};
      pw[i] = make_float4(1.f, 1.f, 1.f, 1.f);
      pd[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < tc) {
        const size_t off = head_off + static_cast<size_t>(t0 + t) * row + c4;
        pr[i] = V4::load(r + off);
        pk[i] = V4::load(k + off);
        pv[i] = V4::load(v + off);
        pw[i] = ld4(w + off);
        pd[i] = ld4(dy + off);
      }
    }
  };

  float du_acc = 0.f;
  const int q_first = s0 / kT, q_last = (s1 - 1) / kT;
  fetch(q_last * kT, s1 - q_last * kT);
  for (int q = q_last; q >= q_first; --q) {
    const int t0 = q * kT, tc = min(kT, s1 - t0);
    // S_c: the start state, or its decay times it plus the chunk's local
    // state (the loads issued before the staging)
    float sc[F::NN][4];
#pragma unroll
    for (int n = 0; n < F::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = ss[n][e];
    if (q > q_first) {
      const size_t c = bh * n_chunk + q;
      frag_carry<HD>(sc, ck_decay + c * HD, ck_state + c * mat, k0, t4);
    }
    __syncthreads();  // the previous chunk is done with shared memory
#pragma unroll
    for (int i = 0; i < F::G4; ++i) {
      const int gi = tid + i * F::NT, t = gi / (HD / 4), c4 = (gi % (HD / 4)) * 4;
      st4(sr + t * O::RS + c4, V4::widen(pr[i]));
      st4(sk + t * O::RS + c4, V4::widen(pk[i]));
      st4(sv + t * O::RS + c4, V4::widen(pv[i]));
      st4(sw + t * O::RS + c4, pw[i]);
      st4(sd + t * O::RS + c4, pd[i]);
    }
    // S_c and G_e into shared memory; rowsum(G_e * S_c) of rows k0, k1
    {
      frag_store<HD>(ss_, sc, k0, t4, O::SS);
      frag_store<HD>(sg, gg, k0, t4, O::SS);
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int n = 0; n < F::NN; ++n) {
        m0 = fmaf(gg[n][0], sc[n][0], fmaf(gg[n][1], sc[n][1], m0));
        m1 = fmaf(gg[n][2], sc[n][2], fmaf(gg[n][3], sc[n][3], m1));
      }
      m0 += __shfl_xor_sync(0xffffffffu, m0, 1);
      m1 += __shfl_xor_sync(0xffffffffu, m1, 1);
      m0 += __shfl_xor_sync(0xffffffffu, m0, 2);
      m1 += __shfl_xor_sync(0xffffffffu, m1, 2);
      if (t4 == 0) {
        smr[k0] = m0;
        smr[k1] = m1;
      }
    }
    __syncthreads();
    if (q > q_first) fetch((q - 1) * kT, kT);  // in flight during the chunk
    // the decays inside the chunk: P_i and R~ (forward threads), Q_i and K^
    if (fwd) {
      float p = 1.f;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        sp[t * HD + key] = p;
        srt[key * O::KTS + t] = sr[t * O::RS + key] * p;
        p *= sw[t * O::RS + key];
      }
      sp[kT * HD + key] = p;
    } else {
      float qv = 1.f;
#pragma unroll
      for (int t = kT - 1; t >= 0; --t) {
        sq[t * HD + key] = qv;
        skh[t * O::RS + key] = sk[t * O::RS + key] * qv;
        qv *= sw[t * O::RS + key];
      }
    }
    // M[tau, l] = v_tau . dy_l
    for (int e = tid; e < kT * kT; e += F::NT) {
      const int tau = e / kT, l = e % kT;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < HD; c += 4) {
        const float4 x = ld4(sv + tau * O::RS + c), d = ld4(sd + l * O::RS + c);
        a.x = fmaf(x.x, d.x, a.x);
        a.y = fmaf(x.y, d.y, a.y);
        a.z = fmaf(x.z, d.z, a.z);
        a.w = fmaf(x.w, d.w, a.w);
      }
      sm[tau * O::MS + l] = (a.x + a.y) + (a.z + a.w);
    }
    __syncthreads();
    // the products on the tensor cores, this warp's 16 rows: S_c dY^T and
    // G_e V^T (rows: keys), G_e^T K^ (rows: columns)
    {
      constexpr int NL = kT / 8;  // n8 tiles of the chunk's steps
      float cu[NL][4], cg[NL][4], cz[NL][4];
#pragma unroll
      for (int n = 0; n < NL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cu[n][e] = cg[n][e] = cz[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int c0 = 8 * kk + t4, c1 = c0 + 4;
        uint32_t sh[4], sl[4], gh[4], gl[4], zh[4], zl[4];
        split_trunc(ss_[k0 * O::SS + c0], sh[0], sl[0]);
        split_trunc(ss_[k1 * O::SS + c0], sh[1], sl[1]);
        split_trunc(ss_[k0 * O::SS + c1], sh[2], sl[2]);
        split_trunc(ss_[k1 * O::SS + c1], sh[3], sl[3]);
        split_trunc(sg[k0 * O::SS + c0], gh[0], gl[0]);
        split_trunc(sg[k1 * O::SS + c0], gh[1], gl[1]);
        split_trunc(sg[k0 * O::SS + c1], gh[2], gl[2]);
        split_trunc(sg[k1 * O::SS + c1], gh[3], gl[3]);
        split_trunc(sg[c0 * O::SS + k0], zh[0], zl[0]);  // G_e^T: rows are columns
        split_trunc(sg[c0 * O::SS + k1], zh[1], zl[1]);
        split_trunc(sg[c1 * O::SS + k0], zh[2], zl[2]);
        split_trunc(sg[c1 * O::SS + k1], zh[3], zl[3]);
#pragma unroll
        for (int n = 0; n < NL; ++n) {
          const int l = 8 * n + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_trunc(sd[l * O::RS + c0], bh0, bl0);  // B[c][l] = dy_l[c]
          split_trunc(sd[l * O::RS + c1], bh1, bl1);
          mma(cu[n], sl, bh0, bh1);
          mma(cu[n], sh, bl0, bl1);
          mma(cu[n], sh, bh0, bh1);
          const float x0 = sv[l * O::RS + c0], x1 = sv[l * O::RS + c1];  // B[c][l] = v_l[c]
          if constexpr (sizeof(T) == 2) {  // bf16 v is exact in tf32
            mma(cg[n], gl, __float_as_uint(x0), __float_as_uint(x1));
            mma(cg[n], gh, __float_as_uint(x0), __float_as_uint(x1));
          } else {
            split_trunc(x0, bh0, bl0);
            split_trunc(x1, bh1, bl1);
            mma(cg[n], gl, bh0, bh1);
            mma(cg[n], gh, bl0, bl1);
            mma(cg[n], gh, bh0, bh1);
          }
          split_trunc(skh[l * O::RS + c0], bh0, bl0);  // B[key][l] = K^_l[key]
          split_trunc(skh[l * O::RS + c1], bh1, bl1);
          mma(cz[n], zl, bh0, bh1);
          mma(cz[n], zh, bl0, bl1);
          mma(cz[n], zh, bh0, bh1);
        }
      }
#pragma unroll
      for (int n = 0; n < NL; ++n) {
        const int c = 8 * n + 2 * t4;
        su[c * O::RS + k0] = cu[n][0];
        su[(c + 1) * O::RS + k0] = cu[n][1];
        su[c * O::RS + k1] = cu[n][2];
        su[(c + 1) * O::RS + k1] = cu[n][3];
        svg[c * O::RS + k0] = cg[n][0];
        svg[(c + 1) * O::RS + k0] = cg[n][1];
        svg[c * O::RS + k1] = cg[n][2];
        svg[(c + 1) * O::RS + k1] = cg[n][3];
        sz[c * O::RS + k0] = cz[n][0];
        sz[(c + 1) * O::RS + k0] = cz[n][1];
        sz[c * O::RS + k1] = cz[n][2];
        sz[(c + 1) * O::RS + k1] = cz[n][3];
      }
    }
    __syncthreads();
    // the walks inside the chunk, one thread a key each way; pth[i] =
    // P_i sum_{l>i} W(i,l) r_l (S_c dy_l), the backward walk's part of dw
    float pth[kT];
    {
      float rr[kT], kv[kT], ww[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        rr[t] = sr[t * O::RS + key];
        kv[t] = sk[t * O::RS + key];
        ww[t] = sw[t * O::RS + key];
      }
      if (fwd) {
        // phi[l] = sum_{tau<i} W(tau,i) k_tau M[tau,l] (l > i), psi =
        // sum_{tau<i} W(tau,i) k_tau (G_e v_tau), p_i = P_i
        float phi[kT], psi = 0.f, p_i = 1.f;
        const float mrow = smr[key];
#pragma unroll
        for (int l = 0; l < kT; ++l) phi[l] = 0.f;
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          const float beta = sm[i * O::MS + i], q_i = sq[i * HD + key];
          float t4w = 0.f, p = 1.f;  // sum_{l>i} W(i,l) r_l phi[l]
#pragma unroll
          for (int l = i + 1; l < kT; ++l) {
            t4w = fmaf(p * rr[l], phi[l], t4w);
            p *= ww[l];
          }
          const float dri = fmaf(p_i, su[i * O::RS + key], phi[i]) + uk * kv[i] * beta;
          sdw[i * HD + key] = fmaf(p_i * q_i, mrow, fmaf(q_i, psi, t4w));
          if (i < tc) {
            dr[head_off + static_cast<size_t>(t0 + i) * row + key] = from_f32<T>(dri);
            du_acc = fmaf(rr[i] * kv[i], beta, du_acc);
          }
#pragma unroll
          for (int l = i + 1; l < kT; ++l) phi[l] = fmaf(ww[i], phi[l], kv[i] * sm[i * O::MS + l]);
          psi = fmaf(ww[i], psi, kv[i] * svg[i * O::RS + key]);
          p_i *= ww[i];
        }
      } else {
        // e[l] = W(i,l) r_l (l > i), theta = sum_{l>i} W(i,l) r_l (S_c dy_l)
        float e[kT], theta = 0.f;
#pragma unroll
        for (int l = 0; l < kT; ++l) e[l] = 0.f;
#pragma unroll
        for (int i = kT - 1; i >= 0; --i) {
          const float beta = sm[i * O::MS + i];
          float dki = 0.f;
#pragma unroll
          for (int l = i + 1; l < kT; ++l) {
            dki = fmaf(e[l], sm[i * O::MS + l], dki);
            sa[pair_index(i, l) * O::AR + key] = kv[i] * e[l];
          }
          sa[pair_index(i, i) * O::AR + key] = rr[i] * uk * kv[i];
          dki = fmaf(sq[i * HD + key], svg[i * O::RS + key], dki) + rr[i] * uk * beta;
          pth[i] = sp[i * HD + key] * theta;
          if (i < tc) dk[head_off + static_cast<size_t>(t0 + i) * row + key] = from_f32<T>(dki);
#pragma unroll
          for (int l = i + 1; l < kT; ++l) e[l] *= ww[i];
          e[i] = rr[i];
          theta = fmaf(ww[i], theta, rr[i] * su[i * O::RS + key]);
        }
      }
    }
    __syncthreads();
    if (!fwd) {  // dw: the two walks' parts
#pragma unroll
      for (int i = 0; i < kT; ++i)
        if (i < tc) dw[head_off + static_cast<size_t>(t0 + i) * row + key] = sdw[i * HD + key] + pth[i];
    }
    // A summed over the keys, in key order within each of four lanes of keys
    for (int p = tid; p < kPairs; p += F::NT) {
      const float* a = sa + p * O::AR;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < HD; c += 4) {
        const float4 x = ld4(a + c);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      sas[p] = (acc.x + acc.y) + (acc.z + acc.w);
    }
    __syncthreads();
    // dv_i = G_e^T K^_i + sum_{l>=i} A[i,l] dy_l
    for (int e = tid; e < tc * (HD / 4); e += F::NT) {
      const int i = e / (HD / 4), c4 = (e % (HD / 4)) * 4;
      float4 a = ld4(sz + i * O::RS + c4);
      for (int l = i; l < kT; ++l) {
        const float x = sas[pair_index(i, l)];
        const float4 d = ld4(sd + l * O::RS + c4);
        a.x = fmaf(x, d.x, a.x);
        a.y = fmaf(x, d.y, a.y);
        a.z = fmaf(x, d.z, a.z);
        a.w = fmaf(x, d.w, a.w);
      }
      T* o = dv + head_off + static_cast<size_t>(t0 + i) * row + c4;
      o[0] = from_f32<T>(a.x);
      o[1] = from_f32<T>(a.y);
      o[2] = from_f32<T>(a.z);
      o[3] = from_f32<T>(a.w);
    }
    // the adjoint before the chunk: G <- diag(P_kT) G + R~^T dY
    {
      const float d0 = sp[kT * HD + k0], d1 = sp[kT * HD + k1];
#pragma unroll
      for (int n = 0; n < F::NN; ++n) {
        gg[n][0] *= d0; gg[n][1] *= d0; gg[n][2] *= d1; gg[n][3] *= d1;
      }
#pragma unroll
      for (int kk = 0; kk < kT / 8; ++kk) {
        uint32_t ah[4], al[4];
        split_trunc(srt[k0 * O::KTS + 8 * kk + t4], ah[0], al[0]);
        split_trunc(srt[k1 * O::KTS + 8 * kk + t4], ah[1], al[1]);
        split_trunc(srt[k0 * O::KTS + 8 * kk + t4 + 4], ah[2], al[2]);
        split_trunc(srt[k1 * O::KTS + 8 * kk + t4 + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < F::NN; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_trunc(sd[(8 * kk + t4) * O::RS + 8 * n + g], bh0, bl0);
          split_trunc(sd[(8 * kk + t4 + 4) * O::RS + 8 * n + g], bh1, bl1);
          mma(gg[n], al, bh0, bh1);
          mma(gg[n], ah, bl0, bl1);
          mma(gg[n], ah, bh0, bh1);
        }
      }
    }
  }
  if (j == 0) frag_store<HD>(dstate0 + bh * mat, gg, k0, t4, HD);
  if (fwd) part_u[((static_cast<size_t>(b) * n_seg + j) * H + h) * HD + key] = du_acc;
}

// 3. du (H, HD): the (row, segment) shares added in order.
__global__ void __launch_bounds__(128)
wkvb_du_kernel(const float* __restrict__ part_u, float* __restrict__ du, int B, int H, int HD,
               int n_seg) {
  const int e = blockIdx.x * 128 + threadIdx.x;
  if (e >= H * HD) return;
  float a = 0.f;
  for (long long q = 0; q < static_cast<long long>(B) * n_seg; ++q)
    a += part_u[q * H * HD + e];
  du[e] = a;
}

template <typename T, int HD>
cudaError_t allow_output_smem() {  // above 48 KB dynamic shared memory must be allowed first
  if (OutLayout<HD>::BYTES <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(wkvb_output_kernel<T, HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, OutLayout<HD>::BYTES);
}

template <typename T, int HD>
cudaError_t launch_hd(const void* r_, const void* k_, const void* v_, const float* w,
                      const float* u, const float* state0, const float* dy, const float* dstate,
                      void* dr, void* dk, void* dv, float* dw, float* du, float* dstate0,
                      float* ck_state, float* ck_decay, float* s_slot, float* g_slot, float* decay,
                      float* part_u, int B, int S, int H, int n_seg, int seg_len,
                      cudaStream_t stream) {
  const T* r = static_cast<const T*>(r_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const dim3 grid(n_seg, H, B);
  constexpr int NT = Frag<HD>::NT;
  cudaError_t err;
  if (S > kT) {  // more than one chunk: checkpoints (and, with n_seg > 1, slots)
    wkvb_local_kernel<T, HD><<<dim3(2 * n_seg - 1, H, B), NT, 0, stream>>>(
        r, k, v, w, dy, ck_state, ck_decay, s_slot, g_slot, decay, S, H, n_seg, seg_len);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = allow_output_smem<T, HD>()) != cudaSuccess) return err;
  wkvb_output_kernel<T, HD><<<grid, NT, OutLayout<HD>::BYTES, stream>>>(
      r, k, v, w, u, state0, dy, dstate, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), dw, dstate0, ck_state, ck_decay, s_slot, g_slot, decay, part_u, S, H,
      n_seg, seg_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkvb_du_kernel<<<(H * HD + 127) / 128, 128, 0, stream>>>(part_u, du, B, H, HD, n_seg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* state0, const float* dy, const float* dstate, void* dr,
                   void* dk, void* dv, float* dw, float* du, float* dstate0, float* ck_state,
                   float* ck_decay, float* s_slot, float* g_slot, float* decay, float* part_u,
                   int B, int S, int H, int hd, int n_seg, int seg_len, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  // whole chunks a segment; the segments cover S exactly once, none empty
  if (n_seg < 1 || n_seg > 65535 || seg_len < kT || seg_len % kT != 0 ||
      static_cast<long long>(n_seg - 1) * seg_len >= S ||
      static_cast<long long>(n_seg) * seg_len < S)
    return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_hd<T, 64>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, du, dstate0,
                            ck_state, ck_decay, s_slot, g_slot, decay, part_u, B, S, H, n_seg,
                            seg_len, stream);
  if (hd == 32)
    return launch_hd<T, 32>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, du, dstate0,
                            ck_state, ck_decay, s_slot, g_slot, decay, part_u, B, S, H, n_seg,
                            seg_len, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int HD>
int output_blocks_per_sm_hd() {
  int n = 0;
  cudaError_t err = allow_output_smem<T, HD>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkvb_output_kernel<T, HD>,
                                                        Frag<HD>::NT, OutLayout<HD>::BYTES);
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
int wkvb_output_blocks_per_sm(int dtype, int hd) {
  if (dtype == kF32) return output_blocks_per_sm<float>(hd);
  if (dtype == kBF16) return output_blocks_per_sm<__nv_bfloat16>(hd);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Returns the cudaError_t of the launches (0 on success). r, k, v and the
// gradients dr, dk, dv share one dtype (0: f32, 1: bf16); w, u, dy, dw, du
// and the states are f32; state0 and dstate may be null (zero). The time
// axis runs as n_seg segments of seg_len steps (a multiple of 16; the last
// may be shorter). The scratch, f32: ck_state (B, H, n_chunk, hd, hd) and
// ck_decay (B, H, n_chunk, hd) with n_chunk = ceil(S / 16), s_slot and
// g_slot (B, H, n_seg, hd, hd), decay (B, H, n_seg, hd) and part_u (B,
// n_seg, H, hd).
int wkvb_rwkv6_backward(int dtype, const void* r, const void* k, const void* v, const float* w,
                        const float* u, const float* state0, const float* dy,
                        const float* dstate, void* dr, void* dk, void* dv, float* dw, float* du,
                        float* dstate0, float* ck_state, float* ck_decay, float* s_slot,
                        float* g_slot, float* decay, float* part_u, int B, int S, int H, int hd,
                        int n_seg, int seg_len, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw,
                                            du, dstate0, ck_state, ck_decay, s_slot, g_slot,
                                            decay, part_u, B, S, H, hd, n_seg, seg_len, st));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(r, k, v, w, u, state0, dy, dstate, dr, dk,
                                                     dv, dw, du, dstate0, ck_state, ck_decay,
                                                     s_slot, g_slot, decay, part_u, B, S, H, hd,
                                                     n_seg, seg_len, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
