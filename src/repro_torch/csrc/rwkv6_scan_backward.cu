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
//   The states are recomputed forward from saved carries instead, as
//   chunked_scan recomputes its inner steps. The time axis is cut into
//   segments of kSeg steps, and the adjoint, itself a linear recurrence
//   run in reverse, is cut at the same places. Four launches:
//   1. wkvb_local_kernel, one block per (segment, head, row), a thread per
//      key holding the key's row of the state: segment j's end state from a
//      zero state, its decay prod_t w_t, and its local adjoint (that of the
//      state before it) from a zero adjoint at its end.
//   2. wkvb_carry_kernel, one thread per 4 elements of a state: the true
//      start state of every segment, S_start[j] = D[j-1] S_start[j-1] +
//      S_loc[j-1] from state0, and the true adjoint reaching its end,
//      G_end[j] = G_loc[j+1] + D[j+1] G_end[j+1] from dstate, in place.
//   3. wkvb_output_kernel, one block per (segment, head, row), a thread per
//      key: beta and gamma of the segment's steps first (block sums through
//      shared memory), then the state's columns kCW at a time: the forward
//      walk from S_start keeps each step's S_{t-1} in shared memory, the
//      reverse walk from G_end adds the key's sums over those columns to
//      dr, dk and dw (kept in shared memory across the column slices, each
//      thread its own key) and leaves G_t k_t in place of S_{t-1}, whose
//      sums over the keys make dv. Nothing of the state crosses blocks.
//   4. wkvb_du_kernel: du adds the (row, segment) shares in a fixed order.
//   No atomics: every sum is taken in one order, so two calls give the same
//   bits. Every decay factor is a product of w's: it can only underflow to
//   0, the right value.
#include "scan_common.cuh"

namespace {

using scan::ld4;
using scan::st4;
using scan::to_f32;
using scan::Vec4;

constexpr int kSeg = 32;  // steps of a segment (kernels.rwkv6_scan.BACKWARD_SEGMENT)
constexpr int kCW = 4;    // state columns of a slice of the output pass

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Indexing of one (row, head): r, k, v, w, dy are (B, S, H, HD); the
// states (HD x HD) row-major, key index first.
template <int HD>
struct Head {
  size_t row, head_off, bh;
  __device__ __forceinline__ Head(int b, int h, int S, int H)
      : row(static_cast<size_t>(H) * HD),
        head_off(static_cast<size_t>(b) * S * H * HD + static_cast<size_t>(h) * HD),
        bh(static_cast<size_t>(b) * H + h) {}
  __device__ __forceinline__ size_t at(int t) const { return head_off + static_cast<size_t>(t) * row; }
};

// 1. Block (j, h, b), thread = key kk: for j < n_seg - 1, segment j's end
// state from a zero state into s_slots slot j + 1 and its decay prod_t
// w_t[kk] into decay[(b, h, j, kk)]; for j >= 1, its local adjoint from a
// zero adjoint at its end into g_slots slot j - 1 (and, for the last
// segment, its decay). s_slots and g_slots are (B, H, n_seg, HD, HD), decay
// (B, H, n_seg, HD).
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkvb_local_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ dy,
                  float* __restrict__ s_slots, float* __restrict__ g_slots,
                  float* __restrict__ decay, int S, int H, int n_seg) {
  using V4 = Vec4<T>;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, kk = threadIdx.x;
  const Head<HD> hd_(b, h, S, H);
  const int s0 = j * kSeg, s1 = min(S, s0 + kSeg);
  const size_t mat = static_cast<size_t>(HD) * HD;
  float st[HD];
  if (j < n_seg - 1) {
#pragma unroll
    for (int c = 0; c < HD; ++c) st[c] = 0.f;
    float dprod = 1.f;
    for (int t = s0; t < s1; ++t) {
      const size_t off = hd_.at(t);
      const float wt = w[off + kk], kt = to_f32(k[off + kk]);
#pragma unroll
      for (int c = 0; c < HD; c += 4) {
        const float4 v4 = V4::widen(V4::load(v + off + c));
        st[c] = fmaf(st[c], wt, kt * v4.x);
        st[c + 1] = fmaf(st[c + 1], wt, kt * v4.y);
        st[c + 2] = fmaf(st[c + 2], wt, kt * v4.z);
        st[c + 3] = fmaf(st[c + 3], wt, kt * v4.w);
      }
      dprod *= wt;
    }
    float* out = s_slots + (hd_.bh * n_seg + j + 1) * mat + static_cast<size_t>(kk) * HD;
#pragma unroll
    for (int c = 0; c < HD; c += 4) st4(out + c, make_float4(st[c], st[c + 1], st[c + 2], st[c + 3]));
    decay[(hd_.bh * n_seg + j) * HD + kk] = dprod;
  }
  if (j >= 1) {
#pragma unroll
    for (int c = 0; c < HD; ++c) st[c] = 0.f;
    float dprod = 1.f;
    for (int t = s1 - 1; t >= s0; --t) {
      const size_t off = hd_.at(t);
      const float wt = w[off + kk], rt = to_f32(r[off + kk]);
#pragma unroll
      for (int c = 0; c < HD; c += 4) {
        const float4 d4 = ld4(dy + off + c);
        st[c] = fmaf(st[c], wt, rt * d4.x);
        st[c + 1] = fmaf(st[c + 1], wt, rt * d4.y);
        st[c + 2] = fmaf(st[c + 2], wt, rt * d4.z);
        st[c + 3] = fmaf(st[c + 3], wt, rt * d4.w);
      }
      dprod *= wt;
    }
    float* out = g_slots + (hd_.bh * n_seg + j - 1) * mat + static_cast<size_t>(kk) * HD;
#pragma unroll
    for (int c = 0; c < HD; c += 4) st4(out + c, make_float4(st[c], st[c + 1], st[c + 2], st[c + 3]));
    if (j == n_seg - 1) decay[(hd_.bh * n_seg + j) * HD + kk] = dprod;
  }
}

// 2. Thread (b, h, key, 4 columns): the carries over the segments, in
// place. Afterwards s_slots slot j (j >= 1) holds segment j's true start
// state and g_slots slot j (j <= n_seg - 2) the true adjoint reaching its
// end.
__global__ void __launch_bounds__(128)
wkvb_carry_kernel(const float* __restrict__ state0, const float* __restrict__ dstate,
                  float* __restrict__ s_slots, float* __restrict__ g_slots,
                  const float* __restrict__ decay, int BH, int HD, int n_seg) {
  const long long gi = static_cast<long long>(blockIdx.x) * 128 + threadIdx.x;
  const int per_mat = HD * HD / 4;
  if (gi >= static_cast<long long>(BH) * per_mat) return;
  const size_t bh = static_cast<size_t>(gi / per_mat);
  const int e4 = static_cast<int>(gi % per_mat), kk = e4 / (HD / 4);
  const size_t mat = static_cast<size_t>(HD) * HD, el = static_cast<size_t>(e4) * 4;
  float4 s = state0 != nullptr ? ld4(state0 + bh * mat + el) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 1; j < n_seg; ++j) {
    const float d = decay[(bh * n_seg + j - 1) * HD + kk];
    float* p = s_slots + (bh * n_seg + j) * mat + el;
    const float4 x = ld4(p);
    s = make_float4(fmaf(d, s.x, x.x), fmaf(d, s.y, x.y), fmaf(d, s.z, x.z), fmaf(d, s.w, x.w));
    st4(p, s);
  }
  float4 g = dstate != nullptr ? ld4(dstate + bh * mat + el) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = n_seg - 2; j >= 0; --j) {
    const float d = decay[(bh * n_seg + j + 1) * HD + kk];
    float* p = g_slots + (bh * n_seg + j) * mat + el;
    const float4 x = ld4(p);
    g = make_float4(fmaf(d, g.x, x.x), fmaf(d, g.y, x.y), fmaf(d, g.z, x.z), fmaf(d, g.w, x.w));
    st4(p, g);
  }
}

// The output pass's shared memory, in floats: the slice's S_{t-1} (then
// G_t k_t) of each step, (t, key, kCW columns), rows padded so that the
// sums over the keys meet 32 banks; dr, dk, dw of each (t, key); beta and
// gamma of each step. The beta/gamma products are staged in the dr/dk/dw
// area first, (t, key) with rows of HD + 1.
template <int HD>
struct OutLayout {
  static constexpr int HR = HD * kCW + 4;  // floats a step of the slice
  static constexpr int SH = 0, SACC = kSeg * HR, SBG = SACC + 3 * kSeg * HD;
  static constexpr int FLOATS = SBG + 2 * kSeg;
  static constexpr int BYTES = FLOATS * static_cast<int>(sizeof(float));
  static_assert(2 * kSeg * (HD + 1) <= 3 * kSeg * HD && (HR * 4) % 16 == 0, "layout");
};

// 3. Block (j, h, b), thread = key kk: segment j's dr, dk, dv (T), dw (f32)
// and, for segment 0, dstate0; part_u (B, n_seg, H, HD) the segment's
// share of du.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkvb_output_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, const float* __restrict__ u,
                   const float* __restrict__ state0, const float* __restrict__ dy,
                   const float* __restrict__ dstate, T* __restrict__ dr, T* __restrict__ dk,
                   T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ dstate0,
                   const float* __restrict__ s_slots, const float* __restrict__ g_slots,
                   float* __restrict__ part_u, int S, int H, int n_seg) {
  using O = OutLayout<HD>;
  using V4 = Vec4<T>;
  extern __shared__ __align__(16) float smem[];
  float* hist = smem + O::SH;
  float* acc_dr = smem + O::SACC;
  float* acc_dk = acc_dr + kSeg * HD;
  float* acc_dw = acc_dk + kSeg * HD;
  float* beta = smem + O::SBG;
  float* gamma = beta + kSeg;

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, kk = threadIdx.x;
  const Head<HD> hd_(b, h, S, H);
  const int s0 = j * kSeg, tc = min(S, s0 + kSeg) - s0;
  const size_t mat = static_cast<size_t>(HD) * HD;
  const float uk = u[h * HD + kk];

  // beta_t = v_t . dy_t and gamma_t = sum_k r_t u k_t: the terms of each
  // (t, key), then each step's sum over the keys in key order
  float* scr = acc_dr;
  for (int i = 0; i < tc; ++i) {
    const size_t off = hd_.at(s0 + i) + kk;
    scr[i * (HD + 1) + kk] = to_f32(v[off]) * dy[off];
    scr[(kSeg + i) * (HD + 1) + kk] = to_f32(r[off]) * uk * to_f32(k[off]);
  }
  __syncthreads();
  for (int e = kk; e < 2 * tc; e += HD) {
    const float* p = scr + (e < tc ? e : kSeg + e - tc) * (HD + 1);
    float a = 0.f;
    for (int q = 0; q < HD; ++q) a += p[q];
    (e < tc ? beta[e] : gamma[e - tc]) = a;
  }
  __syncthreads();
  // the bonus terms start dr and dk; du's share of the segment
  float du_acc = 0.f;
  for (int i = 0; i < tc; ++i) {
    const size_t off = hd_.at(s0 + i) + kk;
    const float rt = to_f32(r[off]), kt = to_f32(k[off]), bt = beta[i];
    acc_dr[i * HD + kk] = uk * kt * bt;
    acc_dk[i * HD + kk] = rt * uk * bt;
    acc_dw[i * HD + kk] = 0.f;
    du_acc = fmaf(rt * kt, bt, du_acc);
  }

  const size_t slot = (hd_.bh * n_seg + j) * mat + static_cast<size_t>(kk) * HD;
  const size_t own = hd_.bh * mat + static_cast<size_t>(kk) * HD;
  for (int c0 = 0; c0 < HD; c0 += kCW) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), g = s;
    if (j > 0) s = ld4(s_slots + slot + c0);
    else if (state0 != nullptr) s = ld4(state0 + own + c0);
    if (j < n_seg - 1) g = ld4(g_slots + slot + c0);
    else if (dstate != nullptr) g = ld4(dstate + own + c0);
    // the forward walk: S_{t-1} of each step into this thread's row of hist
    for (int i = 0; i < tc; ++i) {
      const size_t off = hd_.at(s0 + i);
      const float wt = w[off + kk], kt = to_f32(k[off + kk]);
      const float4 v4 = V4::widen(V4::load(v + off + c0));
      st4(hist + i * O::HR + kk * kCW, s);
      s = make_float4(fmaf(s.x, wt, kt * v4.x), fmaf(s.y, wt, kt * v4.y),
                      fmaf(s.z, wt, kt * v4.z), fmaf(s.w, wt, kt * v4.w));
    }
    // the reverse walk: g is G_t
    for (int i = tc - 1; i >= 0; --i) {
      const size_t off = hd_.at(s0 + i);
      const float wt = w[off + kk], kt = to_f32(k[off + kk]), rt = to_f32(r[off + kk]);
      const float4 v4 = V4::widen(V4::load(v + off + c0));
      const float4 d4 = ld4(dy + off + c0);
      float* hp = hist + i * O::HR + kk * kCW;
      const float4 sp = ld4(hp);
      acc_dr[i * HD + kk] += sp.x * d4.x + sp.y * d4.y + sp.z * d4.z + sp.w * d4.w;
      acc_dk[i * HD + kk] += g.x * v4.x + g.y * v4.y + g.z * v4.z + g.w * v4.w;
      acc_dw[i * HD + kk] += g.x * sp.x + g.y * sp.y + g.z * sp.z + g.w * sp.w;
      st4(hp, make_float4(g.x * kt, g.y * kt, g.z * kt, g.w * kt));  // dv's terms
      g = make_float4(fmaf(g.x, wt, rt * d4.x), fmaf(g.y, wt, rt * d4.y),
                      fmaf(g.z, wt, rt * d4.z), fmaf(g.w, wt, rt * d4.w));
    }
    if (j == 0) st4(dstate0 + own + c0, g);
    __syncthreads();
    // dv of the slice's columns: the keys' terms in key order, plus gamma dy
    for (int e = kk; e < tc * kCW; e += HD) {
      const int i = e / kCW, c = e % kCW;
      const float* p = hist + i * O::HR + c;
      float a = 0.f;
      for (int q = 0; q < HD; ++q) a += p[q * kCW];
      const size_t o = hd_.at(s0 + i) + c0 + c;
      dv[o] = from_f32<T>(fmaf(gamma[i], dy[o], a));
    }
    __syncthreads();
  }
  for (int i = 0; i < tc; ++i) {
    const size_t off = hd_.at(s0 + i) + kk;
    dr[off] = from_f32<T>(acc_dr[i * HD + kk]);
    dk[off] = from_f32<T>(acc_dk[i * HD + kk]);
    dw[off] = acc_dw[i * HD + kk];
  }
  part_u[((static_cast<size_t>(b) * n_seg + j) * H + h) * HD + kk] = du_acc;
}

// 4. du (H, HD): the (row, segment) shares added in order.
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
cudaError_t launch_hd(const void* r_, const void* k_, const void* v_, const float* w,
                      const float* u, const float* state0, const float* dy, const float* dstate,
                      void* dr, void* dk, void* dv, float* dw, float* du, float* dstate0,
                      float* s_slots, float* g_slots, float* decay, float* part_u, int B, int S,
                      int H, int n_seg, cudaStream_t stream) {
  const T* r = static_cast<const T*>(r_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const dim3 grid(n_seg, H, B);
  cudaError_t err;
  if (n_seg > 1) {
    wkvb_local_kernel<T, HD><<<grid, HD, 0, stream>>>(r, k, v, w, dy, s_slots, g_slots, decay,
                                                      S, H, n_seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long threads = static_cast<long long>(B) * H * HD * HD / 4;
    wkvb_carry_kernel<<<static_cast<unsigned>((threads + 127) / 128), 128, 0, stream>>>(
        state0, dstate, s_slots, g_slots, decay, B * H, HD, n_seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  using O = OutLayout<HD>;
  if (O::BYTES > 48 * 1024 &&
      (err = cudaFuncSetAttribute(wkvb_output_kernel<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, O::BYTES)) !=
          cudaSuccess)
    return err;
  wkvb_output_kernel<T, HD><<<grid, HD, O::BYTES, stream>>>(
      r, k, v, w, u, state0, dy, dstate, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), dw, dstate0, s_slots, g_slots, part_u, S, H, n_seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkvb_du_kernel<<<(H * HD + 127) / 128, 128, 0, stream>>>(part_u, du, B, H, HD, n_seg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* state0, const float* dy, const float* dstate, void* dr,
                   void* dk, void* dv, float* dw, float* du, float* dstate0, float* s_slots,
                   float* g_slots, float* decay, float* part_u, int B, int S, int H, int hd,
                   int n_seg, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  // segments of kSeg steps cover S exactly once
  if (n_seg < 1 || n_seg != (S + kSeg - 1) / kSeg) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * H * hd * hd / 4 > 0x7fffffffLL * 128LL)
    return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_hd<T, 64>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, du, dstate0,
                            s_slots, g_slots, decay, part_u, B, S, H, n_seg, stream);
  if (hd == 32)
    return launch_hd<T, 32>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, du, dstate0,
                            s_slots, g_slots, decay, part_u, B, S, H, n_seg, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 on success). r, k, v and the
// gradients dr, dk, dv share one dtype (0: f32, 1: bf16); w, u, dy, dw, du
// and the states are f32; state0 and dstate may be null (zero). The
// scratch: s_slots and g_slots (B, H, n_seg, hd, hd), decay (B, H, n_seg,
// hd) and part_u (B, n_seg, H, hd), with n_seg = ceil(S / 32).
int wkvb_rwkv6_backward(int dtype, const void* r, const void* k, const void* v, const float* w,
                        const float* u, const float* state0, const float* dy,
                        const float* dstate, void* dr, void* dk, void* dv, float* dw, float* du,
                        float* dstate0, float* s_slots, float* g_slots, float* decay,
                        float* part_u, int B, int S, int H, int hd, int n_seg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch<float>(r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw,
                                            du, dstate0, s_slots, g_slots, decay, part_u, B, S,
                                            H, hd, n_seg, st));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(r, k, v, w, u, state0, dy, dstate, dr, dk,
                                                     dv, dw, du, dstate0, s_slots, g_slots,
                                                     decay, part_u, B, S, H, hd, n_seg, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
