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
//   decays, and it ignores state0. This kernel runs the recurrence step by
//   step, so it honours state0, takes any S and stays finite for any w in
//   (0, 1).
//   Bound on the H100: operations at prefill (3 f32 operations per state
//   element per step: the y product, the decay and the k v^T update, on
//   CUDA cores: the f32 contract rules out TF32 tensor cores), bytes at
//   decode (S = 1: the f32 state is read and written once, 8.4 MB at B = 8).
//   Design: a thread owns one value column and four keys of one (row, head):
//   its part of S (4 floats) lives in registers for the whole sequence, and
//   the hd / 4 threads of a column leave their partial sums of y_t[v] in
//   shared memory. A 256-thread block owns 16 value columns (hd 64; all 32
//   at hd 32), so B * H * hd / 16 blocks run (512 at prefill with B = 1,
//   H = 64: 16 warps per SM). Latency, not arithmetic, bounds a sequential
//   recurrence at B = 1: with a quarter of the key axis per thread there
//   are only 4 warps per SM, one per scheduler, and each step waits on its
//   own loads, so the key axis is split finer to put four warps on each
//   scheduler. A warp holds 16
//   consecutive columns of two key groups: its state loads are 64-byte runs
//   of a row, its loads of r, k and w broadcast, and its partial-sum stores
//   hit 32 banks. Time runs in chunks of 32 steps: r, k and w of a chunk
//   (all hd keys) and v (the block's columns) are staged in shared memory
//   as f32; the bonus sum_k r_t[k] u[k] k_t[k] of each step is reduced once
//   per block; the next chunk's loads are in flight in registers (bf16 kept
//   raw, widened only when staged) while this chunk runs. Nothing waits
//   inside a step: a thread stores its partial sum and goes on (the state
//   update is its only dependence across steps); after the chunk a pass
//   sums the partials of each (t, v) and writes y.
//   The state is read once at the start and written once at the end, by
//   the thread that owns each element, so state_out may be state0 itself:
//   the decode step updates the cache's state slice in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps
constexpr int kKK = 4;         // keys per thread
constexpr int kT = 32;         // time steps per staged chunk

enum DType { kF32 = 0, kBF16 = 1 };

// Four consecutive elements: one 16-byte load (f32) or one 8-byte load
// (bf16) into a raw register value, widened to float4 only where it is
// used, so that a load in flight does not stall the warp. The address must
// be aligned to the load's size.
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static float4 widen(Raw x) { return x; }
};
template <> struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  // little-endian: element 2k in the low half of word k
  __device__ __forceinline__ static float4 widen(Raw x) {
    return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  }
};

template <int HD>
struct Layout {
  static constexpr int KS = HD / kKK;                  // threads per value column
  static constexpr int VB = kThreads / KS;             // value columns per block
  static constexpr int RG = kT * HD / 4 / kThreads;    // float4 groups per thread: r, k, w
  static constexpr int VGROUPS = kT * VB / 4;          // float4 groups of v per chunk
  static constexpr int VG = (VGROUPS + kThreads - 1) / kThreads;
  static constexpr int BT = kThreads / kT;             // bonus: threads per step
  static constexpr int BK = HD / BT;                   // bonus: keys per thread
  static_assert(RG >= 1 && BK % 4 == 0 && HD % VB == 0, "unsupported head_dim");
  // dynamic shared memory, in floats: r, k, w (t, key), v (t, column), the
  // bonus (t), and the partial sums of y (t, key group, column)
  static constexpr int SR = 0, SK = kT * HD, SW = 2 * kT * HD, SV = 3 * kT * HD;
  static constexpr int SB = SV + kT * VB, SY = SB + kT;
  static constexpr int FLOATS = SY + kT * KS * VB;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ w, const float* __restrict__ u,
           const float* state0, float* __restrict__ y, float* state_out, int S, int H) {
  using L = Layout<HD>;
  using V = Vec4<T>;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem + L::SR;
  float* sk = smem + L::SK;
  float* sw = smem + L::SW;
  float* sv = smem + L::SV;
  float* sb = smem + L::SB;
  float* sy = smem + L::SY;

  const int vblk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cl = tid % L::VB;          // column in the block
  const int kq = tid / L::VB;          // key group: keys kq*4 .. kq*4+3
  const int col = vblk * L::VB + cl;   // value column in the head
  const size_t row_stride = static_cast<size_t>(H) * HD;  // one time step
  const size_t head_off = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * HD;

  // this thread's part of the state: S[kq*4 + j, col]
  float s[kKK];
  const size_t st_off = (static_cast<size_t>(b) * H + h) * HD * HD;
#pragma unroll
  for (int j = 0; j < kKK; ++j)
    s[j] = state0 != nullptr ? state0[st_off + static_cast<size_t>(kq * kKK + j) * HD + col]
                             : 0.f;
  // the bonus pass: thread (step tb, key group bg) sums keys bg*BK .. +BK-1
  const int tb = tid / L::BT, bg = tid % L::BT;
  float ub[L::BK];
#pragma unroll
  for (int j = 0; j < L::BK; ++j) ub[j] = u[h * HD + bg * L::BK + j];

  typename V::Raw pr[L::RG], pk[L::RG], pv[L::VG];
  float4 pw[L::RG];
  // the loads of chunk c into registers (rows past S are left unloaded)
  auto load_chunk = [&](int c) {
    const int t0 = c * kT;
#pragma unroll
    for (int i = 0; i < L::RG; ++i) {
      const int g = tid + i * kThreads;
      const int t = g / (HD / 4), c4 = (g % (HD / 4)) * 4;
      if (t0 + t < S) {
        const size_t off = head_off + static_cast<size_t>(t0 + t) * row_stride + c4;
        pr[i] = V::load(r + off);
        pk[i] = V::load(k + off);
        pw[i] = Vec4<float>::load(w + off);
      }
    }
#pragma unroll
    for (int i = 0; i < L::VG; ++i) {
      const int g = tid + i * kThreads;
      const int t = g / (L::VB / 4), c4 = (g % (L::VB / 4)) * 4;
      if (g < L::VGROUPS && t0 + t < S)
        pv[i] = V::load(v + head_off + static_cast<size_t>(t0 + t) * row_stride +
                        vblk * L::VB + c4);
    }
  };

  const int n_chunks = (S + kT - 1) / kT;
  load_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kT;
    const int nT = min(kT, S - t0);
    __syncthreads();  // the previous chunk is done with shared memory
#pragma unroll
    for (int i = 0; i < L::RG; ++i) {
      const int g = tid + i * kThreads;
      const int t = g / (HD / 4), o = g * 4;  // (t, key) rows are contiguous
      if (t < nT) {
        *reinterpret_cast<float4*>(sr + o) = V::widen(pr[i]);
        *reinterpret_cast<float4*>(sk + o) = V::widen(pk[i]);
        *reinterpret_cast<float4*>(sw + o) = pw[i];
      }
    }
#pragma unroll
    for (int i = 0; i < L::VG; ++i) {
      const int g = tid + i * kThreads;
      if (g < L::VGROUPS && g / (L::VB / 4) < nT)
        *reinterpret_cast<float4*>(sv + g * 4) = V::widen(pv[i]);
    }
    __syncthreads();
    // bonus_t = sum_k r_t[k] u[k] k_t[k]: BT threads per step, BK keys each
    {
      float acc = 0.f;
      if (tb < nT) {
#pragma unroll
        for (int j = 0; j < L::BK; j += 4) {
          const int o = tb * HD + bg * L::BK + j;
          const float4 r4 = *reinterpret_cast<const float4*>(sr + o);
          const float4 k4 = *reinterpret_cast<const float4*>(sk + o);
          acc = fmaf(r4.x * k4.x, ub[j], acc);
          acc = fmaf(r4.y * k4.y, ub[j + 1], acc);
          acc = fmaf(r4.z * k4.z, ub[j + 2], acc);
          acc = fmaf(r4.w * k4.w, ub[j + 3], acc);
        }
      }
#pragma unroll
      for (int m = 1; m < L::BT; m <<= 1) acc += __shfl_xor_sync(kFull, acc, m);
      if (bg == 0 && tb < nT) sb[tb] = acc;
    }
    if (c + 1 < n_chunks) load_chunk(c + 1);  // in flight during this chunk's steps
    // the steps read what the staging wrote before the last barrier, and
    // write only sy, which the previous chunk's final pass is done with
    const float* rr = sr + kq * kKK;
    const float* kk = sk + kq * kKK;
    const float* ww = sw + kq * kKK;
    float* syp = sy + kq * L::VB + cl;
#pragma unroll 4
    for (int t = 0; t < nT; ++t) {
      const float4 r4 = *reinterpret_cast<const float4*>(rr + t * HD);
      const float4 k4 = *reinterpret_cast<const float4*>(kk + t * HD);
      const float4 w4 = *reinterpret_cast<const float4*>(ww + t * HD);
      const float vv = sv[t * L::VB + cl];
      // y reads the state before this step's update
      const float a = fmaf(r4.x, s[0], r4.y * s[1]) + fmaf(r4.z, s[2], r4.w * s[3]);
      s[0] = fmaf(s[0], w4.x, k4.x * vv);
      s[1] = fmaf(s[1], w4.y, k4.y * vv);
      s[2] = fmaf(s[2], w4.z, k4.z * vv);
      s[3] = fmaf(s[3], w4.w, k4.w * vv);
      syp[t * L::KS * L::VB] = a;
    }
    __syncthreads();
    // y_t[v] = the key groups' partial sums + v_t[v] * bonus_t
    float* yp = y + head_off + static_cast<size_t>(t0) * row_stride + vblk * L::VB;
    for (int e = tid; e < nT * L::VB; e += kThreads) {
      const int t = e / L::VB, ce = e % L::VB;
      const float* p = sy + t * L::KS * L::VB + ce;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < L::KS; ++q) acc += p[q * L::VB];
      yp[static_cast<size_t>(t) * row_stride + ce] = fmaf(sv[t * L::VB + ce], sb[t], acc);
    }
  }

#pragma unroll
  for (int j = 0; j < kKK; ++j)
    state_out[st_off + static_cast<size_t>(kq * kKK + j) * HD + col] = s[j];
}

template <typename T, int HD>
cudaError_t launch_wkv_hd(const void* r, const void* k, const void* v, const float* w,
                          const float* u, const float* state0, float* y, float* state_out,
                          int B, int S, int H, cudaStream_t stream) {
  using L = Layout<HD>;
  const int smem = L::FLOATS * static_cast<int>(sizeof(float));
  auto kernel = wkv_kernel<T, HD>;
  if (smem > 48 * 1024) {  // above 48 KB dynamic shared memory must be allowed first
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(HD / L::VB, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      state0, y, state_out, S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wkv(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* state0, float* y, float* state_out, int B,
                       int S, int H, int hd, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_wkv_hd<T, 64>(r, k, v, w, u, state0, y, state_out, B, S, H, stream);
  if (hd == 32)
    return launch_wkv_hd<T, 32>(r, k, v, w, u, state0, y, state_out, B, S, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). r, k and v share
// one dtype (0: f32, 1: bf16); state0 may be null (a zero state) and may
// equal state_out (updated in place).
int wkv_rwkv6(int dtype, const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* state0, float* y, float* state_out, int B, int S,
              int H, int hd, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_wkv<float>(r, k, v, w, u, state0, y, state_out, B, S, H,
                                                hd, st));
    case kBF16:
      return static_cast<int>(launch_wkv<__nv_bfloat16>(r, k, v, w, u, state0, y, state_out,
                                                        B, S, H, hd, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
