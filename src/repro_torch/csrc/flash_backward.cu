// Backward of GQA flash attention for Hopper (sm_90a), in every form the
// forward kernel (dense_attention.cu) takes, bound to PyTorch through a
// plain C interface (ctypes). Built by repro_torch/kernels/_build.py; the
// autograd Function of repro_torch/kernels/flash_attention.py runs it for
// CUDA tensors.
//
// Replaces repro/models/attention.py::_flash_backward, the custom_vjp rule of
// blockwise_attention: plain jnp, no Pallas kernel, a two-pass recompute
// backward. From q (B, S, H, HDK), k (B, S_kv, KVH, HDK), v (B, S_kv, KVH,
// HDV), the forward's output o and its gradient do (B, S, H, HDV) it
// computes dq, dk and dv in the inputs' dtype, everything in f32 inside: the
// row's log-sum-exp L (recomputed: the forward kernel writes none), delta =
// sum do * o, the probabilities p = exp(scale q.k - L), dp = do . v, ds = p
// (dp - delta) scale, dq = sum_keys ds k, dk = sum_rows ds q and dv =
// sum_rows p do, the group's query heads summed into their KV head.
//
// Forms (those of the forward): causal or not; a sliding window w (a key is
// seen by rows row - w < col, and col <= row where causal); a chunk c (col /
// c == row / c); keys of another length than the queries (S_kv != S: cross
// attention, non-causal, no window or chunk, at head dims (64, 64)); head
// dims (64, 64), (128, 128) and MLA's (96, 64); any S >= 1, any G = H / KVH.
// The tile ranges come from one rule per direction: KvTiles (the key tiles a
// query tile sees: the forward's KvRange) and QTiles (its transpose, the
// query tiles that see a key tile); the per-element predicate key_ok is the
// forward's, copied. Whether a chunk applies is a template argument
// (CHUNKED), so the kernels without one carry no chunk term.
//
// Bound on the H100: operations. Five products over each visible (query,
// key) pair of a head, three hd deep (q.k, ds^T q, ds k) and two hd_v deep
// (do.v, p^T do; q.k recomputed in several passes counts once, as the
// function needs it once), against each tensor read or written once: at
// qwen2.5-3b's training microbatch (B 1, S 2048 causal, H 16 / KVH 2, hd
// 128) some 1700 flops a byte, 0.043 ms at the bf16 peak.
//
// What bounds a straightforward form of this backward, and what the design
// does about it: f32 FMAs on the CUDA cores (about a fifteenth of the bf16
// tensor-core rate): bf16 products on the tensor cores; one block per (key
// tile, KV head) leaves most SMs idle at a training microbatch (64 blocks at
// B 1, S 2048, KVH 2): a block per query head, with a deterministic sum;
// probabilities broadcast by one shuffle per key and row: they stay in the
// accumulator fragments, which are the next product's A operand; tiles
// widened to f32 and staged synchronously: bf16 tiles by cp.async, the next
// tile's copies in flight during this one's products.
//
// bf16 design: the products on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulators; ldmatrix fragments from 16-byte padded rows, so the eight
// rows of a phase fall on distinct banks), every tile staged as bf16 by
// cp.async, double-buffered so the next tile's copies overlap this one's
// products. S = Q K^T and dP = dO V^T take bf16 inputs, whose products are
// exact in f32. P and dS are f32; they enter the products dV += P^T dO, dK +=
// dS^T Q and dQ += dS K in two bf16 parts, hi = bf16(x) and lo = bf16(x -
// hi) (about 16 bits, as the forward's P), so the result stays within one
// bf16 rounding of the f32 contract. Exponentials by the SFU's ex2 with
// log2(e) folded into the scale (L kept in log2 units). Four kernels, no
// atomics, so two calls give equal bits:
//   (a) rows: one 128-thread block (4 warps of 16 rows) per (query tile,
//       head, batch row): L of each row by one online pass over the key
//       tiles it sees (S only, no value product), and delta. L and delta are
//       (B, H, Sp) f32, Sp = S rounded up to the tile; rows past S get L =
//       +inf (so their p is 0) and delta = 0.
//   (b) dK/dV: one block per (key tile, query head, batch row), so the card
//       fills at small B (qwen's microbatch: 32 x 16 = 512 blocks, two a SM
//       by shared memory: about two waves on 132 SMs). Warp w owns keys 16w
//       .. +15 of the tile, whose K and V stay in shared memory; the query
//       tiles that see it stream through the double buffer with their L and
//       delta, 32 queries at a time (s^T and dp^T of 16 keys x 32 queries in
//       registers beside the dK and dV accumulators). With G > 1 it writes
//       f32 partials to a (B, S_kv, H, hd) workspace; with G = 1 it writes dk
//       and dv directly.
//   (c) group sum (G > 1 only): dk and dv of each KV head = the sum of its G
//       partials, in head order, in the inputs' dtype.
//   (d) dQ: one block per (query tile, head, batch row), heaviest first; the
//       key tiles it sees stream through the double buffer, a whole 64-key
//       tile a step; dq in registers.
// f32 design: the same three passes and grids on the CUDA cores (TF32 tensor
// cores keep about 10 bits of each input and would break the f32 tolerance):
// 256 threads (16 x 16) per block, f32 tiles padded by 4 floats, each thread
// a 4 x 4 score tile and a 4 x hd/16 slice of its accumulators; a product
// with a tile's probabilities takes each from the half-warp that holds it by
// shuffles. Rows and keys past S / S_kv are zeros and masked, so neither need
// be a multiple of 64.
#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kTile = 64;          // rows of a query tile and of a key tile
constexpr int kBThreads = 256;     // f32 kernels: 16 x 16 threads
constexpr int kTCWarps = 4;        // bf16 kernels: 16 rows (or keys) a warp
constexpr int kTCThreads = 32 * kTCWarps;
// queries a bf16 dK/dV step takes, keys a bf16 dQ step takes: the widths
// kernel_ab's bwd_subq64 / bwd_subk32 variants time against each other
constexpr int kSubQ = 32;
constexpr int kSubK = 64;

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int tiles(int n) { return (n + kTile - 1) / kTile; }

// ---------------------------------------------------------------------------
// the forms: tile ranges and the per-element predicate
// ---------------------------------------------------------------------------

// S queries over Skv keys; causal, window (<= 0: none), chunk (<= 0: none)
struct Form {
  int S, Skv, causal, window, chunk;
};

// The key tiles [begin, end) that query tile qt (rows q0 .. q0 + kTile - 1)
// sees, the forward's KvRange: causal stops at the diagonal tile; a window
// starts at the tile of the first row's first key (q0 - window + 1); a chunk
// (CHUNKED only) starts at the tile of the first row's chunk and ends after
// the last row's chunk.
template <bool CHUNKED>
struct KvTiles {
  int begin, end;
  __host__ __device__ KvTiles(int qt, const Form& f) {
    const int q0 = qt * kTile, n_kv = tiles(f.Skv);
    end = f.causal ? imin(qt + 1, n_kv) : n_kv;
    begin = f.window > 0 ? imax(q0 - f.window + 1, 0) / kTile : 0;
    if constexpr (CHUNKED) {
      begin = q0 / f.chunk * f.chunk / kTile;
      const int last_row = imin(q0 + kTile, f.S) - 1;
      end = imin(end, tiles((last_row / f.chunk + 1) * f.chunk));
    }
  }
};

// Its transpose: the query tiles [begin, end) that see key tile kt (keys k0 ..
// k_last): causal starts at the diagonal tile; a window ends at the tile of
// the last key's last row (k_last + window - 1); a chunk starts at the tile
// of the first key's chunk and ends after the last key's.
template <bool CHUNKED>
struct QTiles {
  int begin, end;
  __host__ __device__ QTiles(int kt, const Form& f) {
    const int k0 = kt * kTile, k_last = imin(k0 + kTile, f.Skv) - 1, n_q = tiles(f.S);
    begin = f.causal ? kt : 0;
    end = f.window > 0 ? imin((k_last + f.window - 1) / kTile + 1, n_q) : n_q;
    if constexpr (CHUNKED) {
      begin = imax(begin, k0 / f.chunk * f.chunk / kTile);
      end = imin(end, tiles((k_last / f.chunk + 1) * f.chunk));
    }
  }
};

// Whether query row may attend key col (the forward's key_ok); rows past S
// are left to L = +inf.
template <bool CHUNKED>
__device__ __forceinline__ bool key_ok(int row, int col, const Form& f) {
  return col < f.Skv && (!f.causal || col <= row) && (f.window <= 0 || col > row - f.window) &&
         (!CHUNKED || col / f.chunk == row / f.chunk);
}

// Whether the tile pair (query tile at q0, key tile at k0) can hold a masked
// pair: only those run key_ok per element.
template <bool CHUNKED>
__device__ __forceinline__ bool tile_edge(int q0, int k0, const Form& f) {
  return k0 + kTile > f.Skv || (f.causal && k0 + kTile - 1 > q0) ||
         (f.window > 0 && k0 <= q0 + kTile - 1 - f.window) ||
         (CHUNKED && imin(k0, q0) / f.chunk != (imax(k0, q0) + kTile - 1) / f.chunk);
}

template <typename T> __device__ __forceinline__ void store2(T* p, float x, float y);
template <> __device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <> __device__ __forceinline__ void store2<bf16>(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------------------
// f32 kernels on the CUDA cores
// ---------------------------------------------------------------------------

// Four consecutive elements as floats in one load (8- or 16-byte aligned).
template <typename T> struct Load4;
template <> struct Load4<float> {
  __device__ __forceinline__ static float4 run(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <> struct Load4<bf16> {
  __device__ __forceinline__ static float4 run(const bf16* p) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  }
};

// The columns of an HD-wide accumulator a thread (lane tx of its half-warp)
// owns: NG groups of VW consecutive columns, group g at 16 VW g + VW tx (VW 4
// where HD is a multiple of 64, else 2: HD 96 takes 3 groups of 2).
template <int HD>
struct Cols {
  static constexpr int VW = HD % 64 == 0 ? 4 : 2;
  static constexpr int NG = HD / (16 * VW);
  static_assert(NG * 16 * VW == HD, "whole groups");
  __device__ __forceinline__ static int at(int g, int tx) { return 16 * VW * g + VW * tx; }
};

// rows [row0, row0 + kTile) of a (.., rows, heads, HD) tensor at head `head`
// into a padded f32 tile (row stride HD + 4); rows at or past `rows` are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int rows, int heads, int head) {
  constexpr int kQuads = HD / 4;
  for (int e = threadIdx.x; e < kTile * kQuads; e += kBThreads) {
    const int r = e / kQuads, d = (e % kQuads) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) x = Load4<T>::run(src + ((size_t)(row0 + r) * heads + head) * HD + d);
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + d) = x;
  }
}

// acc[i][j] = row (ty + 16i) of tile A . row (tx + 16j) of tile B, over HD
// columns (both tiles in shared memory with row stride HD + 4)
template <int HD>
__device__ __forceinline__ void tile_products(float (&acc)[4][4], const float* A,
                                              const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * (HD + 4) + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * (HD + 4) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        acc[i][j] = x;
      }
  }
}

// out[i][VW g + c] += sum_kk w[i][kk] M[kk][Cols::at(g, tx) + c]: w[i][kk] is
// the value of row i at column kk of the 16 x 16 layout (held in w[i][kk /
// 16] by lane kk % 16 of this half-warp), M a tile in shared memory (row
// stride HD + 4)
template <int HD>
__device__ __forceinline__ void shuffle_products(float (&out)[4][HD / 16], const float (&w)[4][4],
                                                 const float* M, int tx, int lane) {
  using C = Cols<HD>;
#pragma unroll  // whole: w[i][kk / 16] must stay in registers
  for (int kk = 0; kk < kTile; ++kk) {
    const int src = (lane & 16) | (kk & 15);
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __shfl_sync(kFull, w[i][kk / 16], src);
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      float m[C::VW];
      const float* row = M + kk * (HD + 4) + C::at(g, tx);
      if constexpr (C::VW == 4) {
        const float4 x = *reinterpret_cast<const float4*>(row);
        m[0] = x.x; m[1] = x.y; m[2] = x.z; m[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(row);
        m[0] = x.x; m[1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C::VW; ++c) out[i][C::VW * g + c] = fmaf(p[i], m[c], out[i][C::VW * g + c]);
    }
  }
}

// rows (ty + 16i) of an accumulator to rows row0 + ty + 16i (< rows) of a
// (.., rows, heads, HD) tensor at head `head`
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[4][HD / 16],
                                           int row0, int rows, int heads, int head, int ty,
                                           int tx) {
  using C = Cols<HD>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= rows) continue;
    T* p = dst + ((size_t)row * heads + head) * HD;
#pragma unroll
    for (int g = 0; g < C::NG; ++g)
#pragma unroll
      for (int c = 0; c < C::VW; ++c) p[C::at(g, tx) + c] = from_f32<T>(acc[i][C::VW * g + c]);
  }
}

// (a) L (natural units) and delta of the rows of query tile qt, head
// blockIdx.y, batch row blockIdx.z
template <typename T, int HDK, int HDV, bool CHUNKED>
__global__ void __launch_bounds__(kBThreads)
fb_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
               const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
               Form f, int H, int KVH, int Sp, float scale) {
  static_assert(HDV % 64 == 0, "delta's column layout");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (HDK + 4);
  const int qt = f.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * kTile;
  load_tile<T, HDK>(Qs, q + (size_t)b * f.S * H * HDK, q0, f.S, H, h);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const T* kb = k + (size_t)b * f.Skv * KVH * HDK;
  const KvTiles<CHUNKED> kv(qt, f);
  for (int kt = kv.begin; kt < kv.end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous key tile is no longer read (and Q is in)
    load_tile<T, HDK>(Ks, kb, k0, f.Skv, KVH, kvh);
    __syncthreads();
    float s[4][4];
    tile_products<HDK>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = key_ok<CHUNKED>(row, k0 + tx + 16 * j, f) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      // m_new is -inf only while the row has seen no key: then every s is
      // -inf, the sum 0 and l stays 0
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
#pragma unroll
      for (int w = 8; w > 0; w /= 2) sum += __shfl_xor_sync(kFull, sum, w);
      l[i] = l[i] * (m[i] == -INFINITY ? 0.f : expf(m[i] - m_new)) + sum;
      m[i] = m_new;
    }
  }

  // delta = sum over the value dims of do * o, in f32: lane tx of the
  // half-warp of row ty + 16i reads columns 64g + 4tx .. +3
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float d = 0.f;
    if (row < f.S) {
      const size_t at = ((size_t)b * f.S + row) * H * HDV + (size_t)h * HDV;
#pragma unroll
      for (int g = 0; g < HDV / 64; ++g) {
        const float4 x = Load4<T>::run(dout + at + 64 * g + 4 * tx);
        const float4 y = Load4<T>::run(o + at + 64 * g + 4 * tx);
        d = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, d))));
      }
    }
#pragma unroll
    for (int w = 8; w > 0; w /= 2) d += __shfl_xor_sync(kFull, d, w);
    if (tx == 0) {
      const size_t at = ((size_t)b * H + h) * Sp + row;
      lse[at] = row < f.S ? m[i] + logf(l[i]) : INFINITY;
      delta[at] = row < f.S ? d : 0.f;
    }
  }
}

// (b) dk and dv of key tile blockIdx.x from query head blockIdx.y, batch row
// blockIdx.z, over the query tiles that see it; to dk / dv at (b, key, head)
// with H heads a row: the workspace (G > 1) or the outputs (G = 1)
template <typename T, int HDK, int HDV, bool CHUNKED>
__global__ void __launch_bounds__(kBThreads, 1)
fb_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
               Form f, int H, int KVH, int Sp, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Qs = Ks + kTile * (HDK + 4);
  float* Vs = Qs + kTile * (HDK + 4);
  float* dOs = Vs + kTile * (HDV + 4);
  float* Ls = dOs + kTile * (HDV + 4);
  float* Ds = Ls + kTile;
  const int kt = blockIdx.x;  // the first key tiles are seen by the most query tiles (causal)
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid % 32;
  const int k0 = kt * kTile;
  load_tile<T, HDK>(Ks, k + (size_t)b * f.Skv * KVH * HDK, k0, f.Skv, KVH, kvh);
  load_tile<T, HDV>(Vs, v + (size_t)b * f.Skv * KVH * HDV, k0, f.Skv, KVH, kvh);

  float dk_acc[4][HDK / 16], dv_acc[4][HDV / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < HDK / 16; ++c) dk_acc[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < HDV / 16; ++c) dv_acc[a][c] = 0.f;
  }
  const T* qb = q + (size_t)b * f.S * H * HDK;
  const T* dob = dout + (size_t)b * f.S * H * HDV;
  const float* lse_h = lse + ((size_t)b * H + h) * Sp;
  const float* delta_h = delta + ((size_t)b * H + h) * Sp;
  const QTiles<CHUNKED> qr(kt, f);
  for (int qt = qr.begin; qt < qr.end; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous query tile is no longer read
    load_tile<T, HDK>(Qs, qb, q0, f.S, H, h);
    load_tile<T, HDV>(dOs, dob, q0, f.S, H, h);
    if (tid < kTile) {  // padded to the tile: rows past S hold L = +inf, delta 0
      Ls[tid] = lse_h[q0 + tid];
      Ds[tid] = delta_h[q0 + tid];
    }
    __syncthreads();
    // transposed: rows are keys ty + 16a, columns queries tx + 16c
    float p[4][4], ds[4][4];
    tile_products<HDK>(p, Ks, Qs, ty, tx);
    tile_products<HDV>(ds, Vs, dOs, ty, tx);  // dp^T
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = tx + 16 * c;
        const bool ok = key_ok<CHUNKED>(q0 + qi, k0 + ty + 16 * a, f);
        p[a][c] = ok ? expf(p[a][c] * scale - Ls[qi]) : 0.f;
        ds[a][c] = p[a][c] * (ds[a][c] - Ds[qi]) * scale;
      }
    shuffle_products<HDV>(dv_acc, p, dOs, tx, lane);
    shuffle_products<HDK>(dk_acc, ds, Qs, tx, lane);
  }
  store_rows<float, HDK>(dk + (size_t)b * f.Skv * H * HDK, dk_acc, k0, f.Skv, H, h, ty, tx);
  store_rows<float, HDV>(dv + (size_t)b * f.Skv * H * HDV, dv_acc, k0, f.Skv, H, h, ty, tx);
}

// (d) dq of query tile qt (heaviest first), head blockIdx.y, batch row
// blockIdx.z, over the key tiles it sees
template <typename T, int HDK, int HDV, bool CHUNKED>
__global__ void __launch_bounds__(kBThreads, 1)
fb_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, Form f, int H, int KVH, int Sp,
             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (HDK + 4);
  float* dOs = Ks + kTile * (HDK + 4);
  float* Vs = dOs + kTile * (HDV + 4);
  const int qt = f.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid % 32;
  const int q0 = qt * kTile;
  load_tile<T, HDK>(Qs, q + (size_t)b * f.S * H * HDK, q0, f.S, H, h);
  load_tile<T, HDV>(dOs, dout + (size_t)b * f.S * H * HDV, q0, f.S, H, h);
  float L[4], D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t at = ((size_t)b * H + h) * Sp + q0 + ty + 16 * i;
    L[i] = lse[at];
    D[i] = delta[at];
  }
  float dq_acc[4][HDK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HDK / 16; ++c) dq_acc[i][c] = 0.f;

  const T* kb = k + (size_t)b * f.Skv * KVH * HDK;
  const T* vb = v + (size_t)b * f.Skv * KVH * HDV;
  const KvTiles<CHUNKED> kv(qt, f);
  for (int kt = kv.begin; kt < kv.end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous key tile is no longer read (and Q, dO are in)
    load_tile<T, HDK>(Ks, kb, k0, f.Skv, KVH, kvh);
    load_tile<T, HDV>(Vs, vb, k0, f.Skv, KVH, kvh);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_products<HDK>(p, Qs, Ks, ty, tx);
    tile_products<HDV>(ds, dOs, Vs, ty, tx);  // dp
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = key_ok<CHUNKED>(q0 + ty + 16 * i, k0 + tx + 16 * j, f);
        const float pij = ok ? expf(p[i][j] * scale - L[i]) : 0.f;
        ds[i][j] = pij * (ds[i][j] - D[i]) * scale;
      }
    shuffle_products<HDK>(dq_acc, ds, Ks, tx, lane);
  }
  store_rows<T, HDK>(dq + (size_t)b * f.S * H * HDK, dq_acc, q0, f.S, H, h, ty, tx);
}

__host__ __device__ constexpr int rows_smem_bytes(int hdk) {
  return 2 * kTile * (hdk + 4) * 4;
}
__host__ __device__ constexpr int dkdv_smem_bytes(int hdk, int hdv) {
  return (2 * kTile * (hdk + 4) + 2 * kTile * (hdv + 4) + 2 * kTile) * 4;
}
__host__ __device__ constexpr int dq_smem_bytes(int hdk, int hdv) {
  return (2 * kTile * (hdk + 4) + 2 * kTile * (hdv + 4)) * 4;
}

// ---------------------------------------------------------------------------
// bf16 kernels on the tensor cores
// ---------------------------------------------------------------------------
//
// Fragments (mma.sync m16n8k16): lane l holds, of every 16 x 8 accumulator,
// rows l / 4 and l / 4 + 8 at columns 2 (l % 4) .. +1. A fragments of a
// [row][dim] tile by ldmatrix (matrix i: rows (i % 2) * 8, dims (i / 2) *
// 8); B fragments of a [n][dim] tile by ldmatrix (matrix i: n (i / 2) * 8,
// dims (i % 2) * 8: r0, r1 of n-tile n, r2, r3 of n + 1); B fragments of a
// [k][dim] tile (the product's depth along the tile's rows) by ldmatrix.trans
// (matrix i: rows (i % 2) * 8, dims (i / 2) * 8). The accumulators of two
// 8-column tiles 2j, 2j + 1 are the A fragment of depth step j.

// rows [row0, row0 + kTile) of a (.., rows, heads, HD) bf16 tensor at head
// `head` into a padded shared tile (row stride HD + 8), by cp.async; rows at
// or past `rows` are zeros
template <int HD>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                        int rows, int heads, int head) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  static_assert(kTile * kChunks % kTCThreads == 0, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kTCThreads; ++i) {
    const int e = threadIdx.x + i * kTCThreads;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool in = row0 + r < rows;
    const bf16* g = src + ((size_t)(in ? row0 + r : 0) * heads + head) * HD + c;
    cp_async16(dst + r * (HD + 8) + c, g, in ? 16 : 0);
  }
}

// kTile floats (16-byte aligned: L and delta are padded to whole tiles) by
// cp.async
__device__ __forceinline__ void cp_row_vec(float* dst, const float* __restrict__ src) {
  if (threadIdx.x < kTile / 4) cp_async16(dst + 4 * threadIdx.x, src + 4 * threadIdx.x, 16);
}

// the A fragment of rows r0 .. r0 + 15 at dims d0 .. d0 + 15 of a tile with
// row stride RS
template <int RS>
__device__ __forceinline__ void ld_a(unsigned (&a)[4], const bf16* tile, int r0, int d0,
                                     int lane) {
  ldsm_x4(a, tile + (r0 + lane % 16) * RS + d0 + (lane / 16) * 8);
}
// the B fragments of n-tiles at n0, n0 + 8 (rows of the tile) at dims d0 ..
// d0 + 15
template <int RS>
__device__ __forceinline__ void ld_b(unsigned (&b)[4], const bf16* tile, int n0, int d0,
                                     int lane) {
  ldsm_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * RS + d0 + ((lane / 8) % 2) * 8);
}
// the B fragments of dims d0, d0 + 8 over depth rows r0 .. r0 + 15
template <int RS>
__device__ __forceinline__ void ld_b_trans(unsigned (&b)[4], const bf16* tile, int r0, int d0,
                                           int lane) {
  ldsm_x4_trans(b, tile + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * RS + d0 + (lane / 16) * 8);
}

// acc (16 rows x NT 8-column tiles) = A (rows r0.., HD dims of tile A) times
// the rows n0 .. n0 + 8 NT - 1 of tile B, over HD dims
template <int HD, int NT>
__device__ __forceinline__ void tc_scores(float (&acc)[NT][4], const bf16* A, int r0,
                                          const bf16* B, int n0, int lane) {
  constexpr int RS = HD + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    unsigned a[4];
    ld_a<RS>(a, A, r0, ks * 16, lane);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      unsigned bf[4];
      ld_b<RS>(bf, B, n0 + n * 8, ks * 16, lane);
      mma_bf16(acc[n], a, bf[0], bf[1]);
      mma_bf16(acc[n + 1], a, bf[2], bf[3]);
    }
  }
}

// out (16 rows x HD dims) += W (16 rows x 16 NJ f32, accumulator layout, in
// two bf16 parts) times rows r0 .. r0 + 16 NJ - 1 of tile M (HD dims)
template <int HD, int NJ>
__device__ __forceinline__ void tc_split_product(float (&out)[HD / 8][4],
                                                 const float (&w)[2 * NJ][4], const bf16* M,
                                                 int r0, int lane) {
  constexpr int RS = HD + 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    unsigned hi[4], lo[4];
    split_bf16(w[2 * j][0], w[2 * j][1], hi[0], lo[0]);
    split_bf16(w[2 * j][2], w[2 * j][3], hi[1], lo[1]);
    split_bf16(w[2 * j + 1][0], w[2 * j + 1][1], hi[2], lo[2]);
    split_bf16(w[2 * j + 1][2], w[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      unsigned bf[4];
      ld_b_trans<RS>(bf, M, r0 + 16 * j, n * 8, lane);
      mma_bf16(out[n], hi, bf[0], bf[1]);
      mma_bf16(out[n], lo, bf[0], bf[1]);
      mma_bf16(out[n + 1], hi, bf[2], bf[3]);
      mma_bf16(out[n + 1], lo, bf[2], bf[3]);
    }
  }
}

// (a) L (log2 units: scores scaled by scale log2(e)) and delta of the rows
// of query tile qt, head blockIdx.y, batch row blockIdx.z; warp w owns rows
// q0 + 16w .. +15
template <int HDK, int HDV, bool CHUNKED>
__global__ void __launch_bounds__(kTCThreads)
fb_rows_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  float* __restrict__ lse, float* __restrict__ delta, Form f, int H, int KVH,
                  int Sp, float scale_log2) {
  constexpr int RK = HDK + 8, KSTEPS = HDK / 16, NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* stage0 = Qs + kTile * RK;  // key tile i at stage0 + (i & 1) kTile RK
  const int qt = f.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kTile;
  const bf16* kb = k + (size_t)b * f.Skv * KVH * HDK;
  const KvTiles<CHUNKED> kv(qt, f);

  cp_tile<HDK>(Qs, q + (size_t)b * f.S * H * HDK, q0, f.S, H, h);
  cp_tile<HDK>(stage0, kb, kv.begin * kTile, f.Skv, KVH, kvh);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + lane / 4, row_b = row_a + 8;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  unsigned qf[KSTEPS][4];
  for (int kt = kv.begin; kt < kv.end; ++kt) {
    const int it = kt - kv.begin;
    const bf16* Ks = stage0 + (it & 1) * kTile * RK;
    if (kt + 1 < kv.end) {
      cp_tile<HDK>(stage0 + ((it + 1) & 1) * kTile * RK, kb, (kt + 1) * kTile, f.Skv, KVH, kvh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, first, Q) has landed for every thread
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) ld_a<RK>(qf[ks], Qs, warp * 16, ks * 16, lane);
    }
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned bf[4];
        ld_b<RK>(bf, Ks, n * 8, ks * 16, lane);
        mma_bf16(s[n], qf[ks], bf[0], bf[1]);
        mma_bf16(s[n + 1], qf[ks], bf[2], bf[3]);
      }
    const int k0 = kt * kTile;
    const bool edge = tile_edge<CHUNKED>(q0, k0, f);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge && !key_ok<CHUNKED>(e < 2 ? row_a : row_b, k0 + n * 8 + (lane % 4) * 2 + (e & 1), f))
          x = -INFINITY;
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {  // the quad of lanes that shares a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, w));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a new max is -inf only while no key of the row was valid yet
    const float alpha_a = mn_a == -INFINITY ? 1.f : ex2(m_a - mn_a);
    const float alpha_b = mn_b == -INFINITY ? 1.f : ex2(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sum_a += (s[n][0] == -INFINITY ? 0.f : ex2(s[n][0] - mn_a)) +
               (s[n][1] == -INFINITY ? 0.f : ex2(s[n][1] - mn_a));
      sum_b += (s[n][2] == -INFINITY ? 0.f : ex2(s[n][2] - mn_b)) +
               (s[n][3] == -INFINITY ? 0.f : ex2(s[n][3] - mn_b));
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // nothing in flight at exit
#pragma unroll
  for (int w = 1; w < 4; w *= 2) {
    l_a += __shfl_xor_sync(kFull, l_a, w);
    l_b += __shfl_xor_sync(kFull, l_b, w);
  }
  const size_t base = ((size_t)b * H + h) * Sp;
  if (lane % 4 == 0) {
    lse[base + row_a] = row_a < f.S ? m_a + __log2f(l_a) : INFINITY;
    lse[base + row_b] = row_b < f.S ? m_b + __log2f(l_b) : INFINITY;
  }

  // delta: two threads a row, each half of the value dims in 16-byte loads
  const int row = q0 + threadIdx.x / 2, half = threadIdx.x % 2;
  float d = 0.f;
  if (row < f.S) {
    const size_t at = ((size_t)b * f.S + row) * H * HDV + (size_t)h * HDV + half * (HDV / 2);
#pragma unroll
    for (int c = 0; c < HDV / 16; ++c) {
      float x[8], y[8];
      Load16<bf16, 8>::run(dout + at + 8 * c, x);
      Load16<bf16, 8>::run(o + at + 8 * c, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(x[e], y[e], d);
    }
  }
  d += __shfl_xor_sync(kFull, d, 1);
  if (half == 0) delta[base + row] = row < f.S ? d : 0.f;
}

// (b) dk and dv of key tile blockIdx.x from query head blockIdx.y, batch row
// blockIdx.z, over the query tiles that see it; warp w owns keys k0 + 16w ..
// +15. Its scores are transposed (rows keys, columns queries), so that P^T
// and dS^T are the A fragments of dV += P^T dO and dK += dS^T Q. To dk / dv
// at (b, key, head) with H heads a row: f32 partials in the workspace (G >
// 1) or bf16 outputs (G = 1).
template <int HDK, int HDV, bool CHUNKED, typename OutT>
__global__ void __launch_bounds__(kTCThreads)
fb_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  OutT* __restrict__ dk, OutT* __restrict__ dv, Form f, int H, int KVH, int Sp,
                  float scale_log2, float scale) {
  constexpr int RK = HDK + 8, RV = HDV + 8;
  constexpr int QSTAGE = kTile * (RK + RV);  // one stage: a Q tile, then a dO tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = Ks + kTile * RK;
  bf16* qstage0 = Vs + kTile * RV;                                    // stage i: Q, dO
  float* lstage0 = reinterpret_cast<float*>(qstage0 + 2 * QSTAGE);    // stage i: L, delta
  const int kt = blockIdx.x;  // the first key tiles are seen by the most query tiles (causal)
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = kt * kTile;
  const bf16* qb = q + (size_t)b * f.S * H * HDK;
  const bf16* dob = dout + (size_t)b * f.S * H * HDV;
  const float* lse_h = lse + ((size_t)b * H + h) * Sp;
  const float* delta_h = delta + ((size_t)b * H + h) * Sp;
  const QTiles<CHUNKED> qr(kt, f);

  auto stage_q = [&](int qt, int i) {
    bf16* Qn = qstage0 + i * QSTAGE;
    cp_tile<HDK>(Qn, qb, qt * kTile, f.S, H, h);
    cp_tile<HDV>(Qn + kTile * RK, dob, qt * kTile, f.S, H, h);
    cp_row_vec(lstage0 + i * 2 * kTile, lse_h + qt * kTile);
    cp_row_vec(lstage0 + i * 2 * kTile + kTile, delta_h + qt * kTile);
  };
  cp_tile<HDK>(Ks, k + (size_t)b * f.Skv * KVH * HDK, k0, f.Skv, KVH, kvh);
  cp_tile<HDV>(Vs, v + (size_t)b * f.Skv * KVH * HDV, k0, f.Skv, KVH, kvh);
  if (qr.begin < qr.end) stage_q(qr.begin, 0);
  cp_async_commit();

  float dk_acc[HDK / 8][4], dv_acc[HDV / 8][4];
#pragma unroll
  for (int n = 0; n < HDK / 8; ++n) dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  const int key_a = k0 + warp * 16 + lane / 4, key_b = key_a + 8;

  for (int qt = qr.begin; qt < qr.end; ++qt) {
    const int it = qt - qr.begin;
    if (qt + 1 < qr.end) {  // the next query tile into the other stage
      stage_q(qt + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, first, K and V) has landed for every thread
    const bf16* Qs = qstage0 + (it & 1) * QSTAGE;
    const bf16* dOs = Qs + kTile * RK;
    const float* Ls = lstage0 + (it & 1) * 2 * kTile;
    const float* Ds = Ls + kTile;
    const int q0 = qt * kTile;
    const bool edge = tile_edge<CHUNKED>(q0, k0, f);
#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += kSubQ) {
      float s[kSubQ / 8][4], dp[kSubQ / 8][4];
      tc_scores<HDK, kSubQ / 8>(s, Ks, warp * 16, Qs, sub, lane);    // S^T = K Q^T
      tc_scores<HDV, kSubQ / 8>(dp, Vs, warp * 16, dOs, sub, lane);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < kSubQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = sub + n * 8 + (lane % 4) * 2 + (e & 1);
          float p = ex2(s[n][e] * scale_log2 - Ls[qi]);  // rows past S: L = +inf, p = 0
          if (edge && !key_ok<CHUNKED>(q0 + qi, e < 2 ? key_a : key_b, f)) p = 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Ds[qi]) * scale;
        }
      tc_split_product<HDV, kSubQ / 16>(dv_acc, s, dOs, sub, lane);  // dV += P^T dO
      tc_split_product<HDK, kSubQ / 16>(dk_acc, dp, Qs, sub, lane);  // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // nothing in flight at exit, even where no query tile sees the keys

  const int c0 = (lane % 4) * 2;
  OutT* dkb = dk + (size_t)b * f.Skv * H * HDK;
  OutT* dvb = dv + (size_t)b * f.Skv * H * HDV;
#pragma unroll
  for (int n = 0; n < HDK / 8; ++n) {
    if (key_a < f.Skv) store2(dkb + ((size_t)key_a * H + h) * HDK + n * 8 + c0, dk_acc[n][0], dk_acc[n][1]);
    if (key_b < f.Skv) store2(dkb + ((size_t)key_b * H + h) * HDK + n * 8 + c0, dk_acc[n][2], dk_acc[n][3]);
  }
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) {
    if (key_a < f.Skv) store2(dvb + ((size_t)key_a * H + h) * HDV + n * 8 + c0, dv_acc[n][0], dv_acc[n][1]);
    if (key_b < f.Skv) store2(dvb + ((size_t)key_b * H + h) * HDV + n * 8 + c0, dv_acc[n][2], dv_acc[n][3]);
  }
}

// (d) dq of query tile qt (heaviest first), head blockIdx.y, batch row
// blockIdx.z, over the key tiles it sees; warp w owns rows q0 + 16w .. +15
template <int HDK, int HDV, bool CHUNKED>
__global__ void __launch_bounds__(kTCThreads)
fb_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, Form f, int H, int KVH, int Sp, float scale_log2,
                float scale) {
  constexpr int RK = HDK + 8, RV = HDV + 8;
  constexpr int KSTAGE = kTile * (RK + RV);  // one stage: a K tile, then a V tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dOs = Qs + kTile * RK;
  bf16* kstage0 = dOs + kTile * RV;
  const int qt = f.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kTile;
  const bf16* kb = k + (size_t)b * f.Skv * KVH * HDK;
  const bf16* vb = v + (size_t)b * f.Skv * KVH * HDV;
  const KvTiles<CHUNKED> kv(qt, f);

  auto stage_kv = [&](int kt, int i) {
    bf16* Kn = kstage0 + i * KSTAGE;
    cp_tile<HDK>(Kn, kb, kt * kTile, f.Skv, KVH, kvh);
    cp_tile<HDV>(Kn + kTile * RK, vb, kt * kTile, f.Skv, KVH, kvh);
  };
  cp_tile<HDK>(Qs, q + (size_t)b * f.S * H * HDK, q0, f.S, H, h);
  cp_tile<HDV>(dOs, dout + (size_t)b * f.S * H * HDV, q0, f.S, H, h);
  stage_kv(kv.begin, 0);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + lane / 4, row_b = row_a + 8;
  const size_t base = ((size_t)b * H + h) * Sp;
  const float L_a = lse[base + row_a], L_b = lse[base + row_b];  // +inf past S
  const float D_a = delta[base + row_a], D_b = delta[base + row_b];
  float dq_acc[HDK / 8][4];
#pragma unroll
  for (int n = 0; n < HDK / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int kt = kv.begin; kt < kv.end; ++kt) {
    const int it = kt - kv.begin;
    if (kt + 1 < kv.end) {
      stage_kv(kt + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, first, Q and dO) has landed for every thread
    const bf16* Ks = kstage0 + (it & 1) * KSTAGE;
    const bf16* Vs = Ks + kTile * RK;
    const int k0 = kt * kTile;
    const bool edge = tile_edge<CHUNKED>(q0, k0, f);
#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += kSubK) {
      float s[kSubK / 8][4], dp[kSubK / 8][4];
      tc_scores<HDK, kSubK / 8>(s, Qs, warp * 16, Ks, sub, lane);    // S = Q K^T
      tc_scores<HDV, kSubK / 8>(dp, dOs, warp * 16, Vs, sub, lane);  // dP = dO V^T
#pragma unroll
      for (int n = 0; n < kSubK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + sub + n * 8 + (lane % 4) * 2 + (e & 1);
          float p = ex2(s[n][e] * scale_log2 - (e < 2 ? L_a : L_b));
          if (edge && !key_ok<CHUNKED>(e < 2 ? row_a : row_b, key, f)) p = 0.f;
          dp[n][e] = p * (dp[n][e] - (e < 2 ? D_a : D_b)) * scale;
        }
      tc_split_product<HDK, kSubK / 16>(dq_acc, dp, Ks, sub, lane);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // nothing in flight at exit

  bf16* dqb = dq + (size_t)b * f.S * H * HDK;
  const int c0 = (lane % 4) * 2;
#pragma unroll
  for (int n = 0; n < HDK / 8; ++n) {
    if (row_a < f.S) store2(dqb + ((size_t)row_a * H + h) * HDK + n * 8 + c0, dq_acc[n][0], dq_acc[n][1]);
    if (row_b < f.S) store2(dqb + ((size_t)row_b * H + h) * HDK + n * 8 + c0, dq_acc[n][2], dq_acc[n][3]);
  }
}

__host__ __device__ constexpr int rows_tc_smem_bytes(int hdk) {
  return 3 * kTile * (hdk + 8) * 2;
}
__host__ __device__ constexpr int dkdv_tc_smem_bytes(int hdk, int hdv) {
  return 3 * kTile * (hdk + 8 + hdv + 8) * 2 + 2 * 2 * kTile * 4;
}
__host__ __device__ constexpr int dq_tc_smem_bytes(int hdk, int hdv) {
  return 3 * kTile * (hdk + 8 + hdv + 8) * 2;
}

// ---------------------------------------------------------------------------
// (c) the group sum and the launches
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;

// dk (rows, KVH, hdk) and dv (rows, KVH, hdv) from the workspace's partials
// (rows, H, hdk) then (rows, H, hdv): each the sum of its KV head's G query
// heads, in head order
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
fb_group_sum_kernel(const float* __restrict__ ws, T* __restrict__ dk, T* __restrict__ dv,
                    size_t rows, int H, int KVH, int hdk, int hdv) {
  const int G = H / KVH;
  const size_t nk = rows * KVH * hdk, nv = rows * KVH * hdv;
  const float* ws_v = ws + rows * H * hdk;
  for (size_t e = (size_t)blockIdx.x * kSumThreads + threadIdx.x; e < nk + nv;
       e += (size_t)gridDim.x * kSumThreads) {
    const bool is_k = e < nk;
    const size_t i = is_k ? e : e - nk;
    const int hd = is_k ? hdk : hdv;
    const size_t r = i / hd, d = i % hd;  // r = row * KVH + kvh
    const float* src = (is_k ? ws : ws_v) + ((r / KVH) * H + (r % KVH) * G) * hd + d;
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += src[(size_t)g * hd];
    (is_k ? dk : dv)[i] = from_f32<T>(acc);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  float *lse, *delta, *ws;
  void *dq, *dk, *dv;
  int B, H, KVH;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel, typename... P>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   P... params) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(params...);
  return cudaGetLastError();
}

template <typename T, int HDK, int HDV, bool CHUNKED>
cudaError_t launch_backward_hd(const Args& a, const Form& f) {
  const int nq = tiles(f.S), nkv = tiles(f.Skv), Sp = nq * kTile, G = a.H / a.KVH;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 qgrid(nq, a.H, a.B), kgrid(nkv, a.H, a.B);
  // G > 1: partials (B, S_kv, H, hd) in the workspace, k's then v's
  float* ws_k = a.ws;
  float* ws_v = a.ws + (size_t)a.B * f.Skv * a.H * HDK;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const float sl2 = a.scale * 1.4426950408889634f;
    err = launch(fb_rows_tc_kernel<HDK, HDV, CHUNKED>, qgrid, kTCThreads, rows_tc_smem_bytes(HDK),
                 a.stream, q, k, o, dout, a.lse, a.delta, f, a.H, a.KVH, Sp, sl2);
    if (err != cudaSuccess) return err;
    if (G == 1)
      err = launch(fb_dkdv_tc_kernel<HDK, HDV, CHUNKED, bf16>, kgrid, kTCThreads,
                   dkdv_tc_smem_bytes(HDK, HDV), a.stream, q, k, v, dout,
                   (const float*)a.lse, (const float*)a.delta, static_cast<bf16*>(a.dk),
                   static_cast<bf16*>(a.dv), f, a.H, a.KVH, Sp, sl2, a.scale);
    else
      err = launch(fb_dkdv_tc_kernel<HDK, HDV, CHUNKED, float>, kgrid, kTCThreads,
                   dkdv_tc_smem_bytes(HDK, HDV), a.stream, q, k, v, dout,
                   (const float*)a.lse, (const float*)a.delta, ws_k, ws_v, f, a.H, a.KVH, Sp,
                   sl2, a.scale);
    if (err != cudaSuccess) return err;
    err = launch(fb_dq_tc_kernel<HDK, HDV, CHUNKED>, qgrid, kTCThreads, dq_tc_smem_bytes(HDK, HDV),
                 a.stream, q, k, v, dout, (const float*)a.lse, (const float*)a.delta,
                 static_cast<bf16*>(a.dq), f, a.H, a.KVH, Sp, sl2, a.scale);
  } else {
    err = launch(fb_rows_kernel<T, HDK, HDV, CHUNKED>, qgrid, kBThreads, rows_smem_bytes(HDK),
                 a.stream, q, k, o, dout, a.lse, a.delta, f, a.H, a.KVH, Sp, a.scale);
    if (err != cudaSuccess) return err;
    float* dk_out = G == 1 ? static_cast<float*>(a.dk) : ws_k;
    float* dv_out = G == 1 ? static_cast<float*>(a.dv) : ws_v;
    err = launch(fb_dkdv_kernel<T, HDK, HDV, CHUNKED>, kgrid, kBThreads,
                 dkdv_smem_bytes(HDK, HDV), a.stream, q, k, v, dout, (const float*)a.lse,
                 (const float*)a.delta, dk_out, dv_out, f, a.H, a.KVH, Sp, a.scale);
    if (err != cudaSuccess) return err;
    err = launch(fb_dq_kernel<T, HDK, HDV, CHUNKED>, qgrid, kBThreads, dq_smem_bytes(HDK, HDV),
                 a.stream, q, k, v, dout, (const float*)a.lse, (const float*)a.delta,
                 static_cast<T*>(a.dq), f, a.H, a.KVH, Sp, a.scale);
  }
  if (err != cudaSuccess || G == 1) return err;
  const size_t rows = (size_t)a.B * f.Skv;
  const size_t need = (rows * a.KVH * (HDK + HDV) + kSumThreads - 1) / kSumThreads;
  const int blocks = static_cast<int>(need < 132 * 16 ? need : 132 * 16);  // grid-stride
  return launch(fb_group_sum_kernel<T>, dim3(blocks), kSumThreads, 0, a.stream,
                (const float*)a.ws, static_cast<T*>(a.dk), static_cast<T*>(a.dv), rows, a.H,
                a.KVH, HDK, HDV);
}

// the head dims of the instantiations: (64, 64), (128, 128) and MLA's (96,
// 64); keys of another length than the queries (cross attention) only
// non-causal, without a window or chunk, at (64, 64)
template <typename T>
cudaError_t launch_backward(const Args& a, const Form& f, int hdk, int hdv) {
#define FB_HD(K, V)                                                                   \
  if (hdk == K && hdv == V)                                                           \
    return f.chunk > 0 ? launch_backward_hd<T, K, V, true>(a, f)                      \
                       : launch_backward_hd<T, K, V, false>(a, f);
  if (f.window > 0 && f.chunk > 0) return cudaErrorInvalidValue;
  if (f.Skv != f.S) {
    if (hdk == 64 && hdv == 64 && !f.causal && f.window <= 0 && f.chunk <= 0)
      return launch_backward_hd<T, 64, 64, false>(a, f);
    return cudaErrorInvalidValue;
  }
  FB_HD(64, 64)
  FB_HD(128, 128)
  FB_HD(96, 64)
#undef FB_HD
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the largest of the kernels of a dtype (0:
// float32, 1: bfloat16) and head dims takes.
int fb_smem_bytes(int dtype, int hdk, int hdv) {
  if (dtype == kBF16)
    return imax(rows_tc_smem_bytes(hdk), imax(dkdv_tc_smem_bytes(hdk, hdv),
                                              dq_tc_smem_bytes(hdk, hdv)));
  return imax(rows_smem_bytes(hdk), imax(dkdv_smem_bytes(hdk, hdv), dq_smem_bytes(hdk, hdv)));
}

// The kernels' tile ranges, for the CPU rule that mirrors them: kv[2 qt],
// kv[2 qt + 1] the key tiles [begin, end) query tile qt sees (KvTiles), for
// every query tile; qs[2 kt], qs[2 kt + 1] the query tiles that see key tile
// kt (QTiles), for every key tile. Returns the number of query tiles.
int fb_tile_ranges(int S, int S_kv, int causal, int window, int chunk, int* kv, int* qs) {
  const Form f{S, S_kv, causal, window, chunk};
  for (int t = 0; t < tiles(S); ++t) {
    int begin, end;
    if (chunk > 0) {
      const KvTiles<true> r(t, f);
      begin = r.begin, end = r.end;
    } else {
      const KvTiles<false> r(t, f);
      begin = r.begin, end = r.end;
    }
    kv[2 * t] = begin;
    kv[2 * t + 1] = end;
  }
  for (int t = 0; t < tiles(S_kv); ++t) {
    int begin, end;
    if (chunk > 0) {
      const QTiles<true> r(t, f);
      begin = r.begin, end = r.end;
    } else {
      const QTiles<false> r(t, f);
      begin = r.begin, end = r.end;
    }
    qs[2 * t] = begin;
    qs[2 * t + 1] = end;
  }
  return tiles(S);
}

// Returns the cudaError_t of the launches (0 on success). q (B, S, H, hdk),
// k (B, S_kv, KVH, hdk), v (B, S_kv, KVH, hdv), o and dout (B, S, H, hdv),
// dq/dk/dv like q/k/v, all in one dtype (0: float32, 1: bfloat16),
// contiguous; lse and delta: (B, H, Sp) float32 scratch, Sp = S rounded up
// to 64; ws: (B, S_kv, H, hdk + hdv) float32 scratch where H > KVH (else
// unused). causal; window <= 0: none; chunk <= 0: none (not both); S_kv != S
// only non-causal, without either, at head dims (64, 64).
int fb_flash_backward(int dtype, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, float* lse, float* delta, void* dq, void* dk, void* dv,
                      float* ws, int B, int S, int S_kv, int H, int KVH, int hdk, int hdv,
                      int causal, int window, int chunk, float scale, void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, ws, dq, dk, dv, B, H, KVH, scale,
               static_cast<cudaStream_t>(stream)};
  const Form f{S, S_kv, causal, window, chunk};
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_backward<float>(a, f, hdk, hdv));
    case kBF16:
      return static_cast<int>(launch_backward<bf16>(a, f, hdk, hdv));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
