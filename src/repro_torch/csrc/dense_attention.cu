// Dense (contiguous-cache) GQA attention kernels for Hopper (sm_90a), bound
// to PyTorch through a plain C interface (ctypes). Built by
// repro_torch/kernels/_build.py. They back the engine's dense backend.
//
// flash_attention
//   Replaces the Pallas kernel repro/kernels/flash_attention.py::
//   flash_attention (body _flash_kernel). q (B, S, H, hd) attends k/v
//   (B, S_kv, KVH, hd), causal or not, any S >= 1; scores, softmax and the
//   value product in f32, output in q's dtype. A sliding window (window >
//   0, hymba's SWA layers) also masks keys at or before row - window, the
//   mask of repro/models/attention.py::blockwise_attention(ATTN_SWA); a
//   chunk (chunk > 0, llama4's chunked-local layers) masks keys of another
//   chunk than the row's (col / chunk != row / chunk), the mask of
//   blockwise_attention(ATTN_CHUNKED_LOCAL); the Pallas kernel has neither.
//   The query/key head dim HDK and the value head dim HDV are template
//   arguments of their own: (64, 64), (128, 128), and MLA's (96, 64)
//   (minicpm3: 64 nope + 32 rope dims against 64 value dims), so the value
//   product and the output run at HDV, not at a zero-padded HDK. Keys of
//   another length than the queries (S_kv != S: whisper's cross attention
//   over the encoder's 1500 frames, the form of
//   repro/models/attention.py::blockwise_attention that its decoder runs;
//   the Pallas kernel takes S_kv = S only) go non-causal, with no window or
//   chunk, at head dims (64, 64): the query tiles still count over S, the
//   K/V tiles over S_kv, keys past S_kv are masked. Whether S_kv differs is
//   a template argument (CROSS), so the self-attention kernels compile with
//   S in its place, as before.
//   Bound on the H100: operations. A 64-query tile does 4*hd flops per key
//   per query against ~hd*4 bytes of K/V per key: hundreds of flops per byte.
//   bf16 inputs (what every serve path runs) go to the tensor cores, f32
//   inputs stay on the CUDA cores.
//   bf16 design (flash_tc_kernel): one 128-thread block per (64-query tile,
//   head, batch row), four warps of 16 query rows. The Q tile's A fragments
//   are loaded once (ldmatrix) and kept in registers; 64-key K and V tiles
//   are double-buffered in shared memory by 16-byte cp.async (zero-filled
//   past S), the next tile in flight while this one is computed, rows padded
//   by 16 bytes so that ldmatrix hits distinct banks. S = Q K^T runs on
//   mma.sync m16n8k16 (bf16 in, f32 accumulators: bf16 x bf16 products are
//   exact in f32, so only the order of summation differs from the f32
//   contract); the online softmax works on the accumulator fragments (row
//   max and sum over the quad of lanes that shares a row, ex2.approx with log2(e)
//   folded into the scale). The f32 contract keeps P in f32, which one bf16
//   rounding (8 bits) would break, so P goes to the value product in two
//   bf16 parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi) (about 16 bits),
//   packed straight from the score registers into A fragments, and two
//   mma.sync per step (V's B fragments by ldmatrix.trans) add both into one
//   f32 accumulator. Masks are applied only on tiles that can hold a masked
//   key (the diagonal, the window's first tiles, keys past S).
//   f32 design (flash_kernel): the same tiles on the CUDA cores. TF32 tensor
//   cores keep about 10 bits of each input and would not hold the f32
//   tolerance (1e-4), so each thread holds a 4 x 4 score tile (rows ty + 16i,
//   keys tx + 16j) and a 4 x hd/16 slice of the output accumulator in
//   registers, with the row max and sum, and the probabilities on their way
//   to the value product, reduced over the 16 lanes of a half-warp by
//   shuffles.
//   Both: causal blocks stop at the diagonal tile (the Pallas grid's block
//   skip), windowed blocks start at the first tile that holds a key of the
//   window, chunked blocks at the tile that holds the first key of the
//   tile's first row's chunk (and, not causal, stop after the last row's
//   chunk), and the heaviest query tiles are scheduled first. Rows and keys
//   past S are masked, so S need not be a multiple of the tile, and a query
//   tile may straddle a chunk boundary: the per-element mask runs on every
//   tile whose rows and keys do not all lie in one chunk. Whether a chunk
//   applies is a template argument (CHUNKED, chosen by the launcher from
//   chunk > 0), so the unchunked kernels carry no chunk term.
//
// decode_attention
//   Replaces the Pallas kernel repro/kernels/decode_attention.py::
//   decode_attention (body _decode_kernel). One query per row, q (B, H, hd),
//   over a contiguous cache (B, Sc, KVH, hd); slots below lengths[b] are
//   valid (lengths >= 1). Output in q's dtype.
//   Bound on the H100: bytes of K/V read (4 flops per K/V element pair per
//   query head, far below the ~295 flops per byte of the card). At the serve
//   steps' lengths (a few hundred slots a row, B 8, KVH 2) that is a few MB:
//   the time goes to how many loads are in flight and to per-block set-up,
//   not to arithmetic.
//   Design: each warp is one split of one (row, KV head): it covers the
//   slots [sp * c_b, (sp + 1) * c_b) of row b, c_b = lengths[b] / n_split
//   rounded up to whole 16-slot tiles (row_chunk), so short rows are split
//   as finely as long ones and B * KVH * n_split warps share the card
//   whatever the lengths. n_split comes from shapes alone
//   (kernels/decode_attention.py::dense_decode_split): no host sync. A warp
//   stages its 16-slot K/V tiles in a two-stage ring of its own by 16-byte
//   cp.async (no block barrier, no scalar loads) and scores each tile for
//   all the group's query heads at once: bf16 on the tensor cores (the heads
//   are the rows of one m16 A tile, P in two bf16 parts as in the flash
//   kernel), f32 on the CUDA cores with every head's state in registers. Its
//   online-softmax state stays in registers until it writes its partial;
//   a second kernel merges the splits of each (row, KV head)
//   (attention_common.cuh).
#include <type_traits>

#include "attention_common.cuh"

namespace {

// Four consecutive floats in one 16-byte load (the address must be aligned
// to it).
template <typename T> struct Load4;
template <> struct Load4<float> {
  __device__ __forceinline__ static float4 run(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

// ---------------------------------------------------------------------------
// flash attention, f32 inputs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile = 64;         // queries per block and keys per K/V tile
constexpr int kFThreads = 256;    // 16 x 16 threads: ty = tid / 16, tx = tid % 16

// Shared-memory plan (floats): Q tile (kTile x (HDK+4)) | K tile (kTile x
// (HDK+4)) | V tile (kTile x HDV). The +4 pad keeps rows 16-byte aligned and
// spreads the K rows a half-warp reads over all 32 banks.
__host__ __device__ constexpr int flash_smem_floats(int hdk, int hdv) {
  return 2 * kTile * (hdk + 4) + kTile * hdv;
}

// The K/V tiles [kt_begin, kt_end) a block of query tile qt (rows q0 .. q0 +
// kTile - 1) visits. causal: tiles past the diagonal lie wholly in the
// future; window: tiles before the first row's first key (q0 - window + 1)
// lie wholly before every row's window; chunk (CHUNKED only): tiles before
// the first row's chunk, and (not causal) after the last row's, hold no key
// of a row's chunk. CHUNKED is a template argument, so the kernels without a
// chunk compile with no chunk term at all.
template <bool CHUNKED>
struct KvRange {
  int begin, end;
  __device__ KvRange(int qt, int S, int Skv, int causal, int window, int chunk) {
    const int q0 = qt * kTile, n_kv = (Skv + kTile - 1) / kTile;
    end = causal ? min(qt + 1, n_kv) : n_kv;
    begin = window > 0 ? max(q0 - window + 1, 0) / kTile : 0;
    if constexpr (CHUNKED) {
      begin = q0 / chunk * chunk / kTile;
      const int last_row = min(q0 + kTile, S) - 1;
      end = min(end, ((last_row / chunk + 1) * chunk + kTile - 1) / kTile);
    }
  }
};

// Whether key col (of Skv keys) may be attended by query row.
template <bool CHUNKED>
__device__ __forceinline__ bool key_ok(int row, int col, int Skv, int causal, int window,
                                       int chunk) {
  return col < Skv && (!causal || col <= row) && (window <= 0 || col > row - window) &&
         (!CHUNKED || col / chunk == row / chunk);
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

template <typename T, int HDK, int HDV, bool CHUNKED, bool CROSS>
__global__ void __launch_bounds__(kFThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int S, int S_kv, int H, int KVH, int causal, int window,
             int chunk, float scale) {
  const int Skv = CROSS ? S_kv : S;  // the self-attention kernels key on S alone
  constexpr int QS = HDK + 4;     // padded row stride of the Q and K tiles
  constexpr int NG = HDV / 64;    // 4-column groups of the output a thread owns
  static_assert(HDV % 64 == 0 && HDK % 4 == 0, "the thread layout of the tiles");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * QS;
  float* Vs = Ks + kTile * QS;

  const int nq = gridDim.x;
  const int qt = causal ? nq - 1 - blockIdx.x : blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid % 32;
  const int q0 = qt * kTile;
  const T* qb = q + (size_t)b * S * H * HDK;
  const T* kb = k + (size_t)b * Skv * KVH * HDK;
  const T* vb = v + (size_t)b * Skv * KVH * HDV;

  load_tile<T, HDK>(Qs, QS, qb, q0, S, H, h);

  float m[4], l[4], o[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[i][c] = 0.f;
  }

  const KvRange<CHUNKED> kv(qt, S, Skv, causal, window, chunk);
  for (int kt = kv.begin; kt < kv.end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K/V are no longer read (and Q is in)
    load_tile<T, HDK>(Ks, QS, kb, k0, Skv, KVH, kvh);
    load_tile<T, HDV>(Vs, HDV, vb, k0, Skv, KVH, kvh);
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDK; d += 4) {
      float4 qv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv4[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv4[j].x, a);
          a = fmaf(qv[i].y, kv4[j].y, a);
          a = fmaf(qv[i].z, kv4[j].z, a);
          a = fmaf(qv[i].w, kv4[j].w, a);
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
        s[i][j] = key_ok<CHUNKED>(row, col, Skv, causal, window, chunk) ? s[i][j] * scale
                                                                        : -INFINITY;
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
        const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * HDV + 64 * g + 4 * tx);
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

  T* ob = out + (size_t)b * S * H * HDV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = ob + ((size_t)row * H + h) * HDV;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[64 * g + 4 * tx + c] = from_f32<T>(o[i][4 * g + c] * inv);
  }
}

// ---------------------------------------------------------------------------
// flash attention, bf16 inputs on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTCWarps = 4;                 // 16 query rows each
constexpr int kTCThreads = 32 * kTCWarps;

// Shared-memory plan (bf16): Q tile | stage 0: K tile, V tile | stage 1: K
// tile, V tile; the Q and K tiles kTile rows of HDK + 8 elements, the V
// tiles of HDV + 8. The 16-byte pad moves each row an odd number of 16-byte
// bank groups on (HDK = 96: 13, 128: 17; HDV = 64: 9), so the eight rows of
// an ldmatrix phase fall on distinct banks.
__host__ __device__ constexpr int flash_tc_smem_bytes(int hdk, int hdv) {
  return kTile * (3 * (hdk + 8) + 2 * (hdv + 8)) * static_cast<int>(sizeof(bf16));
}

// rows [row0, row0 + kTile) of a (.., S, heads, HD) bf16 tensor at head
// `head` into a padded shared tile, by cp.async; rows at or past S are zeros
template <int HD>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* __restrict__ src, int row0, int S,
                                        int heads, int head) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  static_assert(kTile * kChunks % kTCThreads == 0, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kTCThreads; ++i) {
    const int e = threadIdx.x + i * kTCThreads;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool in = row0 + r < S;
    const bf16* g = src + ((size_t)(in ? row0 + r : 0) * heads + head) * HD + c;
    cp_async16(dst + r * (HD + 8) + c, g, in ? 16 : 0);
  }
}

// Warp w owns query rows q0 + 16w .. +15; lane l holds, of every 16 x 8
// accumulator fragment, rows l / 4 and l / 4 + 8 at columns 2 (l % 4) .. +1.
// scale_log2 = scale * log2(e): scores and the running max are kept in
// log2 units, so p = exp2(s - m).
template <int HDK, int HDV, bool CHUNKED, bool CROSS>
__global__ void __launch_bounds__(kTCThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int S, int S_kv, int H,
                int KVH, int causal, int window, int chunk, float scale_log2) {
  const int Skv = CROSS ? S_kv : S;  // the self-attention kernels key on S alone
  constexpr int RS = HDK + 8;      // padded row of a Q or K tile (elements)
  constexpr int RV = HDV + 8;      // padded row of a V tile
  constexpr int STAGE = kTile * (RS + RV);  // one stage: a K tile, then a V tile
  constexpr int KSTEPS = HDK / 16; // k-steps of Q K^T
  constexpr int NT = kTile / 8;    // 8-key column tiles of S
  constexpr int NO = HDV / 8;      // 8-column tiles of O
  static_assert(HDK % 16 == 0 && NO % 2 == 0, "whole mma tiles");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* stage0 = Qs + kTile * RS;  // stage i: K at stage0 + i STAGE, V after it

  const int nq = gridDim.x;
  const int qt = causal ? nq - 1 - blockIdx.x : blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kTile;
  const bf16* qb = q + (size_t)b * S * H * HDK;
  const bf16* kb = k + (size_t)b * Skv * KVH * HDK;
  const bf16* vb = v + (size_t)b * Skv * KVH * HDV;

  const KvRange<CHUNKED> kv(qt, S, Skv, causal, window, chunk);
  const int kt_begin = kv.begin, kt_end = kv.end;

  cp_tile<HDK>(Qs, qb, q0, S, H, h);
  cp_tile<HDK>(stage0, kb, kt_begin * kTile, Skv, KVH, kvh);
  cp_tile<HDV>(stage0 + kTile * RS, vb, kt_begin * kTile, Skv, KVH, kvh);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + lane / 4, row_b = row_a + 8;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of rows a and b
  float l_a = 0.f, l_b = 0.f;              // this lane's share of the row sums
  unsigned qf[KSTEPS][4];

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin;
    bf16* Ks = stage0 + (it & 1) * STAGE;
    bf16* Vs = Ks + kTile * RS;
    if (kt + 1 < kt_end) {  // the next tile into the other stage
      bf16* Kn = stage0 + ((it + 1) & 1) * STAGE;
      cp_tile<HDK>(Kn, kb, (kt + 1) * kTile, Skv, KVH, kvh);
      cp_tile<HDV>(Kn + kTile * RS, vb, (kt + 1) * kTile, Skv, KVH, kvh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, first, Q) has landed for every thread
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + lane % 16) * RS + ks * 16 + (lane / 16) * 8);
    }

    // S = Q K^T: ldmatrix matrix i of keys n0 + (i / 2) * 8 .. +7, dims
    // k0 + (i % 2) * 8 .. +7, so r0, r1 are the B fragment of key tile n0
    // and r2, r3 that of n0 + 8
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned kf[4];
        ldsm_x4(kf, Ks + (n * 8 + lane % 8 + (lane / 16) * 8) * RS + ks * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(s[n], qf[ks], kf[0], kf[1]);
        mma_bf16(s[n + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, mask where this tile can hold a masked key, online softmax
    const int k0 = kt * kTile;
    const bool edge = k0 + kTile > Skv || (causal && k0 + kTile - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kTile - 1 - window) ||
                      (CHUNKED && min(k0, q0) / chunk != (max(k0, q0) + kTile - 1) / chunk);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int col = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          x = key_ok<CHUNKED>(row, col, Skv, causal, window, chunk) ? x : -INFINITY;
        }
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
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][0] == -INFINITY ? 0.f : ex2(s[n][0] - mn_a);
      s[n][1] = s[n][1] == -INFINITY ? 0.f : ex2(s[n][1] - mn_a);
      s[n][2] = s[n][2] == -INFINITY ? 0.f : ex2(s[n][2] - mn_b);
      s[n][3] = s[n][3] == -INFINITY ? 0.f : ex2(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // O += P V over 16-key steps. The A fragment of keys 16j .. +15 is the
    // accumulator layout of key tiles 2j and 2j + 1; P goes in as P_hi and
    // P_lo. ldmatrix.trans matrix i of keys 16j + (i % 2) * 8 .. +7, dims
    // d0 + (i / 2) * 8 .. +7: r0, r1 the B fragment of dims d0, r2, r3 of
    // d0 + 8.
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned vf[4];
        ldsm_x4_trans(vf, Vs + (j * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RV + n * 8 +
                              (lane / 16) * 8);
        mma_bf16(o[n], ph, vf[0], vf[1]);
        mma_bf16(o[n], pl, vf[0], vf[1]);
        mma_bf16(o[n + 1], ph, vf[2], vf[3]);
        mma_bf16(o[n + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int w = 1; w < 4; w *= 2) {
    l_a += __shfl_xor_sync(kFull, l_a, w);
    l_b += __shfl_xor_sync(kFull, l_b, w);
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  bf16* ob = out + (size_t)b * S * H * HDV;
  const int c0 = (lane % 4) * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + ((size_t)row_a * H + h) * HDV + n * 8 + c0) =
          __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + ((size_t)row_b * H + h) * HDV + n * 8 + c0) =
          __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <int HDK, int HDV, bool CHUNKED, bool CROSS>
cudaError_t launch_flash_tc_hd(const void* q, const void* k, const void* v, void* out, int B,
                               int S, int S_kv, int H, int KVH, int causal, int window,
                               int chunk, float scale, cudaStream_t stream) {
  const size_t smem = flash_tc_smem_bytes(HDK, HDV);
  auto kernel = flash_tc_kernel<HDK, HDV, CHUNKED, CROSS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nq = (S + kTile - 1) / kTile;
  kernel<<<dim3(nq, H, B), kTCThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, S_kv, H, KVH, causal, window, chunk,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T, int HDK, int HDV, bool CHUNKED, bool CROSS>
cudaError_t launch_flash_hd(const void* q, const void* k, const void* v, void* out, int B,
                            int S, int S_kv, int H, int KVH, int causal, int window, int chunk,
                            float scale, cudaStream_t stream) {
  const size_t smem = flash_smem_floats(HDK, HDV) * sizeof(float);
  auto kernel = flash_kernel<T, HDK, HDV, CHUNKED, CROSS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nq = (S + kTile - 1) / kTile;
  kernel<<<dim3(nq, H, B), kFThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, S_kv, H, KVH, causal, window, chunk, scale);
  return cudaGetLastError();
}

// bf16 inputs on the tensor cores, f32 inputs on the CUDA cores; the
// (query/key, value) head dims of the instantiations: (64, 64), (128, 128)
// and MLA's (96, 64)
template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out, int B, int S,
                         int S_kv, int H, int KVH, int hdk, int hdv, int causal, int window,
                         int chunk, float scale, cudaStream_t stream) {
#define DA_FLASH_CH(K, V, C, X)                                                             \
  if constexpr (std::is_same<T, bf16>::value)                                               \
    return launch_flash_tc_hd<K, V, C, X>(q, k, v, out, B, S, S_kv, H, KVH, causal, window, \
                                          chunk, scale, stream);                            \
  else                                                                                      \
    return launch_flash_hd<T, K, V, C, X>(q, k, v, out, B, S, S_kv, H, KVH, causal, window, \
                                          chunk, scale, stream);
#define DA_FLASH_HD(K, V)                                                                   \
  if (hdk == K && hdv == V) {                                                               \
    if (chunk > 0) {                                                                        \
      DA_FLASH_CH(K, V, true, false)                                                        \
    } else {                                                                                \
      DA_FLASH_CH(K, V, false, false)                                                       \
    }                                                                                       \
  }
  // cross attention (S_kv != S: whisper's decoder over the encoder's output)
  // is non-causal with no window or chunk (the wrapper refuses the rest),
  // at whisper's head dims only
  if (S_kv != S) {
    if (hdk == 64 && hdv == 64 && !causal && window <= 0 && chunk <= 0) {
      DA_FLASH_CH(64, 64, false, true)
    }
    return cudaErrorInvalidValue;
  }
  DA_FLASH_HD(64, 64)
  DA_FLASH_HD(128, 128)
  DA_FLASH_HD(96, 64)
#undef DA_FLASH_HD
#undef DA_FLASH_CH
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// decode attention (split over the cache axis by each row's own length)
// ---------------------------------------------------------------------------

constexpr int kSlots = 16;      // slots a warp stages and scores at a time
constexpr int kHeadRows = 16;   // query heads of a warp: the 16 rows of an m16 tile

// Slots per split of a row with `len` valid slots: whole 16-slot tiles, the
// least that lets n_split splits cover the row (the wrapper's
// dense_decode_chunk mirrors it). Split sp covers [sp * chunk, (sp + 1) *
// chunk) below len; splits past len are empty.
__device__ __forceinline__ int row_chunk(int len, int n_split) {
  const int per = (len + n_split - 1) / n_split;
  return (per + kSlots - 1) / kSlots * kSlots;
}

// What every decode warp derives from its block and warp index: the row b,
// KV head, the heads g0 .. g0 + ng - 1 of the group it scores (at most 16),
// and its split's slots [lo, hi) of the row (empty when lo >= hi). part is
// the index of (b, kvh, split, g0) in the partials (B, KVH, n_split, G, ...).
struct DecodeWork {
  int b, kvh, g0, ng, lo, hi;
  size_t part;
  __device__ DecodeWork(const int* lengths, int H, int KVH, int Sc, int n_split, int sp) {
    const int G = H / KVH, n_hg = (G + kHeadRows - 1) / kHeadRows;
    b = blockIdx.z;
    kvh = blockIdx.y / n_hg;
    g0 = (blockIdx.y % n_hg) * kHeadRows;
    ng = min(kHeadRows, G - g0);
    const int len = min(lengths[b], Sc);
    const int chunk = row_chunk(len, n_split);
    lo = sp * chunk;
    hi = min(lo + chunk, len);
    part = (((size_t)b * KVH + kvh) * n_split + sp) * G + g0;
  }
  // the partial state of a split with no valid slot: the merge skips it
  __device__ void store_empty(float* part_ml, int lane) const {
    if (lane < ng) {
      part_ml[2 * (part + lane)] = -INFINITY;
      part_ml[2 * (part + lane) + 1] = 0.f;
    }
  }
};

// Stage the 16 slots [s0, s0 + 16) of one (row, KV head) of the caches (K at
// Ks, V at Vs, rows of RS elements) by 16-byte cp.async of the warp's lanes;
// slots at or past hi are zero-filled and not read.
template <typename T, int HD, int RS>
__device__ __forceinline__ void stage_slots(T* Ks, T* Vs, const T* __restrict__ kb,
                                            const T* __restrict__ vb, size_t slot_stride,
                                            int s0, int hi, int lane) {
  constexpr int kChunks = HD * sizeof(T) / 16;  // 16-byte chunks of a slot's row
  constexpr int kPer = 16 / sizeof(T);          // elements per chunk
#pragma unroll
  for (int i = 0; i < kSlots * kChunks / 32; ++i) {
    const int e = lane + 32 * i, r = e / kChunks, c = (e % kChunks) * kPer;
    const bool in = s0 + r < hi;
    const size_t off = (size_t)(in ? s0 + r : 0) * slot_stride + c;
    cp_async16(Ks + r * RS + c, kb + off, in ? 16 : 0);
    cp_async16(Vs + r * RS + c, vb + off, in ? 16 : 0);
  }
}

// bf16, on the tensor cores. Each warp is one split: its 16-slot K/V tiles
// go through a two-stage cp.async ring of its own (no block barrier), the
// group's heads are the rows of one m16 A tile (rows past ng are zeros and
// never stored), S = Q K^T and O += P V run on mma.sync as in flash_tc_kernel
// (P as P_hi + P_lo), and the online softmax stays in registers.
constexpr int kDecTCWarps = 4;

__host__ __device__ constexpr int decode_tc_smem_bytes(int hd) {
  return kDecTCWarps * 4 * kSlots * (hd + 8) * static_cast<int>(sizeof(bf16));
}

template <int HD>
__global__ void __launch_bounds__(32 * kDecTCWarps)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
                 const bf16* __restrict__ v_cache, const int* __restrict__ lengths,
                 float* __restrict__ part_o, float* __restrict__ part_ml, int H, int KVH, int Sc,
                 int n_split, float scale_log2) {
  constexpr int RS = HD + 8;       // padded row of a staged slot (elements)
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int NO = HD / 8;       // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sp = blockIdx.x * kDecTCWarps + warp;
  if (sp >= n_split) return;
  const DecodeWork w(lengths, H, KVH, Sc, n_split, sp);
  if (w.lo >= w.hi) {
    w.store_empty(part_ml, lane);
    return;
  }
  bf16* ring = reinterpret_cast<bf16*>(dec_smem) + warp * 4 * kSlots * RS;  // stage i: K, V
  const size_t slot_stride = (size_t)KVH * HD;
  const bf16* kb = k_cache + ((size_t)w.b * Sc * KVH + w.kvh) * HD;
  const bf16* vb = v_cache + ((size_t)w.b * Sc * KVH + w.kvh) * HD;
  stage_slots<bf16, HD, RS>(ring, ring + kSlots * RS, kb, vb, slot_stride, w.lo, w.hi, lane);
  cp_async_commit();

  // the A fragments of the heads (rows ra and rb of the m16 tile)
  const int G = H / KVH;
  const int ra = lane / 4, rb = ra + 8, c0 = 2 * (lane % 4);
  const bf16* qa = q + ((size_t)w.b * H + w.kvh * G + w.g0 + ra) * HD;
  const bf16* qb = qa + 8 * HD;
  unsigned qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int col = ks * 16 + c0;
    qf[ks][0] = ra < w.ng ? ld_bf16x2(qa + col) : 0u;
    qf[ks][1] = rb < w.ng ? ld_bf16x2(qb + col) : 0u;
    qf[ks][2] = ra < w.ng ? ld_bf16x2(qa + col + 8) : 0u;
    qf[ks][3] = rb < w.ng ? ld_bf16x2(qb + col + 8) : 0u;
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const int n_steps = (w.hi - w.lo + kSlots - 1) / kSlots;
  for (int it = 0; it < n_steps; ++it) {
    const int s0 = w.lo + it * kSlots;
    bf16* Ks = ring + (it & 1) * 2 * kSlots * RS;
    bf16* Vs = Ks + kSlots * RS;
    if (it + 1 < n_steps) {  // the next tile into the other stage
      bf16* Kn = ring + ((it + 1) & 1) * 2 * kSlots * RS;
      stage_slots<bf16, HD, RS>(Kn, Kn + kSlots * RS, kb, vb, slot_stride, s0 + kSlots, w.hi,
                                lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of this tile have landed

    // S = Q K^T over the tile's 16 slots: two 8-slot column tiles
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      unsigned kf[4];
      ldsm_x4(kf, Ks + (lane % 8 + (lane / 16) * 8) * RS + ks * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(s[0], qf[ks], kf[0], kf[1]);
      mma_bf16(s[1], qf[ks], kf[2], kf[3]);
    }
    // scale, mask slots at or past hi (the tile's first slot is valid, so
    // every row's max is finite), online softmax in log2 units
    const bool edge = s0 + kSlots > w.hi;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge && s0 + n * 8 + c0 + (e & 1) >= w.hi) x = -INFINITY;
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {  // the quad of lanes that shares a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = ex2(m_a - mn_a), alpha_b = ex2(m_b - mn_b);  // 0 on the first tile
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = ex2(s[n][0] - mn_a);  // ex2(-inf) = 0
      s[n][1] = ex2(s[n][1] - mn_a);
      s[n][2] = ex2(s[n][2] - mn_b);
      s[n][3] = ex2(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }
    // O += P V: the accumulators of the two column tiles are the A fragment
    // of the 16-slot step (P_hi and P_lo); V's B fragments by ldmatrix.trans
    unsigned ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      unsigned vf[4];
      ldsm_x4_trans(vf, Vs + (lane % 8 + ((lane / 8) % 2) * 8) * RS + n * 8 + (lane / 16) * 8);
      mma_bf16(o[n], ph, vf[0], vf[1]);
      mma_bf16(o[n], pl, vf[0], vf[1]);
      mma_bf16(o[n + 1], ph, vf[2], vf[3]);
      mma_bf16(o[n + 1], pl, vf[2], vf[3]);
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }

#pragma unroll
  for (int x = 1; x < 4; x *= 2) {
    l_a += __shfl_xor_sync(kFull, l_a, x);
    l_b += __shfl_xor_sync(kFull, l_b, x);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (ra < w.ng)
      *reinterpret_cast<float2*>(part_o + (w.part + ra) * HD + n * 8 + c0) =
          make_float2(o[n][0], o[n][1]);
    if (rb < w.ng)
      *reinterpret_cast<float2*>(part_o + (w.part + rb) * HD + n * 8 + c0) =
          make_float2(o[n][2], o[n][3]);
  }
  if (lane % 4 == 0) {
    if (ra < w.ng) {
      part_ml[2 * (w.part + ra)] = m_a * kLn2;
      part_ml[2 * (w.part + ra) + 1] = l_a;
    }
    if (rb < w.ng) {
      part_ml[2 * (w.part + rb)] = m_b * kLn2;
      part_ml[2 * (w.part + rb) + 1] = l_b;
    }
  }
}

// f32, on the CUDA cores (TF32 would not hold the 1e-4 tolerance). The same
// warp-per-split ring. Lane (i, h) = (lane % 16, lane / 16) scores slot i
// over half h of head_dim for every head of the group at once (q in shared
// memory, read as broadcast float4s); each head's max and sum are reduced
// over the 16 slot lanes by shuffles; the probabilities go through a 16 x 16
// table in shared memory to the value product, where lane l owns output
// columns l * HD / 32 .. +HD / 32 of every head. Running max, sum and
// accumulators of all heads stay in registers.
constexpr int kDecF32Warps = 2;

template <int HD> struct DecF32Plan {
  static constexpr int RS = HD + 4;                   // padded f32 row: 16-byte aligned,
                                                      // rows 4 banks apart
  static constexpr int kRing = 4 * kSlots * RS;       // floats of a warp's ring
  static constexpr int kP = kSlots * kHeadRows;       // the probability table
  static constexpr int kQ = kHeadRows * HD;           // the block's q
  static constexpr int bytes = (kDecF32Warps * (kRing + kP) + kQ) * 4;
};

template <int HD>
__global__ void __launch_bounds__(32 * kDecF32Warps)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_cache,
                  const float* __restrict__ v_cache, const int* __restrict__ lengths,
                  float* __restrict__ part_o, float* __restrict__ part_ml, int H, int KVH, int Sc,
                  int n_split, float scale) {
  using P = DecF32Plan<HD>;
  constexpr int RS = P::RS, KH = HD / 2, DPL = HD / 32;
  extern __shared__ __align__(16) float dec_f32_smem[];
  float* qs = dec_f32_smem;  // the block's heads: qs[g * HD + d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sp = blockIdx.x * kDecF32Warps + warp;
  const DecodeWork w(lengths, H, KVH, Sc, n_split, sp);
  const int G = H / KVH;
  const float* q_row = q + ((size_t)w.b * H + w.kvh * G + w.g0) * HD;
  for (int e = threadIdx.x; e < w.ng * HD / 4; e += 32 * kDecF32Warps)
    reinterpret_cast<float4*>(qs)[e] = reinterpret_cast<const float4*>(q_row)[e];
  __syncthreads();  // the block's only barrier
  if (sp >= n_split) return;
  if (w.lo >= w.hi) {
    w.store_empty(part_ml, lane);
    return;
  }
  float* ring = qs + P::kQ + warp * (P::kRing + P::kP);
  float* ptab = ring + P::kRing;  // ptab[slot * 16 + g]
  const size_t slot_stride = (size_t)KVH * HD;
  const float* kb = k_cache + ((size_t)w.b * Sc * KVH + w.kvh) * HD;
  const float* vb = v_cache + ((size_t)w.b * Sc * KVH + w.kvh) * HD;
  stage_slots<float, HD, RS>(ring, ring + kSlots * RS, kb, vb, slot_stride, w.lo, w.hi, lane);
  cp_async_commit();

  const int i = lane % kSlots, h = lane / kSlots;
  float m[kHeadRows], l[kHeadRows], o[kHeadRows][DPL];
#pragma unroll
  for (int g = 0; g < kHeadRows; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[g][c] = 0.f;
  }
  const int n_steps = (w.hi - w.lo + kSlots - 1) / kSlots;
  for (int it = 0; it < n_steps; ++it) {
    const int s0 = w.lo + it * kSlots;
    float* Ks = ring + (it & 1) * 2 * kSlots * RS;
    float* Vs = Ks + kSlots * RS;
    if (it + 1 < n_steps) {
      float* Kn = ring + ((it + 1) & 1) * 2 * kSlots * RS;
      stage_slots<float, HD, RS>(Kn, Kn + kSlots * RS, kb, vb, slot_stride, s0 + kSlots, w.hi,
                                 lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    float kr[KH];
#pragma unroll
    for (int d = 0; d < KH; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(Ks + i * RS + h * KH + d);
      kr[d] = x.x;
      kr[d + 1] = x.y;
      kr[d + 2] = x.z;
      kr[d + 3] = x.w;
    }
    const bool valid = s0 + i < w.hi;  // the tile's first slot is valid
#pragma unroll
    for (int g = 0; g < kHeadRows; ++g) {
      if (g >= w.ng) break;
      const float* qg = qs + g * HD + h * KH;
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
      float mx = sc;
#pragma unroll
      for (int x = kSlots / 2; x > 0; x /= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, x));
      const float mn = fmaxf(m[g], mx);
      const float p = valid ? expf(sc - mn) : 0.f;
      float sum = p;
#pragma unroll
      for (int x = kSlots / 2; x > 0; x /= 2) sum += __shfl_xor_sync(kFull, sum, x);
      const float alpha = expf(m[g] - mn);  // 0 on the first tile
      m[g] = mn;
      l[g] = l[g] * alpha + sum;
#pragma unroll
      for (int c = 0; c < DPL; ++c) o[g][c] *= alpha;
      if (h == 0) ptab[i * kHeadRows + g] = p;
    }
    __syncwarp();  // the probability table is written
#pragma unroll
    for (int s2 = 0; s2 < kSlots; ++s2) {
      float vr[DPL];
      if constexpr (DPL == 4) {
        const float4 x = *reinterpret_cast<const float4*>(Vs + s2 * RS + lane * DPL);
        vr[0] = x.x, vr[1] = x.y, vr[2] = x.z, vr[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(Vs + s2 * RS + lane * DPL);
        vr[0] = x.x, vr[1] = x.y;
      }
#pragma unroll
      for (int g4 = 0; g4 < kHeadRows; g4 += 4) {
        if (g4 >= w.ng) break;
        const float4 p4 = *reinterpret_cast<const float4*>(ptab + s2 * kHeadRows + g4);
        const float pg[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < DPL; ++c) o[g4 + k][c] = fmaf(pg[k], vr[c], o[g4 + k][c]);
      }
    }
    __syncwarp();  // this stage and the table are read before they are refilled
  }
#pragma unroll
  for (int g = 0; g < kHeadRows; ++g) {
    if (g >= w.ng) break;
#pragma unroll
    for (int c = 0; c < DPL; ++c) part_o[(w.part + g) * HD + lane * DPL + c] = o[g][c];
    if (lane == 0) {
      part_ml[2 * (w.part + g)] = m[g];
      part_ml[2 * (w.part + g) + 1] = l[g];
    }
  }
}

template <typename T, int HD>
cudaError_t launch_decode_hd(const void* q, const void* k, const void* v, const int* lengths,
                             void* out, float* part_o, float* part_ml, int B, int H, int KVH,
                             int Sc, int n_split, float scale, cudaStream_t stream) {
  const int n_hg = (H / KVH + kHeadRows - 1) / kHeadRows;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = decode_tc_smem_bytes(HD);
    auto kernel = decode_tc_kernel<HD>;
    err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((n_split + kDecTCWarps - 1) / kDecTCWarps, KVH * n_hg, B), 32 * kDecTCWarps,
             smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), lengths, part_o, part_ml, H, KVH, Sc,
                             n_split, scale * 1.4426950408889634f);
  } else {
    const size_t smem = DecF32Plan<HD>::bytes;
    auto kernel = decode_f32_kernel<HD>;
    err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((n_split + kDecF32Warps - 1) / kDecF32Warps, KVH * n_hg, B),
             32 * kDecF32Warps, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lengths, part_o, part_ml, H, KVH, Sc, n_split, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_split_merge<T>(part_o, part_ml, out, B, H, KVH, HD, n_split, stream);
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* lengths,
                          void* out, float* part_o, float* part_ml, int B, int H, int KVH,
                          int hd, int Sc, int n_split, float scale, cudaStream_t stream) {
  if (n_split < 1) return cudaErrorInvalidValue;
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
int da_flash_smem_bytes(int dtype, int hdk, int hdv) {
  return dtype == kBF16 ? flash_tc_smem_bytes(hdk, hdv)
                        : flash_smem_floats(hdk, hdv) * static_cast<int>(sizeof(float));
}

// Each launcher returns the cudaError_t of its launches (0 on success).
// S: the queries' length, S_kv: the keys' (S_kv != S only non-causal, with
// no window or chunk, at hd 64); hdk: the query/key head dim, hdv: the
// value (and output) head dim; window <= 0: no sliding window; chunk <= 0:
// no chunk mask (the wrapper refuses both together).
int da_flash_attention(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                       int S, int S_kv, int H, int KVH, int hdk, int hdv, int causal,
                       int window, int chunk, float scale, void* stream) {
  DA_DISPATCH(launch_flash, q, k, v, out, B, S, S_kv, H, KVH, hdk, hdv, causal, window, chunk,
              scale, static_cast<cudaStream_t>(stream))
}

// part_o: (B, KVH, n_split, G, hd) and part_ml: (B, KVH, n_split, G, 2)
// float32 scratch the caller allocates; each row's slots go to n_split
// splits of whole 16-slot tiles (row_chunk).
int da_decode_attention(int dtype, const void* q, const void* k_cache, const void* v_cache,
                        const int* lengths, void* out, float* part_o, float* part_ml, int B,
                        int H, int KVH, int hd, int Sc, int n_split, float scale, void* stream) {
  DA_DISPATCH(launch_decode, q, k_cache, v_cache, lengths, out, part_o, part_ml, B, H, KVH, hd,
              Sc, n_split, scale, static_cast<cudaStream_t>(stream))
}

}  // extern "C"
