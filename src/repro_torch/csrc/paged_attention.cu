// Paged GQA attention kernels for Hopper (sm_90a), bound to PyTorch through
// a plain C interface (ctypes). Built by repro_torch/kernels/_build.py.
//
// paged_decode_attention
//   Replaces the Pallas kernel repro/kernels/decode_attention.py::
//   paged_decode_attention (body _paged_decode_kernel). One query token per
//   batch row attends the row's KV through its block table, valid below
//   lengths[b] and where the table entry is >= 0.
//
// paged_chunk_attention
//   Replaces the Pallas kernel repro/kernels/decode_attention.py::
//   paged_chunk_attention (body _paged_chunk_kernel). T packed query tokens
//   each attend their own row's paged KV through block_tables[row_of[t]],
//   under the span mask  slot < p_end[t]  OR  s_start[t] <= slot <= slots[t].
//   A pad token (row_of[t] < 0) writes zeros.
//
// What bounds them on the H100: bytes of K/V read from device memory. Each
// query head does 4 flops per K/V element pair it reads, far below the ~295
// flops per byte at which the card stops being bandwidth-bound, so both
// kernels are bandwidth-bound.
// What the design does about it: a thread block per (KV head, query row or
// packed token, and for decode a split of the chain) reads each KV block of
// its range once and shares it across the G = H / KVH query heads of the
// group, so K/V bytes are not multiplied by G. Blocks outside the row's
// length or the token's span, and -1 table entries, are skipped without a
// load. The block's eight warps walk the range in parallel, one 16-slot
// block each, keeping K and V in registers (int8 dequantised by the block's
// per-KV-head scale) and a per-warp online softmax (running max, sum and
// (G, hd) accumulator, f32); the warps' states are merged at the end, so the
// scores of a row never leave the SM.
// Decode splits each row's chain across thread blocks, so that n_split * KVH
// * B blocks fill the card (B * KVH is only 16 at B = 8, KVH = 2): split s
// walks the table entries [s * chunk, (s + 1) * chunk) and writes its
// partial state, and a second kernel merges the splits of each (row, KV
// head) (attention_common.cuh). The wrapper picks n_split and chunk
// (kernels/decode_attention.py::decode_split).
// The chunk kernel with f32 q keeps one such block per (token, KV head)
// over the whole chain, so it reads a row's K/V once per packed token of
// that row.
// The chunk kernel with bf16 q (what the serve path runs), over a bf16 or
// an int8 pool, reads a row's K/V once per tile of up to 16 of its packed
// tokens: a 256-token prefill chunk shares each K/V tile among 16 tokens x
// G heads = 128 query rows, hundreds of flops per byte of K/V, so the
// products go to the tensor cores (mma.sync, f32 accumulators, P in two
// bf16 parts so that the f32 contract holds). A small kernel first lists the
// tiles on the card (no host sync); where the tiles alone would not fill the
// card, each tile's reach is split across blocks and the splits merged as
// decode's are. What bounds it: the function's own bound is bytes (each K/V
// block read once), but a mixed step's prefill tiles make the kernel a
// string of mma.sync steps (Q K^T, P_hi V, P_lo V per 64-slot K/V tile),
// one block of eight warps an SM; the design keeps each K/V tile in shared
// memory for every row that reads it, skips pool blocks and whole K/V tiles
// that no token of the tile reaches, and masks only tiles that need it.
#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kBS = 16;  // the block_size the kernels take

// Decode: slots below the row's length.
struct DecodeMask {
  int len;
  __device__ __forceinline__ int n_blocks() const { return (len + kBS - 1) / kBS; }
  __device__ __forceinline__ bool block_live(int lo) const { return lo < len; }
  __device__ __forceinline__ bool valid(int s) const { return s < len; }
};

// Ragged chunk: the segmented-prompt span of one packed token.
struct ChunkMask {
  int slot, p_end, s_start;
  __device__ __forceinline__ int n_blocks() const {
    const int last = slot > p_end - 1 ? slot : p_end - 1;
    return last / kBS + 1;
  }
  __device__ __forceinline__ bool block_live(int lo) const {
    return lo < p_end || (lo + kBS - 1 >= s_start && lo <= slot);
  }
  __device__ __forceinline__ bool valid(int s) const {
    return s < p_end || (s >= s_start && s <= slot);
  }
};

// One (query row, KV head) of attention over the entries [j_lo, j_hi) of a
// block chain. q_row points at the G*HD query values of this KV head's
// group; table is the row's mb block ids. Warp w takes the range's blocks
// j_lo + w, j_lo + w + kWarps, ... Within a warp, lane (i, h) = (lane % 16,
// lane / 16) scores slot i of the block over half h of head_dim, and owns
// output columns lane*HD/32 .. +HD/32. The block's state goes to out_row
// (normalised, in QT) or, with part_o given, to its partial (see
// store_block_state).
template <typename QT, typename KVT, int HD, typename Mask>
__device__ void attend(const QT* __restrict__ q_row, const KVT* __restrict__ k_pool,
                       const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ table,
                       Mask mask, int kvh, int KVH, int G, int j_lo, int j_hi, float scale,
                       QT* __restrict__ out_row, float* __restrict__ part_o,
                       float* __restrict__ part_ml) {
  constexpr int KH = HD / 2;   // K columns a lane scores
  constexpr int DPL = HD / 32; // output columns a lane owns
  extern __shared__ __align__(16) float smem[];
  float* q = smem;
  float* acc_all = q + G * HD;
  float* m_all = acc_all + kWarps * G * HD;
  float* l_all = m_all + kWarps * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i = lane % kBS, h = lane / kBS;
  float* acc = acc_all + warp * G * HD;
  float* m = m_all + warp * G;
  float* l = l_all + warp * G;

  for (int e = tid; e < G * HD; e += kThreads) q[e] = to_f32(q_row[e]);
  for (int e = tid; e < kWarps * G * HD; e += kThreads) acc_all[e] = 0.f;
  for (int e = tid; e < kWarps * G; e += kThreads) {
    m_all[e] = -INFINITY;
    l_all[e] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)KVH * HD;  // elements between slots
  const int nb = min(mask.n_blocks(), j_hi);
  for (int j = j_lo + warp; j < nb; j += kWarps) {
    const int blk = table[j];
    // -1 entries and blocks outside the length/span are skipped unread;
    // the test is uniform across the warp
    if (blk < 0 || !mask.block_live(j * kBS)) continue;
    const float ks = k_scale != nullptr ? k_scale[(size_t)blk * KVH + kvh] : 1.f;
    const float vs = v_scale != nullptr ? v_scale[(size_t)blk * KVH + kvh] : 1.f;
    const KVT* base_k = k_pool + ((size_t)blk * kBS * KVH + kvh) * HD;
    const KVT* base_v = v_pool + ((size_t)blk * kBS * KVH + kvh) * HD;
    float kr[KH];
    Load16<KVT, KH>::run(base_k + i * row_stride + h * KH, kr);
    float vr[kBS][DPL];
#pragma unroll
    for (int s = 0; s < kBS; ++s) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) vr[s][c] = to_f32(base_v[s * row_stride + lane * DPL + c]);
    }
    const bool valid = mask.valid(j * kBS + i);
    const float sk = scale * ks;
    for (int g = 0; g < G; ++g) {
      const float* qg = q + g * HD + h * KH;
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
      dot += __shfl_xor_sync(kFull, dot, kBS);  // the other half of head_dim
      const float s = valid ? dot * sk : -INFINITY;
      const float m_old = m[g];
      float mx = fmaxf(s, m_old);
#pragma unroll
      for (int w = kBS / 2; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      if (mx == -INFINITY) continue;  // nothing valid yet (uniform across the warp)
      const float p = s == -INFINITY ? 0.f : expf(s - mx);
      float sum = p;
#pragma unroll
      for (int w = kBS / 2; w > 0; w /= 2) sum += __shfl_xor_sync(kFull, sum, w);
      const float alpha = expf(m_old - mx);  // 0 on the first live block
      float o[DPL];
      float* ag = acc + g * HD + lane * DPL;
#pragma unroll
      for (int c = 0; c < DPL; ++c) o[c] = ag[c] * alpha;
#pragma unroll
      for (int s2 = 0; s2 < kBS; ++s2) {
        const float ps = __shfl_sync(kFull, p, s2) * vs;
#pragma unroll
        for (int c = 0; c < DPL; ++c) o[c] = fmaf(ps, vr[s2][c], o[c]);
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c) ag[c] = o[c];
      __syncwarp();  // every lane has read m[g] and l[g]
      if (lane == 0) {
        m[g] = mx;
        l[g] = l[g] * alpha + sum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  store_block_state<QT>(acc_all, m_all, l_all, G, HD, out_row, part_o, part_ml);
}

// One (split, KV head, row): the table entries [sp * chunk, (sp + 1) *
// chunk) of row b, into the split's partial state.
template <typename QT, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                          const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, const int* __restrict__ tables,
                          const int* __restrict__ lengths, float* __restrict__ part_o,
                          float* __restrict__ part_ml, int H, int KVH, int mb, int chunk,
                          float scale) {
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, n_split = gridDim.x;
  const int G = H / KVH;
  const size_t off = ((size_t)b * H + (size_t)kvh * G) * HD;
  const size_t part = ((size_t)b * KVH + kvh) * n_split + sp;
  if (sp * chunk * kBS >= lengths[b]) {  // wholly past the row's length
    store_empty_split(part_ml + part * G * 2, G);
    return;
  }
  attend<QT, KVT, HD>(q + off, k_pool, v_pool, k_scale, v_scale, tables + (size_t)b * mb,
                      DecodeMask{lengths[b]}, kvh, KVH, G, sp * chunk,
                      min((sp + 1) * chunk, mb), scale, static_cast<QT*>(nullptr),
                      part_o + part * G * HD, part_ml + part * G * 2);
}

template <typename QT, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                   const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ tables,
                   const int* __restrict__ row_of, const int* __restrict__ slots,
                   const int* __restrict__ p_end, const int* __restrict__ s_start,
                   QT* __restrict__ out, int H, int KVH, int mb, float scale) {
  const int t = blockIdx.x, kvh = blockIdx.y, G = H / KVH;
  const size_t off = ((size_t)t * H + (size_t)kvh * G) * HD;
  const int row = row_of[t];
  if (row < 0) {  // packed pad token
    for (int e = threadIdx.x; e < G * HD; e += kThreads) out[off + e] = from_f32<QT>(0.f);
    return;
  }
  attend<QT, KVT, HD>(q + off, k_pool, v_pool, k_scale, v_scale, tables + (size_t)row * mb,
                      ChunkMask{slots[t], p_end[t], s_start[t]}, kvh, KVH, G, 0, mb, scale,
                      out + off, nullptr, nullptr);
}

template <typename QT, typename KVT, int HD>
cudaError_t launch_decode_hd(const void* q, const void* k, const void* v, const float* ks,
                             const float* vs, const int* tables, const int* lengths,
                             void* out, float* part_o, float* part_ml, int B, int H, int KVH,
                             int mb, int n_split, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_floats(H / KVH, HD) * sizeof(float);
  auto kernel = paged_decode_split_kernel<QT, KVT, HD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_split, KVH, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v), ks,
      vs, tables, lengths, part_o, part_ml, H, KVH, mb, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_split_merge<QT>(part_o, part_ml, out, B, H, KVH, HD, n_split, stream);
}

template <typename QT, typename KVT, int HD>
cudaError_t launch_chunk_hd(const void* q, const void* k, const void* v, const float* ks,
                            const float* vs, const int* tables, const int* row_of,
                            const int* slots, const int* p_end, const int* s_start,
                            void* out, int T, int H, int KVH, int mb, float scale,
                            cudaStream_t stream) {
  const size_t smem = decode_smem_floats(H / KVH, HD) * sizeof(float);
  auto kernel = paged_chunk_kernel<QT, KVT, HD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T, KVH), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v), ks,
      vs, tables, row_of, slots, p_end, s_start, static_cast<QT*>(out), H, KVH, mb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// paged_chunk_attention with bf16 q and pools: tiles of a row's packed tokens
// on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kKV = 64;             // slots of a K/V tile: four pool blocks
constexpr int kTileRows = 128;      // query rows ((token, head) pairs) of a tile at most
constexpr int kMaxTileTokens = 16;  // packed tokens of a tile at most
constexpr int kPlanThreads = 1024;

// The tile plan (one block): plan[0] = the number of tiles, then per tile
// (first packed token, tokens). Token t starts a tile iff row_of[t] >= 0 and
// (t % tile_tokens == 0 or row_of[t - 1] != row_of[t]); its tile runs up to
// the next token that breaks the row or is a multiple of tile_tokens. So a
// tile holds consecutive tokens of one row, never a pad, for any row_of; the
// control plane's packing (each row's tokens as one run) gives at most
// ceil(T / tile_tokens) + B tiles. The kernel
// kernels/decode_attention.py::chunk_tile_plan mirrors the rule. The block
// also settles the pad tokens, which get no tile: their output rows are
// zeroed (one split) or their partials marked empty (splits, the merge then
// writes zeros); n_split 0 builds the plan alone.
__global__ void __launch_bounds__(kPlanThreads)
chunk_plan_kernel(const int* __restrict__ row_of, int T, int tile_tokens, int* __restrict__ plan,
                  bf16* __restrict__ out, float* __restrict__ part_ml, int H, int KVH, int hd,
                  int n_split) {
  __shared__ int warp_incl[kPlanThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int base = 0;  // tiles found before this pass (the same in every thread)
  for (int t0 = 0; t0 < T; t0 += kPlanThreads) {
    const int t = t0 + tid;
    const int r = t < T ? row_of[t] : -1;
    const bool start = r >= 0 && (t % tile_tokens == 0 || row_of[t - 1] != r);
    const unsigned ballot = __ballot_sync(kFull, start);
    if (lane == 0) warp_incl[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' counts
      int x = warp_incl[lane];
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      warp_incl[lane] = x;
    }
    __syncthreads();
    if (start) {
      const int idx = base + (warp ? warp_incl[warp - 1] : 0) + __popc(ballot & ((1u << lane) - 1));
      int n = 1;
      while (t + n < T && (t + n) % tile_tokens != 0 && row_of[t + n] == r) ++n;
      plan[1 + 2 * idx] = t;
      plan[2 + 2 * idx] = n;
    }
    base += warp_incl[31];
    __syncthreads();  // warp_incl is read before the next pass writes it
  }
  if (tid == 0) plan[0] = base;
  if (n_split < 1) return;  // the plan alone
  const int G = H / KVH;
  for (int t = tid; t < T; t += kPlanThreads) {
    if (row_of[t] >= 0) continue;
    if (n_split == 1) {
      uint4* dst = reinterpret_cast<uint4*>(out + (size_t)t * H * hd);
      for (int e = 0; e < H * hd / 8; ++e) dst[e] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      float2* ml = reinterpret_cast<float2*>(part_ml) + (size_t)t * KVH * n_split * G;
      for (int e = 0; e < KVH * n_split * G; ++e) ml[e] = make_float2(-INFINITY, 0.f);
    }
  }
}

// Shared-memory plan: two stages of (K, V) 64-slot tiles of HD + 8 bf16 a
// row (the 16-byte pad puts the eight rows of an ldmatrix phase on distinct
// banks); an int8 pool uses the first stage's room for its tile converted
// to bf16 and the second's for two stages of raw int8 tiles. Then the
// split's pool block ids (-1: unread and masked; at most mb + 3), its live
// K/V tiles (at most mb / 4 + 1), and for an int8 pool the blocks' K and V
// scales.
__host__ __device__ inline int chunk_tc_smem_bytes(int hd, int mb) {
  return 4 * kKV * (hd + 8) * static_cast<int>(sizeof(bf16)) +
         (mb + 4 + mb / 4 + 4) * static_cast<int>(sizeof(int)) +
         2 * (mb + 4) * static_cast<int>(sizeof(float));
}

// A staged int8 K or V tile (kKV rows of HD bytes) as bf16 rows of RS
// elements: integers in [-127, 127] are exact in bf16.
template <int HD, int RS>
__device__ __forceinline__ void int8_tile_to_bf16(bf16* __restrict__ dst,
                                                  const int8_t* __restrict__ src, int nthreads) {
  constexpr int kC = HD / 16;  // 16-byte chunks of a row
  for (int e = threadIdx.x; e < kKV * kC; e += nthreads) {
    const int r = e / kC, c = (e % kC) * 16;
    const uint4 x = *reinterpret_cast<const uint4*>(src + r * HD + c);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
    unsigned o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // little-endian: element 2k in the low byte of a half
      const unsigned h = w[k / 2] >> (16 * (k % 2));
      o[k] = bf16x2_bits(__floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(h & 0xffu)),
                                               static_cast<float>(static_cast<int8_t>((h >> 8) & 0xffu))));
    }
    *reinterpret_cast<uint4*>(dst + r * RS + c) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + r * RS + c + 8) = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// One block per work item (tile, split) at a time, walking the plan's items
// grid-stride, per KV head. The tile's rows are its tokens' G query heads,
// row = token * G + head, 16 rows a warp; a warp without a valid row only
// helps to stage K/V. The split covers [sp * c, (sp + 1) * c) of the tile's
// reach (the furthest slot + 1 that a token attends), c its share rounded up
// to whole 64-slot tiles. K/V tiles come through the row's table into a
// two-stage cp.async ring; pool blocks that no token of the tile reaches and
// -1 entries are zero-filled unread, wholly dead K/V tiles skipped. S = Q
// K^T and O += P V (P as P_hi + P_lo) on mma.sync as in the flash kernel;
// each row's own span mask on its score fragments, skipped on tiles every
// token sees whole. One split: normalised output; splits: the partial state
// (T, KVH, n_split, G, ...) that split_merge_kernel merges. An int8 pool
// (KVT int8_t) is staged raw and converted to bf16 in shared memory; its
// per-(block, KV head) K scale multiplies the scores and its V scale the
// probabilities before their split (the row sums take them unscaled).
template <typename KVT, int HD>
__global__ void __launch_bounds__(32 * kTileRows / 16)
paged_chunk_tc_kernel(const bf16* __restrict__ q, const KVT* __restrict__ k_pool,
                      const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const int* __restrict__ tables,
                      const int* __restrict__ row_of, const int* __restrict__ slots,
                      const int* __restrict__ p_end, const int* __restrict__ s_start,
                      const int* __restrict__ plan, bf16* __restrict__ out,
                      float* __restrict__ part_o, float* __restrict__ part_ml, int H, int KVH,
                      int mb, int n_split, float scale_log2) {
  constexpr int RS = HD + 8;       // padded row of a staged slot (elements)
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = kKV / 8;      // 8-slot column tiles of S
  constexpr int NO = HD / 8;       // 8-column tiles of O
  constexpr bool kInt8 = std::is_same<KVT, int8_t>::value;
  constexpr int kPer = 16 / sizeof(KVT);            // elements of a 16-byte chunk
  constexpr int kChunks = HD / kPer;                // 16-byte chunks of a slot's row
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  bf16* ring = reinterpret_cast<bf16*>(chunk_smem);  // stage i: K at 2i kKV RS, V after it
  int8_t* raw = reinterpret_cast<int8_t*>(ring + 2 * kKV * RS);  // int8: stage i at 2i kKV HD
  int* ent = reinterpret_cast<int*>(ring + 4 * kKV * RS);
  int* live = ent + mb + 4;
  float* ksc = reinterpret_cast<float*>(live + mb / 4 + 4);
  float* vsc = ksc + mb + 4;
  __shared__ int tok_slot[kMaxTileTokens], tok_pend[kMaxTileTokens], tok_ss[kMaxTileTokens];
  __shared__ int n_live;

  const int kvh = blockIdx.y, G = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nthreads = blockDim.x;
  const int c0 = 2 * (lane % 4);
  const int n_items = plan[0] * n_split;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item / n_split, sp = item % n_split;
    const int t0 = plan[1 + 2 * tile], n_tok = plan[2 + 2 * tile];
    const int row = row_of[t0];
    __syncthreads();  // the previous item's shared state is no longer read
    if (threadIdx.x < n_tok) {
      tok_slot[threadIdx.x] = slots[t0 + threadIdx.x];
      tok_pend[threadIdx.x] = p_end[t0 + threadIdx.x];
      tok_ss[threadIdx.x] = s_start[t0 + threadIdx.x];
    }
    __syncthreads();
    int reach = 0;  // slots [0, reach) hold every slot a token of the tile attends
    for (int i = 0; i < n_tok; ++i) reach = max(reach, max(tok_slot[i] + 1, tok_pend[i]));
    reach = min(reach, mb * kBS);
    const int per = (reach + n_split - 1) / n_split;
    const int c = (per + kKV - 1) / kKV * kKV;
    const int lo = sp * c, hi = min(lo + c, reach);

    // this lane's rows a and b of its warp's 16, and their tokens' spans; a
    // row past the tile's tokens gets a span that holds no slot
    const int r_a = 16 * warp + lane / 4, r_b = r_a + 8;
    const int tk_a = r_a / G, tk_b = r_b / G;
    const bool ok_a = tk_a < n_tok, ok_b = tk_b < n_tok;
    const bool warp_live = 16 * warp < n_tok * G;
    if (lo >= hi) {  // an empty split (never the only one)
      if (lane % 4 == 0) {
        if (ok_a) {
          const size_t p = (((size_t)(t0 + tk_a) * KVH + kvh) * n_split + sp) * G + r_a % G;
          part_ml[2 * p] = -INFINITY;
          part_ml[2 * p + 1] = 0.f;
        }
        if (ok_b) {
          const size_t p = (((size_t)(t0 + tk_b) * KVH + kvh) * n_split + sp) * G + r_b % G;
          part_ml[2 * p] = -INFINITY;
          part_ml[2 * p + 1] = 0.f;
        }
      }
      continue;
    }

    // the split's pool blocks: the table entry where a token reaches it
    const int j_lo = lo / kBS, n_kv = (hi - lo + kKV - 1) / kKV;
    const int* table = tables + (size_t)row * mb;
    for (int e = threadIdx.x; e < 4 * n_kv; e += nthreads) {
      const int j = j_lo + e, s0 = j * kBS;
      int blk = -1;
      if (j < mb && s0 < hi) {
        bool reached = false;
        for (int i = 0; i < n_tok; ++i)
          reached |= s0 < tok_pend[i] || (s0 + kBS - 1 >= tok_ss[i] && s0 <= tok_slot[i]);
        if (reached) blk = table[j];
      }
      ent[e] = blk;
      if constexpr (kInt8) {
        ksc[e] = blk >= 0 ? k_scale[(size_t)blk * KVH + kvh] : 0.f;
        vsc[e] = blk >= 0 ? v_scale[(size_t)blk * KVH + kvh] : 0.f;
      }
    }
    __syncthreads();
    // the live K/V tiles in order, bit 30 set where every token of the tile
    // attends every slot of it (no mask needed)
    if (warp == 0) {
      int n = 0;
      for (int b0 = 0; b0 < n_kv; b0 += 32) {
        const int kt = b0 + lane;
        bool is_live = false, full = false;
        if (kt < n_kv) {
          const int* e4 = ent + 4 * kt;
          is_live = e4[0] >= 0 || e4[1] >= 0 || e4[2] >= 0 || e4[3] >= 0;
          full = e4[0] >= 0 && e4[1] >= 0 && e4[2] >= 0 && e4[3] >= 0;
          const int a = lo + kt * kKV, z = a + kKV - 1;
          for (int i = 0; i < n_tok && full; ++i)
            full = z < tok_pend[i] || (a >= tok_ss[i] && z <= tok_slot[i]);
        }
        const unsigned bal = __ballot_sync(kFull, is_live);
        if (is_live) live[n + __popc(bal & ((1u << lane) - 1))] = kt | (full ? 1 << 30 : 0);
        n += __popc(bal);
      }
      if (lane == 0) n_live = n;
    }
    __syncthreads();
    const int n_list = n_live;

    auto stage = [&](int idx, int st) {
      const int kt = live[idx] & 0xffff;
      KVT* Ks;
      int rs;
      if constexpr (kInt8) {
        Ks = raw + st * 2 * kKV * HD;
        rs = HD;
      } else {
        Ks = ring + st * 2 * kKV * RS;
        rs = RS;
      }
      KVT* Vs = Ks + kKV * rs;
      for (int e = threadIdx.x; e < kKV * kChunks; e += nthreads) {
        const int r = e / kChunks, cc = (e % kChunks) * kPer;
        const int blk = ent[4 * kt + r / kBS];
        const size_t off = (((size_t)max(blk, 0) * kBS + r % kBS) * KVH + kvh) * HD + cc;
        cp_async16(Ks + r * rs + cc, k_pool + off, blk >= 0 ? 16 : 0);
        cp_async16(Vs + r * rs + cc, v_pool + off, blk >= 0 ? 16 : 0);
      }
    };
    if (n_list > 0) {
      stage(0, 0);
      cp_async_commit();
    }

    // the rows' A fragments and spans
    const bf16* qa = q + ((size_t)(t0 + tk_a) * H + kvh * G + r_a % G) * HD;
    const bf16* qb = q + ((size_t)(t0 + tk_b) * H + kvh * G + r_b % G) * HD;
    unsigned qf[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int col = ks * 16 + c0;
      qf[ks][0] = ok_a ? ld_bf16x2(qa + col) : 0u;
      qf[ks][1] = ok_b ? ld_bf16x2(qb + col) : 0u;
      qf[ks][2] = ok_a ? ld_bf16x2(qa + col + 8) : 0u;
      qf[ks][3] = ok_b ? ld_bf16x2(qb + col + 8) : 0u;
    }
    const int pe_a = ok_a ? tok_pend[tk_a] : 0, ss_a = ok_a ? tok_ss[tk_a] : 1,
              sl_a = ok_a ? tok_slot[tk_a] : 0;
    const int pe_b = ok_b ? tok_pend[tk_b] : 0, ss_b = ok_b ? tok_ss[tk_b] : 1,
              sl_b = ok_b ? tok_slot[tk_b] : 0;

    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    for (int it = 0; it < n_list; ++it) {
      if (it + 1 < n_list) {  // the next live tile into the other stage
        stage(it + 1, (it + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this tile has landed for every thread
      const int entry = live[it], kt = entry & 0xffff;
      const bool full = (entry >> 30) & 1;
      const bf16* Ks = ring;
      if constexpr (kInt8) {  // to bf16 in the first stage's room
        const int8_t* Kr = raw + (it & 1) * 2 * kKV * HD;
        int8_tile_to_bf16<HD, RS>(ring, Kr, nthreads);
        int8_tile_to_bf16<HD, RS>(ring + kKV * RS, Kr + kKV * HD, nthreads);
        __syncthreads();
      } else {
        Ks = ring + (it & 1) * 2 * kKV * RS;
      }
      const bf16* Vs = Ks + kKV * RS;
      if (warp_live) {
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
        const int k0 = lo + kt * kKV;
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const bool backed = full || ent[4 * kt + n / 2] >= 0;
          const float mul = kInt8 ? scale_log2 * ksc[4 * kt + n / 2] : scale_log2;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[n][e] * mul;
            if (!full) {
              const int col = k0 + n * 8 + c0 + (e & 1);
              const bool ok = e < 2 ? (col < pe_a || (col >= ss_a && col <= sl_a))
                                    : (col < pe_b || (col >= ss_b && col <= sl_b));
              x = backed && ok ? x : -INFINITY;
            }
            s[n][e] = x;
          }
          mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int x = 1; x < 4; x *= 2) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, x));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, x));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        // a new max is -inf only while no slot of the row was valid yet
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
        if constexpr (kInt8) {  // the V scale of each slot's block, into P
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float vm = vsc[4 * kt + n / 2];
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] *= vm;
          }
        }
#pragma unroll
        for (int j = 0; j < kKV / 16; ++j) {
          unsigned ph[4], pl[4];
          split_bf16(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
          split_bf16(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
          split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int n = 0; n < NO; n += 2) {
            unsigned vf[4];
            ldsm_x4_trans(vf, Vs + (j * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RS + n * 8 +
                                  (lane / 16) * 8);
            mma_bf16(o[n], ph, vf[0], vf[1]);
            mma_bf16(o[n], pl, vf[0], vf[1]);
            mma_bf16(o[n + 1], ph, vf[2], vf[3]);
            mma_bf16(o[n + 1], pl, vf[2], vf[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }

    if (!warp_live) continue;  // no row to write (warp-uniform; no barrier follows)
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      l_a += __shfl_xor_sync(kFull, l_a, x);
      l_b += __shfl_xor_sync(kFull, l_b, x);
    }
    if (n_split == 1) {
      const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
      const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
      bf16* oa = out + ((size_t)(t0 + tk_a) * H + kvh * G + r_a % G) * HD + c0;
      bf16* ob = out + ((size_t)(t0 + tk_b) * H + kvh * G + r_b % G) * HD + c0;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (ok_a)
          *reinterpret_cast<__nv_bfloat162*>(oa + n * 8) =
              __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
        if (ok_b)
          *reinterpret_cast<__nv_bfloat162*>(ob + n * 8) =
              __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
      }
    } else {
      const size_t p_a = (((size_t)(t0 + tk_a) * KVH + kvh) * n_split + sp) * G + r_a % G;
      const size_t p_b = (((size_t)(t0 + tk_b) * KVH + kvh) * n_split + sp) * G + r_b % G;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (ok_a)
          *reinterpret_cast<float2*>(part_o + p_a * HD + n * 8 + c0) =
              make_float2(o[n][0], o[n][1]);
        if (ok_b)
          *reinterpret_cast<float2*>(part_o + p_b * HD + n * 8 + c0) =
              make_float2(o[n][2], o[n][3]);
      }
      if (lane % 4 == 0) {
        if (ok_a) {
          part_ml[2 * p_a] = m_a * kLn2;  // -inf stays -inf
          part_ml[2 * p_a + 1] = l_a;
        }
        if (ok_b) {
          part_ml[2 * p_b] = m_b * kLn2;
          part_ml[2 * p_b + 1] = l_b;
        }
      }
    }
  }
}

// Tokens a tile takes at G query heads a KV head: 16, fewer where 16 * G
// would pass kTileRows rows (eight warps).
__host__ __device__ inline int chunk_tile_tokens(int G) {
  return kTileRows / G < kMaxTileTokens ? kTileRows / G : kMaxTileTokens;
}

template <typename KVT, int HD>
cudaError_t launch_chunk_tc_hd(const void* q, const void* k, const void* v, const float* ks,
                               const float* vs, const int* tables, const int* row_of,
                               const int* slots, const int* p_end, const int* s_start, void* out,
                               int* plan, float* part_o, float* part_ml, int T, int H, int KVH,
                               int mb, int n_split, int grid_x, float scale,
                               cudaStream_t stream) {
  const int G = H / KVH, tt = chunk_tile_tokens(G);
  if (tt < 1 || grid_x < 1) return cudaErrorInvalidValue;
  chunk_plan_kernel<<<1, kPlanThreads, 0, stream>>>(row_of, T, tt, plan, static_cast<bf16*>(out),
                                                    part_ml, H, KVH, HD, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = chunk_tc_smem_bytes(HD, mb);
  auto kernel = paged_chunk_tc_kernel<KVT, HD>;
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int warps = (tt * G + 15) / 16;
  kernel<<<dim3(grid_x, KVH), 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v), ks,
      vs, tables, row_of, slots, p_end, s_start, plan, static_cast<bf16*>(out), part_o,
      part_ml, H, KVH, mb, n_split, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  return launch_split_merge<bf16>(part_o, part_ml, out, T, H, KVH, HD, n_split, stream);
}

// head_dim is a template parameter (registers are indexed at compile time);
// the kernels take 64 and 128, the head dims of the archs the port serves.
// chunk: table entries (16-slot blocks) per split, n_split * chunk >= mb.
template <typename QT, typename KVT>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const float* ks,
                          const float* vs, const int* tables, const int* lengths, void* out,
                          float* part_o, float* part_ml, int B, int H, int KVH, int hd, int bs,
                          int mb, int n_split, int chunk, float scale, cudaStream_t stream) {
  if (bs != kBS || n_split < 1 || chunk < 1 || (long long)n_split * chunk < mb)
    return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_decode_hd<QT, KVT, 64>(q, k, v, ks, vs, tables, lengths, out, part_o,
                                         part_ml, B, H, KVH, mb, n_split, chunk, scale, stream);
  if (hd == 128)
    return launch_decode_hd<QT, KVT, 128>(q, k, v, ks, vs, tables, lengths, out, part_o,
                                          part_ml, B, H, KVH, mb, n_split, chunk, scale, stream);
  return cudaErrorInvalidValue;
}

// bf16 q (with a bf16 or an int8 pool): the tensor-core kernel (plan,
// part_o, part_ml: scratch, n_split: splits of a tile's reach, grid_x:
// blocks a KV head); f32 q: one block per (token, KV head) over the chain.
template <typename QT, typename KVT>
cudaError_t launch_chunk(const void* q, const void* k, const void* v, const float* ks,
                         const float* vs, const int* tables, const int* row_of,
                         const int* slots, const int* p_end, const int* s_start, void* out,
                         int* plan, float* part_o, float* part_ml, int T, int H, int KVH, int hd,
                         int bs, int mb, int n_split, int grid_x, float scale,
                         cudaStream_t stream) {
  if (bs != kBS || n_split < 1) return cudaErrorInvalidValue;
  if constexpr (std::is_same<QT, bf16>::value) {
    if (hd == 64)
      return launch_chunk_tc_hd<KVT, 64>(q, k, v, ks, vs, tables, row_of, slots, p_end, s_start,
                                         out, plan, part_o, part_ml, T, H, KVH, mb, n_split,
                                         grid_x, scale, stream);
    if (hd == 128)
      return launch_chunk_tc_hd<KVT, 128>(q, k, v, ks, vs, tables, row_of, slots, p_end,
                                          s_start, out, plan, part_o, part_ml, T, H, KVH, mb,
                                          n_split, grid_x, scale, stream);
  } else {
    if (hd == 64)
      return launch_chunk_hd<QT, KVT, 64>(q, k, v, ks, vs, tables, row_of, slots, p_end,
                                          s_start, out, T, H, KVH, mb, scale, stream);
    if (hd == 128)
      return launch_chunk_hd<QT, KVT, 128>(q, k, v, ks, vs, tables, row_of, slots, p_end,
                                           s_start, out, T, H, KVH, mb, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Dispatch on (q dtype, pool dtype): q is f32 or bf16; a float pool has q's
// dtype, an int8 pool (with f32 scales of shape (n_blocks, KVH)) takes either.
#define PA_DISPATCH(FN, ...)                                                      \
  switch (q_dtype * 3 + kv_dtype) {                                               \
    case kF32 * 3 + kF32: return static_cast<int>(FN<float, float>(__VA_ARGS__));  \
    case kF32 * 3 + kI8: return static_cast<int>(FN<float, int8_t>(__VA_ARGS__));  \
    case kBF16 * 3 + kBF16:                                                       \
      return static_cast<int>(FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__));     \
    case kBF16 * 3 + kI8:                                                         \
      return static_cast<int>(FN<__nv_bfloat16, int8_t>(__VA_ARGS__));            \
    default: return static_cast<int>(cudaErrorInvalidValue);                      \
  }

extern "C" {

// Bytes of dynamic shared memory one thread block takes.
int pa_smem_bytes(int G, int hd) {
  return static_cast<int>(decode_smem_floats(G, hd) * sizeof(float));
}

// Each launcher returns the cudaError_t of its launches (0 on success).
// part_o: (B, KVH, n_split, G, hd) and part_ml: (B, KVH, n_split, G, 2)
// float32 scratch the caller allocates; chunk: table entries per split.
int pa_paged_decode_attention(int q_dtype, int kv_dtype, const void* q, const void* k_pool,
                              const void* v_pool, const float* k_scale, const float* v_scale,
                              const int* tables, const int* lengths, void* out, float* part_o,
                              float* part_ml, int B, int H, int KVH, int hd, int bs, int mb,
                              int n_split, int chunk, float scale, void* stream) {
  PA_DISPATCH(launch_decode, q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, part_o,
              part_ml, B, H, KVH, hd, bs, mb, n_split, chunk, scale,
              static_cast<cudaStream_t>(stream))
}

// plan: int32 scratch of 1 + 2 T; part_o: (T, KVH, n_split, G, hd) and
// part_ml: (T, KVH, n_split, G, 2) float32 scratch where n_split > 1. Only
// the tensor-core path (bf16 q) reads plan, part_o, part_ml, n_split, grid_x.
int pa_paged_chunk_attention(int q_dtype, int kv_dtype, const void* q, const void* k_pool,
                             const void* v_pool, const float* k_scale, const float* v_scale,
                             const int* tables, const int* row_of, const int* slots,
                             const int* p_end, const int* s_start, void* out, int* plan,
                             float* part_o, float* part_ml, int T, int H, int KVH, int hd, int bs,
                             int mb, int n_split, int grid_x, float scale, void* stream) {
  PA_DISPATCH(launch_chunk, q, k_pool, v_pool, k_scale, v_scale, tables,
              row_of, slots, p_end, s_start, out, plan, part_o, part_ml, T, H, KVH, hd, bs, mb,
              n_split, grid_x, scale, static_cast<cudaStream_t>(stream))
}

// Bytes of dynamic shared memory of a tensor-core chunk block.
int pa_chunk_tc_smem_bytes(int hd, int mb) { return chunk_tc_smem_bytes(hd, mb); }

// The chunk kernel's tile plan alone (plan: int32 of 1 + 2 T), for tests.
int pa_chunk_tile_plan(const int* row_of, int T, int G, int* plan, void* stream) {
  const int tt = chunk_tile_tokens(G);
  if (tt < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  chunk_plan_kernel<<<1, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      row_of, T, tt, plan, nullptr, nullptr, 1, 1, 8, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
