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
// (kernels/decode_attention.py::decode_split), the same rule as the dense
// decode kernel's. The chunk kernel keeps one block per (token, KV head) over
// the whole chain. Known weak spot (later work): it reads a row's KV once per
// packed token of that row.
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

template <typename QT, typename KVT>
cudaError_t launch_chunk(const void* q, const void* k, const void* v, const float* ks,
                         const float* vs, const int* tables, const int* row_of,
                         const int* slots, const int* p_end, const int* s_start, void* out,
                         int T, int H, int KVH, int hd, int bs, int mb, float scale,
                         cudaStream_t stream) {
  if (bs != kBS) return cudaErrorInvalidValue;
  if (hd == 64)
    return launch_chunk_hd<QT, KVT, 64>(q, k, v, ks, vs, tables, row_of, slots, p_end,
                                        s_start, out, T, H, KVH, mb, scale, stream);
  if (hd == 128)
    return launch_chunk_hd<QT, KVT, 128>(q, k, v, ks, vs, tables, row_of, slots, p_end,
                                         s_start, out, T, H, KVH, mb, scale, stream);
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

int pa_paged_chunk_attention(int q_dtype, int kv_dtype, const void* q, const void* k_pool,
                             const void* v_pool, const float* k_scale, const float* v_scale,
                             const int* tables, const int* row_of, const int* slots,
                             const int* p_end, const int* s_start, void* out, int T, int H,
                             int KVH, int hd, int bs, int mb, float scale, void* stream) {
  PA_DISPATCH(launch_chunk, q, k_pool, v_pool, k_scale, v_scale, tables,
              row_of, slots, p_end, s_start, out, T, H, KVH, hd, bs, mb, scale,
              static_cast<cudaStream_t>(stream))
}

}  // extern "C"
