// Fused dense-retrieval scoring and top-k for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes). Built by
// repro_torch/kernels/_build.py.
//
// topk_retrieval
//   Replaces the Pallas kernel repro/kernels/topk_retrieval.py::
//   topk_retrieval (body _topk_kernel). Scores queries (B, d) against docs
//   (N, d) in float32 and returns, per query, the k best as (B, k) float32
//   scores and (B, k) int32 doc ids in descending score order, equal scores
//   resolved to the lower doc id (the order of lax.top_k). Docs are float32
//   or bfloat16; queries arrive in float32. k <= 128, d % 8 == 0.
//
// What bounds it on the H100: the bytes. At the retrieval phase's shapes
// (N = 2^21, d = 768, B = 32) the corpus is read once: 6.4 GB in f32, 1.92
// ms at 3.35 TB/s (bf16: 0.96 ms). The products are 2 B N d = 1.0e11 flop;
// taken on the tensor cores in split form (below) they are 3 (f32 docs) or 2
// (bf16 docs) tf32-rate products, 3.1e11 / 2.1e11 flop, 0.63 / 0.42 ms at
// the 495 TFLOP/s dense tf32 rate.
//
// Design.
//   Pass 1, topk_partial_kernel: one persistent block per SM owns a
//   contiguous slice of the corpus (whole 128-doc tiles) and a tile of 32
//   queries, held in shared memory in f32 for the whole slice. A consumer
//   warpgroup, eight selection warps and a producer warp:
//   - the producer streams the slice's doc tiles in stages of 128 docs x
//     128 bytes (32 f32 or 64 bf16 columns, 16 KB, 16-byte chunks swizzled
//     as wgmma's 128-byte K-major layout wants) into a ring of n_stages (5
//     f32, 6 bf16 at d 768) with cp.async 16-byte copies, each stage's
//     arrival counted on an mbarrier (cp.async.mbarrier.arrive); it refills
//     a stage when the consumers' mbarrier releases it, so 80-96 KB stay in
//     flight per SM and no load waits on the selection (the ring's depth
//     sets the pace: 2, 3, 4 stages ran f32 in 3.13, 2.66, 2.48 ms).
//   - the consumers take each stage on the tensor cores with wgmma
//     m64n128, B = the stage's 128 docs from shared memory, A = 64 rows from
//     registers: warp w's rows are, for each of its 8 queries, two parts of
//     the query (rows g and g + 8 of its 16), so that one product yields
//     both parts' scores and a thread adds its own two rows.
//     f32 docs, in split tf32 (tf32_mma.cuh): the parts are q_hi and q_lo
//     (hi = the top 19 bits, lo = q - hi); the tensor core reads the raw
//     stage as d_hi (it keeps a tf32 operand's top 19 bits), and a pass
//     over the stage writes d_lo = d - d_hi to a buffer of its own while
//     the d_hi products run:
//     [q_hi; q_lo] d_hi + [q_hi; q_lo] d_lo, two m64n128k8 a k8 step (q_lo
//     d_lo comes free).
//     bf16 docs, exact in bf16: q = b0 + b1 + b2 exactly in bf16 (each the
//     rounded rest of the one before), [b0; b1] d + [b2; 0] d, two
//     m64n128k16 a k16 step. Products of tf32 or bf16 values are exact and
//     summed in f32, so the scores are as close to the f32 sums as an FMA
//     chain; one tf32 product alone keeps about three digits.
//   - at a tile's end each consumer thread holds its query's scores of 32
//     of the tile's docs; it adds its two rows and stores them to the score
//     tile (its mbarriers hand it to the selection and back), and the
//     consumers go on to the next tile.
//   - eight selection warps, 4 queries each, filter the score tile against
//     each query's k-th best so far (only a better (score, id) passes; a
//     warp vote skips a query when nothing does) and append the survivors
//     to the query's buffer of 64 in shared memory. A full buffer is sorted
//     in registers (a bitonic network over shuffles) and merged into the
//     query's sorted list, which lives in the warp's registers (K / 32
//     scores and ids a lane). The k-th best rises as the lists fill, so
//     after the first tiles almost nothing passes; the selection runs
//     beside the products, not in their way.
//   Pass 2, topk_merge_kernel: block b merges query b's n_slices sorted
//   lists as a binary tree, a warp a pair (merge of two sorted lists: the
//   better of a[i] and b[K - 1 - i], then a bitonic merge, in registers).
//   Equal scores go to the lower id everywhere (`better`), so integer-valued
//   inputs, whose products and sums are exact in any order and split, give
//   the plain version's ids exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kConsumers = 4;                      // one warpgroup on the products
constexpr int kSelectors = 8;                      // warps on the selection
constexpr int kProducer = kConsumers + kSelectors; // the producer warp's index
constexpr int kThreads = 32 * (kProducer + 1);
constexpr int kQT = 32;                            // queries per block
constexpr int kQPerWarp = kQT / kConsumers;        // 8: a warp's 16 rows of A, 2 parts of each
constexpr int kQPerSel = kQT / kSelectors;         // 4 queries a selection warp
constexpr int kCap = 64;                           // a query's candidate buffer
constexpr int kTD = 128;                           // docs per tile: wgmma's N
constexpr int kSS = kTD + 4;                       // score tile row (floats)
constexpr int kRowBytes = 128;                     // bytes of a doc row in one stage
constexpr int kStageBytes = kTD * kRowBytes;       // 16 KB
constexpr int kAlign = 1024;                       // the swizzled stages' alignment
constexpr int kMaxStages = 8;
constexpr int kMergeMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoId = 0x7fffffff;                  // id of an empty list entry

enum DType { kF32 = 0, kBF16 = 1 };

// the order of the result: higher score first, then lower id
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// ---------------------------------------------------------------------------
// sorted lists in registers: K = 32 R entries, entry i = (s[i / 32], id[i / 32])
// of lane i % 32, best first
// ---------------------------------------------------------------------------

// one compare-exchange step of a bitonic network at stride `stride`, the
// lower index keeping the better entry where `desc`
template <int R>
__device__ __forceinline__ void cx_step(float (&s)[R], int (&id)[R], int stride, int size,
                                        int lane) {
  if (stride >= 32) {
    const int rs = stride >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & rs) continue;
      const bool desc = ((r * 32 + lane) & size) == 0;
      const float a = s[r], b = s[r | rs];
      const int ia = id[r], ib = id[r | rs];
      if (desc ? better(b, ib, a, ia) : better(a, ia, b, ib)) {
        s[r] = b; s[r | rs] = a; id[r] = ib; id[r | rs] = ia;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float ps = __shfl_xor_sync(kFull, s[r], stride);
      const int pid = __shfl_xor_sync(kFull, id[r], stride);
      const bool desc = ((r * 32 + lane) & size) == 0;
      const bool lower = (lane & stride) == 0;
      // take the partner's entry where it is the one this index keeps
      if (better(ps, pid, s[r], id[r]) == (lower == desc)) { s[r] = ps; id[r] = pid; }
    }
  }
}

template <int R>
__device__ __forceinline__ void sort_desc(float (&s)[R], int (&id)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) cx_step<R>(s, id, stride, size, lane);
}

// (s, id) (sorted) becomes the best K of itself and (bs, bi) (sorted): the
// better of entry i and entry K - 1 - i of the other is a bitonic sequence
// holding the best K of the union, which a bitonic merge sorts.
template <int R>
__device__ __forceinline__ void merge_desc(float (&s)[R], int (&id)[R], const float (&bs)[R],
                                           const int (&bi)[R], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float o = __shfl_sync(kFull, bs[R - 1 - r], 31 - lane);
    const int oi = __shfl_sync(kFull, bi[R - 1 - r], 31 - lane);
    if (better(o, oi, s[r], id[r])) { s[r] = o; id[r] = oi; }
  }
#pragma unroll
  for (int stride = 16 * R; stride > 0; stride >>= 1) cx_step<R>(s, id, stride, 64 * R, lane);
}

// entry k - 1 of a list, on every lane
template <int R>
__device__ __forceinline__ void kth(const float (&s)[R], const int (&id)[R], int k, float& ts,
                                    int& ti) {
  const int r = (k - 1) >> 5;
  float v = s[0];
  int iv = id[0];
#pragma unroll
  for (int j = 1; j < R; ++j)
    if (r == j) { v = s[j]; iv = id[j]; }
  ts = __shfl_sync(kFull, v, (k - 1) & 31);
  ti = __shfl_sync(kFull, iv, (k - 1) & 31);
}

// ---------------------------------------------------------------------------
// mbarriers and cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ bool bar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
// 16 bytes from global to shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// arrive on `bar` when this thread's earlier cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}
// the consumer warpgroup's barrier (named barrier 1; the producer is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumers) : "memory");
}
// shared-memory writes of this thread (and what it has acquired) before
// later reads by the tensor cores' async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// d (the 64 x 128 f32 accumulator fragment) += a (a 64 x 8 tf32 register
// fragment) x B (128 x 8 tf32, K-major, at desc); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
// the same in bf16: a 64 x 16 register fragment, B 128 x 16 (not transposed)
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart; a k step inside the rows advances
// the start address
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving reads of wgmma's registers across its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// x = b0 + b1 + b2 exactly, each bf16 (the rounded rest of the one before)
__device__ __forceinline__ void split3(float x, __nv_bfloat16& b0, __nv_bfloat16& b1,
                                      __nv_bfloat16& b2) {
  b0 = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(b0);
  b1 = __float2bfloat16_rn(r1);
  b2 = __float2bfloat16_rn(r1 - __bfloat162float(b1));
}

// ---------------------------------------------------------------------------
// a stage's products by doc type
// ---------------------------------------------------------------------------

template <typename T> struct Doc;

// f32 docs: 32 columns a stage, 4 k8 steps; one d_lo buffer; query rows
// padded to 4 mod 32 floats (conflict-free A loads)
template <> struct Doc<float> {
  static constexpr int kCols = 32;
  static constexpr int kLoBufs = 1;
  static constexpr int kQPad = 4;
  // acc (+)= [q_hi; q_lo] x (d_hi + d_lo) over the stage's 32 columns
  // (columns c * 32 + ... of the query row qrow). The d_hi products run
  // while the warps write d_lo = d - d_hi to lo; then the d_lo products.
  __device__ static void products(float (&acc)[64], const char* stage, char* lo, const float* qrow,
                                  int c, int t, int tid) {
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p = qrow + c * kCols + 8 * kk + t;
      tf32::split_trunc(p[0], a[kk][0], a[kk][1]);     // rows g / g + 8: hi / lo
      tf32::split_trunc(p[4], a[kk][2], a[kk][3]);
    }
    const uint32_t sa = smem_addr(stage), la = smem_addr(lo);
    fence_proxy_async();                   // the stage's copies, for the async proxy
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32(acc, a[kk], desc_sw128(sa + 32 * kk), c > 0 || kk > 0);
    consumers_sync();                      // every warp's products of the last stage are done with lo
#pragma unroll
    for (int m = 0; m < kStageBytes / 16 / (32 * kConsumers); ++m) {
      const int off = (tid + 32 * kConsumers * m) * 16;
      const float4 x = *reinterpret_cast<const float4*>(stage + off);
      uint4 h, l;
      tf32::split_trunc(x.x, h.x, l.x);
      tf32::split_trunc(x.y, h.y, l.y);
      tf32::split_trunc(x.z, h.z, l.z);
      tf32::split_trunc(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
    fence_proxy_async();
    consumers_sync();                      // every warp's d_lo written
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32(acc, a[kk], desc_sw128(la + 32 * kk), 1);
    wgmma_commit_and_wait();
    fence_regs(acc);
    fence_regs(a);
  }
};

// bf16 docs: 64 columns a stage, 4 k16 steps; no d_lo; query rows padded
// to 8 mod 32 floats
template <> struct Doc<__nv_bfloat16> {
  static constexpr int kCols = 64;
  static constexpr int kLoBufs = 0;
  static constexpr int kQPad = 8;
  __device__ static void products(float (&acc)[64], const char* stage, char*, const float* qrow,
                                  int c, int t, int) {
    fence_proxy_async();                   // the stage's copies, for the async proxy
    uint32_t a1[4][4], a2[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // columns 2t, 2t + 1 (registers 0, 1) and 2t + 8, 2t + 9 (2, 3) of the k16 step
      const float* p = qrow + c * kCols + 16 * kk + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = *reinterpret_cast<const float2*>(p + 8 * h);
        __nv_bfloat16 x0[3], x1[3];
        split3(x.x, x0[0], x0[1], x0[2]);
        split3(x.y, x1[0], x1[1], x1[2]);
        a1[kk][2 * h] = pack_bf16(x0[0], x1[0]);       // row g: b0
        a1[kk][2 * h + 1] = pack_bf16(x0[1], x1[1]);   // row g + 8: b1
        a2[kk][2 * h] = pack_bf16(x0[2], x1[2]);       // row g: b2
        a2[kk][2 * h + 1] = 0u;                        // row g + 8: nothing
      }
    }
    const uint32_t sa = smem_addr(stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_bf16(acc, a1[kk], desc_sw128(sa + 32 * kk), c > 0 || kk > 0);
      wgmma_bf16(acc, a2[kk], desc_sw128(sa + 32 * kk), 1);
    }
    wgmma_commit_and_wait();
    fence_regs(acc);
    fence_regs(a1);
    fence_regs(a2);
  }
};

// ---------------------------------------------------------------------------
// the selection: a selection warp's 8 queries, lists in registers
// ---------------------------------------------------------------------------

// list j of the warp's 8 (j runtime) into / out of (ts, ti)
template <int R>
__device__ __forceinline__ void pick(const float (&ls)[kQPerSel][R],
                                     const int (&li)[kQPerSel][R], int j, float (&ts)[R],
                                     int (&ti)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) { ts[r] = ls[0][r]; ti[r] = li[0][r]; }
#pragma unroll
  for (int jj = 1; jj < kQPerSel; ++jj)
    if (jj == j)
#pragma unroll
      for (int r = 0; r < R; ++r) { ts[r] = ls[jj][r]; ti[r] = li[jj][r]; }
}
template <int R>
__device__ __forceinline__ void put(float (&ls)[kQPerSel][R], int (&li)[kQPerSel][R], int j,
                                    const float (&ts)[R], const int (&ti)[R]) {
#pragma unroll
  for (int jj = 0; jj < kQPerSel; ++jj)
    if (jj == j)
#pragma unroll
      for (int r = 0; r < R; ++r) { ls[jj][r] = ts[r]; li[jj][r] = ti[r]; }
}

// the warp merges query j's buffer (n entries at bs / bi) into list j and
// returns the list's k-th best in (ts, ti)
template <int R>
__device__ __forceinline__ void flush(float (&ls)[kQPerSel][R], int (&li)[kQPerSel][R], int j,
                                      const float* bs, const int* bi, int n, int k, int lane,
                                      float& ts, int& ti) {
  constexpr int RB = kCap / 32;
  float fs[RB];
  int fi[RB];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int e = 32 * r + lane;
    fs[r] = e < n ? bs[e] : -INFINITY;
    fi[r] = e < n ? bi[e] : kNoId;
  }
  __syncwarp();
  sort_desc<RB>(fs, fi, lane);
  float s[R], os[R];
  int id[R], oi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {                    // the buffer's best K (or all of it)
    os[r] = r < RB ? fs[r] : -INFINITY;
    oi[r] = r < RB ? fi[r] : kNoId;
  }
  pick<R>(ls, li, j, s, id);
  merge_desc<R>(s, id, os, oi, lane);
  put<R>(ls, li, j, s, id);
  kth<R>(s, id, k, ts, ti);
}

// One query's candidates, a lane one (valid = false offers nothing): those
// better than the query's k-th best (ts, ti) go to its buffer (cnt
// entries); a buffer they would overflow is merged into the list first.
template <int R>
__device__ __forceinline__ void offer(float (&ls)[kQPerSel][R], int (&li)[kQPerSel][R], int j,
                                      float* bs, int* bi, int& cnt, float& ts, int& ti,
                                      float s, int id, bool valid, int k, int lane) {
  bool pass = valid && better(s, id, ts, ti);
  unsigned m = __ballot_sync(kFull, pass);
  if (m == 0) return;
  if (cnt + __popc(m) > kCap) {
    flush<R>(ls, li, j, bs, bi, cnt, k, lane, ts, ti);
    cnt = 0;
    pass = valid && better(s, id, ts, ti);
    m = __ballot_sync(kFull, pass);
  }
  if (pass) {
    const int pos = cnt + __popc(m & ((1u << lane) - 1u));
    bs[pos] = s;
    bi[pos] = id;
  }
  cnt += __popc(m);
}

// Pass 1. Block (slice, query tile): the top-k of each of the tile's queries
// over the slice's docs [tile0 * kTD, tile1 * kTD), written to
// part[query][slice][0..k).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
topk_partial_kernel(const float* __restrict__ q, const T* __restrict__ docs,
                    float* __restrict__ part_s, int* __restrict__ part_i, int B, int N, int d,
                    int k, int QS, int n_chunks, int tiles_per_slice, int n_slices,
                    int n_stages) {
  constexpr int R = K / 32;
  extern __shared__ char smem_raw[];
  char* ring = smem_raw + ((kAlign - smem_addr(smem_raw) % kAlign) % kAlign);  // n_stages x 16 KB
  char* lo_buf = ring + n_stages * kStageBytes;                      // d_lo (f32 docs)
  float* q_s = reinterpret_cast<float*>(lo_buf + Doc<T>::kLoBufs * kStageBytes);  // [kQT][QS]
  float* sc = q_s + kQT * QS;                                         // scores [kQT][kSS]
  float* buf_s = sc + kQT * kSS;                                      // [kQT][kCap]
  int* buf_i = reinterpret_cast<int*>(buf_s + kQT * kCap);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf_i + kQT * kCap);  // [n_stages]
  uint64_t* empty = full + n_stages;                                  // [n_stages]
  uint64_t* sc_full = empty + n_stages;                               // the score tile's
  uint64_t* sc_empty = sc_full + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x, q0 = blockIdx.y * kQT;
  const int n_tiles = (N + kTD - 1) / kTD;
  const int tile0 = slice * tiles_per_slice;
  const int tile1 = min(tile0 + tiles_per_slice, n_tiles);

  if (tid == 0) {
    for (int st = 0; st < n_stages; ++st) {
      bar_init(&full[st], 32);          // the producer's lanes, via cp.async arrivals
      bar_init(&empty[st], kConsumers);  // one arrival per consumer warp
    }
    bar_init(sc_full, kConsumers);
    bar_init(sc_empty, kSelectors);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducer) {
    // ---- producer: stream the slice, stage by stage, through the ring ----
    // lane copies chunk ch of rows r0 + 4m (m < 32) of each stage, to chunk
    // ch ^ (row % 8) of the row (the 128-byte swizzle)
    constexpr int kVec = 16 / sizeof(T);             // elements of a 16-byte chunk
    constexpr int kPer = kStageBytes / 16 / 32;      // copies a lane a stage
    const int r0 = lane >> 3, ch = lane & 7;
    const int dst0 = r0 * kRowBytes + ((ch ^ r0) << 4);        // rows r0 + 8m
    const int dst1 = (r0 + 4) * kRowBytes + ((ch ^ (r0 + 4)) << 4);  // rows r0 + 4 + 8m
    const size_t row_step = (size_t)4 * d;
    int st = 0;
    uint32_t par = 0;
    for (int tile = tile0; tile < tile1; ++tile) {
      const int doc0 = tile * kTD + r0;
      const int rows_left = N - doc0;                // copy m is a doc while 4 m < rows_left
      for (int c = 0; c < n_chunks; ++c) {
        const int col = c * Doc<T>::kCols + ch * kVec;
        const T* src = docs + (size_t)doc0 * d + col;
        const int m_end = col < d ? rows_left : 0;
        bar_wait(&empty[st], par ^ 1);               // the consumers are done with it
        char* dst = ring + st * kStageBytes;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const bool ok = 4 * m < m_end;
          cp_async16(dst + (m & 1 ? dst1 : dst0) + (m >> 1) * 8 * kRowBytes,
                     ok ? src + m * row_step : docs, ok ? 16 : 0);
        }
        cp_async_arrive(&full[st]);
        if (++st == n_stages) { st = 0; par ^= 1; }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  if (warp < kConsumers) {
    // ---- consumers: the products, a tile's scores to the score tile ----
    for (int i = tid; i < kQT * (QS / 4); i += 32 * kConsumers) {   // the query tile, zero past B, d
      const int row = i / (QS / 4), col = 4 * (i % (QS / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + row < B && col < d)
        v = *reinterpret_cast<const float4*>(q + (size_t)(q0 + row) * d + col);
      *reinterpret_cast<float4*>(q_s + row * QS + col) = v;
    }
    consumers_sync();
    // lane (g, t) computes query 8 warp + g's scores of docs 8 i + 2 t + e
    const int g = lane >> 2, t = lane & 3;
    const float* qrow = q_s + (kQPerWarp * warp + g) * QS;
    float* srow = sc + (kQPerWarp * warp + g) * kSS + 2 * t;
    int st = 0;
    uint32_t par = 0, sc_par = 0;
    for (int tile = tile0; tile < tile1; ++tile) {
      float acc[64];
      for (int c = 0; c < n_chunks; ++c) {
        bar_wait(&full[st], par);
        Doc<T>::products(acc, ring + st * kStageBytes, lo_buf, qrow, c, t, tid);
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[st]);
        if (++st == n_stages) { st = 0; par ^= 1; }
      }
      bar_wait(sc_empty, sc_par ^ 1);                // the selection is done with the last tile
#pragma unroll
      for (int i = 0; i < 16; ++i)                   // the query's two rows added
        *reinterpret_cast<float2*>(srow + 8 * i) =
            make_float2(acc[4 * i] + acc[4 * i + 2], acc[4 * i + 1] + acc[4 * i + 3]);
      __syncwarp();
      if (lane == 0) bar_arrive(sc_full);
      sc_par ^= 1;
    }
    return;
  }

  // ---- selection warps: each takes 8 queries' scores of every tile ----
  const int sw = warp - kConsumers;
  float ls[kQPerSel][R];
  int li[kQPerSel][R];
#pragma unroll
  for (int j = 0; j < kQPerSel; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) { ls[j][r] = -INFINITY; li[j][r] = kNoId; }
  // per query, warp-uniform: the k-th best so far and the buffer's count
  // (arrays with a runtime index: local memory, read once a query a tile)
  float thr_s[kQPerSel];
  int thr_i[kQPerSel], cnt[kQPerSel];
  for (int j = 0; j < kQPerSel; ++j) { thr_s[j] = -INFINITY; thr_i[j] = kNoId; cnt[j] = 0; }
  uint32_t sc_par = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    bar_wait(sc_full, sc_par);
    const int doc0 = tile * kTD + 4 * lane;          // this lane's 4 docs
#pragma unroll 1
    for (int j = 0; j < kQPerSel; ++j) {
      const int qi = kQPerSel * sw + j;
      const bool select = q0 + qi < B;               // warp-uniform
      if (!select) continue;
      const float4 v = *reinterpret_cast<const float4*>(sc + qi * kSS + 4 * lane);
      float ts = thr_s[j];
      int ti = thr_i[j];
      const bool any = (doc0 < N && better(v.x, doc0, ts, ti)) ||
                       (doc0 + 1 < N && better(v.y, doc0 + 1, ts, ti)) ||
                       (doc0 + 2 < N && better(v.z, doc0 + 2, ts, ti)) ||
                       (doc0 + 3 < N && better(v.w, doc0 + 3, ts, ti));
      if (!__any_sync(kFull, any)) continue;
      int n = cnt[j];
#pragma unroll 1
      for (int e = 0; e < 4; ++e) {
        const float x = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
        offer<R>(ls, li, j, buf_s + qi * kCap, buf_i + qi * kCap, n, ts, ti, x, doc0 + e,
                 doc0 + e < N, k, lane);
      }
      thr_s[j] = ts;
      thr_i[j] = ti;
      cnt[j] = n;
    }
    __syncwarp();
    if (lane == 0) bar_arrive(sc_empty);
    sc_par ^= 1;
  }

  // the buffers' last candidates into the lists, then the lists out
#pragma unroll 1
  for (int j = 0; j < kQPerSel; ++j) {
    const int qi = kQPerSel * sw + j;
    if (q0 + qi >= B) break;
    float ts, s[R];
    int ti, id[R];
    flush<R>(ls, li, j, buf_s + qi * kCap, buf_i + qi * kCap, cnt[j], k, lane, ts, ti);
    pick<R>(ls, li, j, s, id);
    const size_t o = ((size_t)(q0 + qi) * n_slices + slice) * k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = 32 * r + lane;
      if (e < k) { part_s[o + e] = s[r]; part_i[o + e] = id[r]; }
    }
  }
}

// Pass 2. Block b merges query b's n_lists sorted lists of k (part[b][l])
// as a binary tree, a warp a pair: level 1 from global memory into ping,
// then ping -> pong -> ping ... in shared memory, then the root out.
template <int K>
__global__ void __launch_bounds__(32 * kMergeMaxWarps)
topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                  float* __restrict__ out_s, int* __restrict__ out_i, int n_lists, int k) {
  constexpr int R = K / 32;
  extern __shared__ __align__(16) float msm[];     // lists of K scores then K ids
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int b = blockIdx.x;
  const int half = (n_lists + 1) / 2;
  float* ping = msm;
  float* pong = msm + 2 * K * half;

  auto load_part = [&](int l, float (&s)[R], int (&id)[R]) {
    const size_t o = ((size_t)b * n_lists + l) * k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = 32 * r + lane;
      s[r] = e < k ? part_s[o + e] : -INFINITY;
      id[r] = e < k ? part_i[o + e] : kNoId;
    }
  };
  auto load_list = [&](const float* src, int l, float (&s)[R], int (&id)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = src[2 * K * l + 32 * r + lane];
      id[r] = __float_as_int(src[2 * K * l + K + 32 * r + lane]);
    }
  };
  auto store_list = [&](float* dst, int l, const float (&s)[R], const int (&id)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dst[2 * K * l + 32 * r + lane] = s[r];
      dst[2 * K * l + K + 32 * r + lane] = __int_as_float(id[r]);
    }
  };

  for (int p = warp; p < half; p += n_warps) {
    float s[R], os[R];
    int id[R], oi[R];
    load_part(2 * p, s, id);
    if (2 * p + 1 < n_lists) {
      load_part(2 * p + 1, os, oi);
      merge_desc<R>(s, id, os, oi, lane);
    }
    store_list(ping, p, s, id);
  }
  __syncthreads();
  int n = half;
  float* src = ping;
  float* dst = pong;
  while (n > 1) {
    const int m = (n + 1) / 2;
    for (int p = warp; p < m; p += n_warps) {
      float s[R], os[R];
      int id[R], oi[R];
      load_list(src, 2 * p, s, id);
      if (2 * p + 1 < n) {
        load_list(src, 2 * p + 1, os, oi);
        merge_desc<R>(s, id, os, oi, lane);
      }
      store_list(dst, p, s, id);
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
    n = m;
  }
  if (warp == 0) {
    float s[R];
    int id[R];
    load_list(src, 0, s, id);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = 32 * r + lane;
      if (e < k) { out_s[(size_t)b * k + e] = s[r]; out_i[(size_t)b * k + e] = id[r]; }
    }
  }
}

int list_capacity(int k) { return k <= 32 ? 32 : (k <= 64 ? 64 : 128); }

template <typename T>
int query_row(int d) {
  return (d + Doc<T>::kCols - 1) / Doc<T>::kCols * Doc<T>::kCols + Doc<T>::kQPad;
}

// the ring, the d_lo buffer (f32), the query tile, the score tile, the
// candidate buffers, the mbarriers, and room to align the ring to 1024 bytes
template <typename T>
int partial_smem_bytes(int d, int n_stages) {
  return kAlign + (n_stages + Doc<T>::kLoBufs) * kStageBytes + kQT * query_row<T>(d) * 4 +
         kQT * kSS * 4 + kQT * kCap * 8 + (2 * n_stages + 2) * 8;
}

int merge_smem_bytes(int n_lists, int K) {
  const int half = (n_lists + 1) / 2;
  return (half + (half + 1) / 2) * 2 * K * 4;
}

template <typename T, int K>
int launch(const float* q, const T* docs, float* part_s, int* part_i, float* out_s, int* out_i,
           int B, int N, int d, int k, int n_slices, int tiles_per_slice, int n_stages,
           cudaStream_t stream) {
  if (n_stages < 2 || n_stages > kMaxStages) return cudaErrorInvalidValue;
  const int smem = partial_smem_bytes<T>(d, n_stages);
  auto* pass1 = topk_partial_kernel<T, K>;
  cudaError_t err =
      cudaFuncSetAttribute(pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int QS = query_row<T>(d);
  const int n_chunks = (d + Doc<T>::kCols - 1) / Doc<T>::kCols;
  const dim3 grid(n_slices, (B + kQT - 1) / kQT);
  pass1<<<grid, kThreads, smem, stream>>>(q, docs, part_s, part_i, B, N, d, k, QS, n_chunks,
                                          tiles_per_slice, n_slices, n_stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int msmem = merge_smem_bytes(n_slices, K);
  auto* pass2 = topk_merge_kernel<K>;
  err = cudaFuncSetAttribute(pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, msmem);
  if (err != cudaSuccess) return err;
  const int warps = (n_slices + 1) / 2 < kMergeMaxWarps ? (n_slices + 1) / 2 : kMergeMaxWarps;
  pass2<<<B, 32 * warps, msmem, stream>>>(part_s, part_i, out_s, out_i, n_slices, k);
  return cudaGetLastError();
}

template <typename T>
int dispatch_k(const float* q, const T* docs, float* part_s, int* part_i, float* out_s,
               int* out_i, int B, int N, int d, int k, int n_slices, int tiles_per_slice,
               int n_stages, cudaStream_t stream) {
  switch (list_capacity(k)) {
    case 32:
      return launch<T, 32>(q, docs, part_s, part_i, out_s, out_i, B, N, d, k, n_slices,
                           tiles_per_slice, n_stages, stream);
    case 64:
      return launch<T, 64>(q, docs, part_s, part_i, out_s, out_i, B, N, d, k, n_slices,
                           tiles_per_slice, n_stages, stream);
    default:
      return launch<T, 128>(q, docs, part_s, part_i, out_s, out_i, B, N, d, k, n_slices,
                            tiles_per_slice, n_stages, stream);
  }
}

}  // namespace

extern "C" {

// constants and sizes the wrapper's plan (kernels/topk_retrieval.py) mirrors
int tk_max_k() { return 128; }
int tk_docs_per_tile() { return kTD; }
int tk_query_tile() { return kQT; }
int tk_smem_bytes(int doc_dtype, int d, int k, int n_stages) {
  (void)k;                                         // the same for every k
  return doc_dtype == kF32 ? partial_smem_bytes<float>(d, n_stages)
                           : partial_smem_bytes<__nv_bfloat16>(d, n_stages);
}
int tk_merge_smem_bytes(int n_lists, int k) { return merge_smem_bytes(n_lists, list_capacity(k)); }

// queries: (B, d) float32, 16-byte aligned; docs: (N, d) float32 (doc_dtype
// 0) or bfloat16 (1), rows 16-byte aligned (d % 8 == 0); part_s/part_i:
// (B, n_slices, k) scratch; out_s/out_i: (B, k). Slice j covers doc tiles
// [j * tiles_per_slice, (j + 1) * tiles_per_slice) of kTD docs; n_stages
// ring stages. Returns a cudaError_t (0 = launched).
int tk_topk_retrieval(int doc_dtype, const void* q, const void* docs, void* part_s,
                      void* part_i, void* out_s, void* out_i, int B, int N, int d, int k,
                      int n_slices, int tiles_per_slice, int n_stages, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  if (doc_dtype == kF32)
    return dispatch_k(qf, static_cast<const float*>(docs), ps, pi, os, oi, B, N, d, k, n_slices,
                      tiles_per_slice, n_stages, s);
  if (doc_dtype == kBF16)
    return dispatch_k(qf, static_cast<const __nv_bfloat16*>(docs), ps, pi, os, oi, B, N, d, k,
                      n_slices, tiles_per_slice, n_stages, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
