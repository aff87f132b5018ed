// Split-tf32 products on Hopper's tensor cores, shared by the kernels that
// keep an f32 contract on them (rwkv6_scan.cu's segment pass,
// topk_retrieval.cu's scores). An f32 x is split into hi + lo, both tf32:
// a product taken as hi*hi + hi*lo + lo*hi (bf16 operands are exact in
// tf32 and need no lo) is as close to the f32 product as an f32 FMA chain,
// while one tf32 product alone keeps about three decimal digits.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both tf32 (x - hi is exact in f32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// x = hi + lo with hi x truncated to tf32 (one logic op) and lo = x - hi
// (exact in f32) left for the tensor core, which reads a tf32 operand's top
// 19 bits and so truncates lo as well. Two instructions instead of split's
// conversions; |lo| < 2^-10 |x|.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// c += a b on one m16n8k8 tile (a: 16 x 8 row-major fragment, b: 8 x 8
// column fragment, c: 16 x 8 f32)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tf32
