// Helpers shared by the scan kernels (rwkv6_scan.cu, ssm_scan.cu and their
// backward): raw vector loads of f32 or bf16 inputs, widened to f32 where
// they are used, and cp.async copies into shared memory.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

// 16-byte copies from global to shared memory in flight while the thread
// goes on (cp.async; the first src_bytes copied, the rest zero-filled):
// committed as a group, waited on before the data is read. A thread waits
// for its own copies only: what another thread reads needs a barrier after
// the wait.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace scan
