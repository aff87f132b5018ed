// Helpers shared by the scan kernels (rwkv6_scan.cu, ssm_scan.cu): raw
// vector loads of f32 or bf16 inputs, widened to f32 where they are used.
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

}  // namespace scan
