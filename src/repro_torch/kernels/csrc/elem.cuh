// Element access shared by the f32 and bf16 instances of the conv kernels
// (trim_conv2d.cu, trim_conv2d_fused.cu).  A bf16 value widens to f32
// exactly (its 16 bits are the high half of the f32), and a product of two
// bf16 values is exact in f32, so the bf16 route "ffma" (Cin/g not a
// multiple of 16) runs the f32 kernel's fmaf chain on the same real numbers
// as JAX's bf16 x bf16 -> f32 tap matmuls; route "mma" feeds the bf16
// values to the tensor cores instead (bf16_mma.cuh: no widening, the same
// exact products, the tensor core's f32 sum).  Either way the one rounding
// to bf16 is at the store (__float2bfloat16_rn), where JAX's
// _epilogue_store casts to the output dtype.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements (16 bytes of f32, 8 of bf16) as a float4; the
// pointer is aligned to that size.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  // __bfloat1622float2 of each pair: element 2i is the low half of a word
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
