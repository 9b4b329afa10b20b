// Shared helpers of the port's guard kernels: four-wide row loads that
// upcast to f32, and four-wide stores that round once to the storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float& o) { o = v; }
// round-to-nearest-even, as jnp's and torch's casts to bf16
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16& o) { o = __float2bfloat16_rn(v); }

// Columns c..c+3 of one row, upcast to f32 (exact for bf16); columns at or
// past d read as 0.  VEC: d % 4 == 0 and the row start is aligned to four
// elements, so the four columns are all in range or all out.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ row, int64_t c, int64_t d,
                                      float v[4]) {
  if constexpr (VEC) {
    if (c < d) {
      if constexpr (sizeof(T) == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(row + c));
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      } else {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(row + c));
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
        v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
      }
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = (c + q < d) ? to_f32(row[c + q]) : 0.f;
  }
}

// Stores columns c..c+3 of one row, each rounded once to T; columns at or
// past d are skipped.  VEC as for load4.
template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* __restrict__ row, int64_t c, int64_t d,
                                       const float v[4]) {
  if constexpr (VEC) {
    if (c < d) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 t;
        t.x = *reinterpret_cast<const uint32_t*>(&lo);
        t.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(row + c) = t;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c + q < d) from_f32(v[q], row[c + q]);
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace rt
