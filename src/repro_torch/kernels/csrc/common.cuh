// Shared helpers of the port's kernels: four-wide row loads that upcast to
// f32, four-wide stores that round once to the storage type, and the
// cp.async / ldmatrix / mma.sync wrappers of the tensor-core kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// The port's one worker cap: every kernel takes 1 <= m <= MAX_WORKERS
// (kernels/fused_guard.py repeats it for the wrappers).  It is
// filtered_mean's bound: its m weights fit in 48 KB of shared memory.
constexpr int64_t MAX_WORKERS = 12288;

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

// The raw words of four adjacent columns: a float4 of f32, or a uint2
// holding four bf16.  A kernel that prefetches a tile keeps the raw words
// and upcasts them only when it stores them (unpack4), so no instruction
// right after the load waits for the data to arrive.
template <typename T> struct Raw4 { using type = float4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };

// Columns c..c+3 of one row as raw words; columns at or past d read as 0.
// VEC as for load4.
template <typename T, bool VEC>
__device__ __forceinline__ typename Raw4<T>::type load4_raw(const T* __restrict__ row,
                                                            int64_t c, int64_t d) {
  using R = typename Raw4<T>::type;
  if constexpr (VEC) {
    return c < d ? __ldg(reinterpret_cast<const R*>(row + c)) : R{};
  } else if constexpr (sizeof(T) == 4) {
    return make_float4(c < d ? row[c] : 0.f, c + 1 < d ? row[c + 1] : 0.f,
                       c + 2 < d ? row[c + 2] : 0.f, c + 3 < d ? row[c + 3] : 0.f);
  } else {
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(row);
    uint32_t b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = c + q < d ? bits[c + q] : 0u;
    return make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
  }
}

__device__ __forceinline__ float4 unpack4(float4 r) { return r; }
__device__ __forceinline__ float4 unpack4(uint2 r) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// True for NaN and ±Inf: the f32 exponent field is all ones.  A bit test
// rather than isfinite(), so no compiler flag can fold it away; exact for
// bf16 inputs too, since their upcast to f32 is a 16-bit shift.
__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// Asynchronous copies into shared memory (cp.async, 16 bytes a thread,
// no registers): src_bytes < 16 fills the rest of the 16 with zeros, so
// a tail past the end of a row is copied as 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const unsigned char* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// D = A·B + D on the tensor cores: A 16×16 bf16 (row), B 16×8 bf16 (col),
// D 16×8 f32.  A bf16×bf16 product is exact in f32.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory barriers (mbarrier) that producer and consumer warps meet
// at without a block-wide barrier: a phase completes after `count`
// arrivals; arrive releases this thread's shared-memory writes, and a
// wait on a phase's parity acquires them.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(s), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(s) : "memory");
}

// Waits until the phase of parity `parity` is complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(s),
      "r"(parity)
      : "memory");
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace rt
