// The filtered mean ξ = Σᵢ (wᵢ / denom)·xᵢ on Hopper.
//
// Replaces: repro/kernels/robust_reduce.py, filtered_mean_pallas (body
// _filtered_mean_kernel, sanitize=False and sanitize=True).  x is (m, d)
// f32 or bf16, w is (m,) f32, ξ is (d,) f32.  The division wᵢ / denom
// happens in the kernel, as in the Pallas body; the guard passes weights
// already divided and denom = 1.  The sanitizing variant (template flag
// SAN, entry rt_filtered_mean_sanitize) zeroes each NaN/Inf entry of x
// after the upcast and before the multiply: a zero weight alone would not
// do, since 0·Inf = NaN.  On finite input it equals the plain variant bit
// for bit.
//
// What bounds it on an H100 (m = 32, d = 2^20, f32): one read of x plus the
// write of ξ, m·d·4 + d·4 B ≈ 138 MB, ~41 µs at 3.35 TB/s; the 2·m·d FLOPs
// take ~1 µs.  So it is bound by bytes.
//
// Design: one pass over x.  Each thread owns four adjacent columns and
// walks the m rows, so a warp's loads are 512 contiguous bytes (256 for
// bf16) of one row, and the four-way unrolled row loop keeps several loads
// in flight per thread.  The weights sit in shared memory.  No
// cross-thread reduction is needed, so the result does not depend on the
// launch shape.  Offsets are int64 (m·d may pass 2^31).

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T, bool VEC, bool SAN>
__global__ void __launch_bounds__(NT)
filtered_mean_kernel(const T* __restrict__ x, const float* __restrict__ w, float denom,
                     float* __restrict__ out, int64_t m, int64_t d) {
  extern __shared__ float sw[];
  for (int64_t i = threadIdx.x; i < m; i += NT) sw[i] = w[i] / denom;
  __syncthreads();
  const int64_t n4 = (d + 3) / 4;
  for (int64_t q = (int64_t)blockIdx.x * NT + threadIdx.x; q < n4;
       q += (int64_t)gridDim.x * NT) {
    const int64_t c = 4 * q;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int64_t i = 0; i < m; ++i) {
      float v[4];
      rt::load4<T, VEC>(x + i * d, c, d, v);
      if constexpr (SAN) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = rt::nonfinite(v[k]) ? 0.f : v[k];
      }
      const float wi = sw[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(wi, v[k], acc[k]);
    }
    rt::store4<float, VEC>(out, c, d, acc);
  }
}

template <typename T, bool SAN>
cudaError_t launch(const void* x, const float* w, float denom, float* out, int64_t m,
                   int64_t d, cudaStream_t stream) {
  const int64_t n4 = (d + 3) / 4;
  const int64_t blocks = (n4 + NT - 1) / NT < (1 << 20) ? (n4 + NT - 1) / NT : (1 << 20);
  const bool vec = d % 4 == 0 && rt::aligned(x, 4 * sizeof(T)) && rt::aligned(out, 16);
  const size_t smem = (size_t)m * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  if (vec)
    filtered_mean_kernel<T, true, SAN><<<(unsigned)blocks, NT, smem, stream>>>(
        xt, w, denom, out, m, d);
  else
    filtered_mean_kernel<T, false, SAN><<<(unsigned)blocks, NT, smem, stream>>>(
        xt, w, denom, out, m, d);
  return cudaGetLastError();
}

template <bool SAN>
int run(int64_t dtype, const void* x, const void* w, float denom, void* out, int64_t m,
        int64_t d, int64_t device, void* stream) {
  if (m < 1 || m > 12288 || d < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (dtype == 0) return (int)launch<float, SAN>(x, wf, denom, of, m, d, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16, SAN>(x, wf, denom, of, m, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x only; w and out are f32).  m ≤ 12288 (the
// weights fit the default 48 KB of shared memory).  Returns 0 or the CUDA
// error of the launch.
extern "C" int rt_filtered_mean(int64_t dtype, const void* x, const void* w, float denom,
                                void* out, int64_t m, int64_t d, int64_t device,
                                void* stream) {
  return run<false>(dtype, x, w, denom, out, m, d, device, stream);
}

// The sanitizing variant, with the same arguments.
extern "C" int rt_filtered_mean_sanitize(int64_t dtype, const void* x, const void* w,
                                         float denom, void* out, int64_t m, int64_t d,
                                         int64_t device, void* stream) {
  return run<true>(dtype, x, w, denom, out, m, d, device, stream);
}
