// Coordinate-wise order statistics over the worker axis on Hopper: the
// median and the n_trim-trimmed mean of each column of an (m, d) matrix.
//
// Replaces: repro/kernels/robust_reduce.py, coordinate_median_pallas (body
// _median_kernel) and trimmed_mean_pallas (body _trimmed_mean_kernel),
// both through _sorted_over_workers.  x is (m, d) f32 or bf16, the output
// is (d,) f32.
//
// What bounds it on an H100 (m = 32, d = 2^20, f32): one read of x plus the
// write of the output, m·d·4 + d·4 B = 138 MB, ~41 µs at 3.35 TB/s, against
// m(m−1)·d = 1.04 G min/max operations, ~16 µs at the 67 TFLOP/s f32
// CUDA-core rate.  So it is bound by bytes.
//
// Design: one thread owns one column.  It loads the column's m values,
// upcast to f32, into registers (neighbouring threads read neighbouring
// columns of a row, so a warp's loads are coalesced, and all m loads are in
// flight at once), sorts them with the odd-even transposition network of
// the Pallas kernel (m rounds of compare-exchange, fully unrolled, so the
// values never leave registers), and writes the mean of the sorted values
// lo .. hi−1: the middle one or two for the median, n_trim .. m−n_trim−1
// for the trimmed mean, summed in order in f32.  The network needs m as a
// compile-time constant, so the kernel is instantiated for every m from 1
// to MAX_M.  min/max propagate NaN as jnp.minimum/jnp.maximum do (fminf
// and fmaxf would drop it); one NaN spreads through the m rounds to the
// whole column, so a column holding a NaN gives NaN.  Any d is taken with
// no padding; offsets are int64 (m·d may pass 2^31).
//
// Past MAX_M = 32 workers a column no longer fits one thread's registers,
// and the wide path (sorted_mean_wide_kernel) takes m up to
// rt::MAX_WORKERS: a block stages a tile of columns in dynamic shared
// memory, each padded with +Inf to P = the next power of two ≥ m (the
// pads sort after every value, NaN aside), sorts every column with a
// bitonic network of the same min.NaN/max.NaN comparators (a comparator
// that meets a NaN outputs NaN on both wires, and every output of a
// sorting network is reachable from every input, so a NaN still turns its
// whole column to NaN), and one warp per column sums the sorted values
// lo .. hi−1: lane l takes lo + l, lo + l + 32, ... in order, then a fixed
// shuffle tree.  For the median (one or two values) that is exactly the
// register path's v[lo] (+ v[lo + 1]), so it stays bit-equal to the plain
// version.  The register path for m ≤ 32 is unchanged.

#include "common.cuh"

namespace {

constexpr int MAX_M = 32;  // one column's values stay in registers (the register path)
constexpr int NT = 128;

// One instruction each (sm_80+): NaN when either input is NaN, as
// jnp.minimum/jnp.maximum.  The NaN tests and selects written out in C took
// ~3 instructions a side and left the network bound by instruction issue.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <typename T, int M>
__global__ void __launch_bounds__(NT)
sorted_mean_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t d, int lo,
                   int hi) {
  const int64_t c = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (c >= d) return;
  float v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = rt::to_f32(x[(int64_t)i * d + c]);
#pragma unroll
  for (int r = 0; r < M; ++r) {
#pragma unroll
    for (int i = r & 1; i + 1 < M; i += 2) {
      const float a = v[i], b = v[i + 1];
      v[i] = min_nan(a, b);
      v[i + 1] = max_nan(a, b);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i >= lo && i < hi) s = i == lo ? v[i] : s + v[i];
  out[c] = s / (float)(hi - lo);
}

template <typename T, int M>
cudaError_t launch(int m, const T* x, float* out, int64_t d, int lo, int hi,
                   cudaStream_t stream) {
  if constexpr (M > MAX_M) {
    return cudaErrorInvalidValue;
  } else {
    if (m != M) return launch<T, M + 1>(m, x, out, d, lo, hi, stream);
    const int64_t blocks = (d + NT - 1) / NT;
    sorted_mean_kernel<T, M><<<(unsigned)blocks, NT, 0, stream>>>(x, out, d, lo, hi);
    return cudaGetLastError();
  }
}

constexpr int WIDE_NT = 256;
constexpr int WIDE_FLOATS = 24576;  // 96 KB of column tiles per block
constexpr int WIDE_MAX_COLS = 64;

// The wide path: block b sorts columns b·tc .. b·tc + tc − 1, each held in
// shared memory as P values (the column's m, then +Inf) at a pitch of
// P + 1 words, so neighbouring columns sit in neighbouring banks.
template <typename T>
__global__ void __launch_bounds__(WIDE_NT)
sorted_mean_wide_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t m,
                        int64_t d, int P, int tc, int lo, int hi) {
  extern __shared__ float sv[];
  const int pitch = P + 1;
  const int64_t c0 = (int64_t)blockIdx.x * tc;
  const int ncol = d - c0 < tc ? (int)(d - c0) : tc;
  // element (row i, column cc) at e = i·tc + cc: a warp reads neighbouring
  // columns of a row
  for (int e = threadIdx.x; e < P * tc; e += WIDE_NT) {
    const int i = e / tc, cc = e % tc;
    sv[cc * pitch + i] = (i < m && cc < ncol) ? rt::to_f32(x[(int64_t)i * d + c0 + cc])
                                              : __int_as_float(0x7f800000);  // +Inf
  }
  __syncthreads();
  const int half = P / 2;
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int e = threadIdx.x; e < half * tc; e += WIDE_NT) {
        const int cc = e / half, r = e % half;
        const int i = 2 * r - (r & (j - 1));  // (r / j)·2j + r % j: the lower wire
        float* col = sv + cc * pitch;
        const float a = col[i], b = col[i + j];
        const float lo_v = min_nan(a, b), hi_v = max_nan(a, b);
        const bool up = (i & k) == 0;
        col[i] = up ? lo_v : hi_v;
        col[i + j] = up ? hi_v : lo_v;
      }
      __syncthreads();
    }
  const int lane = threadIdx.x & 31;
  for (int cc = threadIdx.x >> 5; cc < ncol; cc += WIDE_NT / 32) {
    const float* col = sv + cc * pitch;
    float s = 0.f;
    bool has = false;
    for (int i = lo + lane; i < hi; i += 32) {
      s = has ? s + col[i] : col[i];
      has = true;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_down_sync(0xffffffffu, s, off);
      const bool oh = __shfl_down_sync(0xffffffffu, (int)has, off) != 0;
      if (lane + off < 32 && oh) {
        s = has ? s + o : o;
        has = true;
      }
    }
    if (lane == 0) out[c0 + cc] = s / (float)(hi - lo);
  }
}

template <typename T>
cudaError_t launch_wide(const T* x, float* out, int64_t m, int64_t d, int lo, int hi,
                        cudaStream_t stream) {
  int P = 1;
  while (P < m) P <<= 1;
  int tc = WIDE_FLOATS / (P + 1);
  tc = tc < WIDE_MAX_COLS ? tc : WIDE_MAX_COLS;
  const int64_t blocks = (d + tc - 1) / tc;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t bytes = (size_t)tc * (P + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sorted_mean_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WIDE_FLOATS * (int)sizeof(float));
  if (err != cudaSuccess) return err;
  sorted_mean_wide_kernel<T><<<(unsigned)blocks, WIDE_NT, bytes, stream>>>(x, out, m, d, P,
                                                                           tc, lo, hi);
  return cudaGetLastError();
}

int run(int64_t dtype, const void* x, void* out, int64_t m, int64_t d, int64_t lo,
        int64_t hi, int64_t device, void* stream) {
  if (m < 1 || m > rt::MAX_WORKERS || d < 1 || (d + NT - 1) / NT > 0x7fffffff || lo < 0 ||
      hi > m || lo >= hi)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    return m <= MAX_M ? (int)launch<float, 1>((int)m, xf, o, d, (int)lo, (int)hi, s)
                      : (int)launch_wide<float>(xf, o, m, d, (int)lo, (int)hi, s);
  }
  if (dtype == 1) {
    const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
    return m <= MAX_M ? (int)launch<__nv_bfloat16, 1>((int)m, xh, o, d, (int)lo, (int)hi, s)
                      : (int)launch_wide<__nv_bfloat16>(xh, o, m, d, (int)lo, (int)hi, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x only; the output is f32).  1 <= m <=
// rt::MAX_WORKERS: the register network up to 32, the wide path beyond.
// Each returns 0 or the CUDA error of the launch.

// The median of each column: the middle value for odd m, the mean of the
// two middle values for even m (as jnp.median).
extern "C" int rt_coordinate_median(int64_t dtype, const void* x, void* out, int64_t m,
                                    int64_t d, int64_t device, void* stream) {
  return run(dtype, x, out, m, d, (m - 1) / 2, m / 2 + 1, device, stream);
}

// The mean of each column's sorted values n_trim .. m − n_trim − 1
// (needs 2·n_trim < m).
extern "C" int rt_trimmed_mean(int64_t dtype, const void* x, void* out, int64_t m,
                               int64_t d, int64_t n_trim, int64_t device, void* stream) {
  if (n_trim < 0 || 2 * n_trim >= m) return (int)cudaErrorInvalidValue;
  return run(dtype, x, out, m, d, n_trim, m - n_trim, device, stream);
}
