// Coordinate-wise order statistics over the worker axis on Hopper: the
// median and the n_trim-trimmed mean of each column of an (m, d) matrix.
//
// Replaces: repro/kernels/robust_reduce.py, coordinate_median_pallas (body
// _median_kernel) and trimmed_mean_pallas (body _trimmed_mean_kernel),
// both through _sorted_over_workers.  x is (m, d) f32 or bf16, the output
// is (d,) f32.
//
// What bounds it on an H100 (m = 32, d = 2^20): the bytes, one read of x
// plus the write of the output — m·d·4 + d·4 B = 138 MB, 41.3 µs at
// 3.35 TB/s (f32), and 71 MB, 21.3 µs (bf16) — if the sorting network
// stays below them.  A float min or max is one instruction on the ALU pipe,
// which issues 64 a clock per SM (CUDA C++ Programming Guide, arithmetic
// instruction throughput, compute capability 9.0): 132 × 64 × 1980 MHz =
// 16.7 T a second.  The Pallas kernel's odd-even transposition network
// needs M(M−1)/2 = 496 compare-exchanges a column, 992 min/max, 1.04 G at
// d = 2^20: 62 µs, above both byte times, and both dtypes took the same
// ~0.08 ms.  So the network, not the bytes, bound the first design.
//
// Design, m <= MAX_M = 32 (the register path): each column's values sit in
// registers and are sorted by Batcher's odd-even merge sort
// (sort_network.cuh), 191 comparators at M = 32, 382 min/max a column,
// 0.40 G in all: 24 µs at f32, below the bytes.  The network is unrolled at
// compile time for each M from 1 to 32 (v's indices are constants, so it
// never leaves registers).  The kernel then writes the mean of the sorted
// values lo .. hi−1 — the middle one or two for the median, n_trim ..
// m−n_trim−1 for the trimmed mean — summed in order in f32.
// * f32: one thread owns one column; neighbouring threads read neighbouring
//   columns of a row, so a warp reads 128 contiguous bytes a row, and all m
//   loads are in flight at once.
// * bf16: one thread owns columns c and c + 1 as one 32-bit word a row
//   (a warp again reads 128 contiguous bytes a row) and sorts both with
//   min.NaN.bf16x2 / max.NaN.bf16x2, two columns an instruction: 12 µs of
//   network at d = 2^20, below the 21.3 µs of bytes.  bf16 order is the
//   order of the exact f32 upcasts, and only the kept positions are
//   upcast, so the kept values are the same f32 bits as one column a
//   thread gives.  A word load needs every row start 4-byte aligned: d
//   even and x aligned; otherwise each row's two halves are loaded apart
//   and packed, and an odd last column is masked (its half read as 0 and
//   its result not written).
// Any correct sorting network yields the same sorted sequence, so the
// median is bit-equal to the plain version (torch.sort); the trimmed mean
// differs from it only in the order of its sum.  min/max propagate NaN as
// jnp.minimum/jnp.maximum do (fminf and fmaxf would drop it); every input of
// a sorting network reaches every output, so a column holding a NaN gives
// NaN.  Any d is taken with no padding; offsets are int64 (m·d may pass
// 2^31).
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
// version.

#include "common.cuh"
#include "sort_network.cuh"

namespace {

constexpr int MAX_M = 32;  // one column's values stay in registers (the register path)
constexpr int NT = 128;

using sortnet::max_nan;
using sortnet::min_nan;

// The mean of the sorted values lo .. hi−1, value(i) being the i-th in f32,
// summed in order in f32.  The sum starts from −0, the exact identity of
// IEEE addition, so a lone kept value comes out as it is (a −0 median stays
// −0).  The median's window is a function of M, so its indices are
// constants; the trimmed mean's is chosen by predicates.
template <int M, bool MEDIAN, typename Value>
__device__ __forceinline__ float window_mean(Value value, int lo, int hi) {
  if constexpr (MEDIAN) {
    lo = (M - 1) / 2;
    hi = M / 2 + 1;
  }
  float s = -0.f;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i >= lo && i < hi) s += value(i);
  return s / (float)(hi - lo);
}

// f32: one column a thread.
template <int M, bool MEDIAN>
__global__ void __launch_bounds__(NT)
sorted_mean_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t d, int lo,
                   int hi) {
  const int64_t c = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (c >= d) return;
  float v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = x[(int64_t)i * d + c];
  sortnet::sort<M>(v);
  out[c] = window_mean<M, MEDIAN>([&](int i) { return v[i]; }, lo, hi);
}

// Two bf16 columns a thread (c, c + 1), sorted packed.  word: every row
// start is 4-byte aligned (d even, x aligned), so a row's pair is one load.
template <int M, bool MEDIAN>
__global__ void __launch_bounds__(NT)
sorted_mean_bf16x2_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                          int64_t d, int lo, int hi, bool word) {
  const int64_t c = 2 * ((int64_t)blockIdx.x * NT + threadIdx.x);
  if (c >= d) return;
  const bool pair = c + 1 < d;
  uint32_t v[M];
  if (word) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      v[i] = __ldg(reinterpret_cast<const unsigned int*>(x + (int64_t)i * d + c));
  } else {
    const unsigned short* bits = reinterpret_cast<const unsigned short*>(x);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int64_t e = (int64_t)i * d + c;
      v[i] = (uint32_t)__ldg(bits + e) | (pair ? (uint32_t)__ldg(bits + e + 1) << 16 : 0u);
    }
  }
  sortnet::sort<M>(v);
  // bf16 → f32 is a 16-bit shift: exact and order-keeping
  const float lo_col = window_mean<M, MEDIAN>(
      [&](int i) { return __uint_as_float(v[i] << 16); }, lo, hi);
  const float hi_col = window_mean<M, MEDIAN>(
      [&](int i) { return __uint_as_float(v[i] & 0xffff0000u); }, lo, hi);
  if (pair) {
    *reinterpret_cast<float2*>(out + c) = make_float2(lo_col, hi_col);
  } else {
    out[c] = lo_col;
  }
}

// dtype: 0 = f32, 1 = bf16 (in packed pairs).
template <int M, bool MEDIAN>
cudaError_t launch_width(int64_t dtype, const void* x, float* out, int64_t d, int lo, int hi,
                         cudaStream_t stream) {
  if (dtype == 0) {
    sorted_mean_kernel<M, MEDIAN><<<(unsigned)((d + NT - 1) / NT), NT, 0, stream>>>(
        static_cast<const float*>(x), out, d, lo, hi);
  } else {
    const bool word = d % 2 == 0 && rt::aligned(x, 4);
    sorted_mean_bf16x2_kernel<M, MEDIAN><<<(unsigned)(((d + 1) / 2 + NT - 1) / NT), NT, 0,
                                           stream>>>(
        static_cast<const __nv_bfloat16*>(x), out, d, lo, hi, word);
  }
  return cudaGetLastError();
}

template <int M>
cudaError_t launch(int m, int64_t dtype, const void* x, float* out, int64_t d, int lo, int hi,
                   bool median, cudaStream_t stream) {
  if constexpr (M > MAX_M) {
    return cudaErrorInvalidValue;
  } else {
    if (m != M) return launch<M + 1>(m, dtype, x, out, d, lo, hi, median, stream);
    return median ? launch_width<M, true>(dtype, x, out, d, lo, hi, stream)
                  : launch_width<M, false>(dtype, x, out, d, lo, hi, stream);
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
        int64_t hi, bool median, int64_t device, void* stream) {
  if (m < 1 || m > rt::MAX_WORKERS || d < 1 || (d + NT - 1) / NT > 0x7fffffff || lo < 0 ||
      hi > m || lo >= hi || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (m <= MAX_M) return (int)launch<1>((int)m, dtype, x, o, d, (int)lo, (int)hi, median, s);
  if (dtype == 0)
    return (int)launch_wide<float>(static_cast<const float*>(x), o, m, d, (int)lo, (int)hi, s);
  return (int)launch_wide<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), o, m, d,
                                         (int)lo, (int)hi, s);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x only; the output is f32).  1 <= m <=
// rt::MAX_WORKERS: the register network up to 32, the wide path beyond.
// Each returns 0 or the CUDA error of the launch.

// The median of each column: the middle value for odd m, the mean of the
// two middle values for even m (as jnp.median).
extern "C" int rt_coordinate_median(int64_t dtype, const void* x, void* out, int64_t m,
                                    int64_t d, int64_t device, void* stream) {
  return run(dtype, x, out, m, d, (m - 1) / 2, m / 2 + 1, true, device, stream);
}

// The mean of each column's sorted values n_trim .. m − n_trim − 1
// (needs 2·n_trim < m).
extern "C" int rt_trimmed_mean(int64_t dtype, const void* x, void* out, int64_t m,
                               int64_t d, int64_t n_trim, int64_t device, void* stream) {
  if (n_trim < 0 || 2 * n_trim >= m) return (int)cudaErrorInvalidValue;
  return run(dtype, x, out, m, d, n_trim, m - n_trim, false, device, stream);
}

// The register path's network on m wires (1 <= m <= 32), evaluated on the
// host by the same constexpr function the kernels unroll: writes its
// comparators to pairs[2t], pairs[2t + 1] when pairs is not null and
// returns their number, or −1 for m out of range.
extern "C" int rt_sort_network(int64_t m, int32_t* pairs) {
  if (m < 1 || m > MAX_M) return -1;
  const int n = sortnet::batcher_size((int)m);
  for (int t = 0; pairs && t < n; ++t) {
    const sortnet::Comparator c = sortnet::batcher((int)m, t);
    pairs[2 * t] = c.lo;
    pairs[2 * t + 1] = c.hi;
  }
  return n;
}
