// The strided-fold CountSketch on Hopper.
//
// Replaces: repro/kernels/countsketch.py, countsketch_pallas (body
// _countsketch_kernel, hash _sign_hash).  x is (m, d) f32 or bf16, the
// sketch is (m, k) f32:
//   out[w, c] = Σ_{i ≡ c (mod k), i < d} σ(i)·x[w, i],
// σ(i) = 1 − 2·(h & 1) with the uint32 hash of the global coordinate
//   h = (i + s)·2654435761, h ^= h >> 15, h *= 0x85EBCA6B, h ^= h >> 13,
// s = (salt·0x9E3779B9 + 1) mod 2^32 computed by the caller.  As in the
// Pallas kernel the signs are made in registers from the coordinate, so no
// hash state is read from memory.  bf16 is upcast exactly in registers and
// every sum is in f32; σ·x is exact, so only the order of the sums differs
// from the plain version.  k need not divide d; buckets c ≥ d (k > d) are 0.
//
// What bounds it on an H100 (m = 32, d = 2^20, k = 4096): one read of x
// and one write of the sketch, m·d·4 + m·k·4 B ≈ 135 MB, ~40 µs at
// 3.35 TB/s in f32 (~20 µs in bf16); the 2·m·d additions and sign
// applications take ~1 µs on the f32 CUDA cores.  So it is bound by bytes.
//
// Design.  The Pallas grid walks d in strips and carries the (m, k) sum
// from strip to strip; here one thread owns one output (w, c) and walks
// its J = ceil(d / k) terms c, c + k, c + 2k, ... in order.  Neighbouring
// threads take neighbouring c, so for each term a warp reads 32 adjacent
// elements of one row (coalesced), and eight terms are loaded before they
// are summed, so several loads per thread are in flight.  At the main
// shape m·k = 131,072 outputs of 256 terms fill the card.  When m·k is
// small (k = 8 in the reference's tests) the terms of each output are cut
// into S chunks, one per grid row y: each chunk writes a partial sketch to
// scratch and a second kernel sums the S partials in a fixed order, so
// there are no float atomics and two runs give the same bits.  Any m up to
// rt::MAX_WORKERS, any d and k ≥ 1; offsets are int64 (m·d may pass 2^31).

#include "common.cuh"

namespace {

constexpr int NT = 256;   // threads per block
constexpr int UNROLL = 8; // terms loaded before they are summed

__device__ __forceinline__ float sign_of(int64_t i, uint32_t s) {
  uint32_t h = ((uint32_t)i + s) * 2654435761u;
  h ^= h >> 15;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return (h & 1u) ? -1.f : 1.f;
}

// Grid (ceil(m·k / NT), S).  Chunk y sums terms j in [y·jc, min((y+1)·jc, J))
// of output n = w·k + c into out[y·m·k + n] (out is the sketch when S = 1,
// the scratch of partials otherwise).
template <typename T>
__global__ void __launch_bounds__(NT)
countsketch_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t m, int64_t d,
                   int64_t k, int64_t jc, uint32_t s) {
  const int64_t n = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (n >= m * k) return;
  const int64_t w = n / k, c = n % k;
  const int64_t n_terms = (d + k - 1) / k;
  const int64_t j0 = (int64_t)blockIdx.y * jc;
  const int64_t j1 = j0 + jc < n_terms ? j0 + jc : n_terms;
  const T* row = x + w * d;
  float acc = 0.f;
  for (int64_t j = j0; j < j1; j += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      const int64_t i = c + (j + q) * k;
      v[q] = (j + q < j1 && i < d) ? rt::to_f32(row[i]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) acc += sign_of(c + (j + q) * k, s) * v[q];
  }
  out[(int64_t)blockIdx.y * m * k + n] = acc;
}

// out[n] = Σ_{y < S} part[y·N + n], y in order.
__global__ void __launch_bounds__(NT)
countsketch_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                          int64_t N, int64_t S) {
  const int64_t n = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int64_t y = 0; y < S; ++y) acc += part[y * N + n];
  out[n] = acc;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x only; the sketch is f32).  s is the salted
// hash offset (salt·0x9E3779B9 + 1) mod 2^32.  n_chunks = S ≥ 1 cuts each
// output's J = ceil(d / k) terms into chunks of ceil(J / S); for S > 1,
// part is scratch of S·m·k floats (unused when S = 1).  Returns 0 or the
// CUDA error of the first launch that failed.
extern "C" int rt_countsketch(int64_t dtype, const void* x, void* part, void* out, int64_t m,
                              int64_t d, int64_t k, int64_t n_chunks, int64_t s,
                              int64_t device, void* stream) {
  const int64_t n_terms = d >= 1 && k >= 1 ? (d + k - 1) / k : 0;
  if (m < 1 || m > rt::MAX_WORKERS || d < 1 || k < 1 || n_chunks < 1 || n_chunks > n_terms ||
      n_chunks > 65535 ||
      s < 0 || s > 0xFFFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const int64_t N = m * k;
  const int64_t blocks = (N + NT - 1) / NT;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t jc = (n_terms + n_chunks - 1) / n_chunks;
  float* dst = static_cast<float*>(n_chunks == 1 ? out : part);
  const dim3 grid((unsigned)blocks, (unsigned)n_chunks);
  if (dtype == 0)
    countsketch_kernel<float><<<grid, NT, 0, st>>>(static_cast<const float*>(x), dst, m, d,
                                                   k, jc, (uint32_t)s);
  else if (dtype == 1)
    countsketch_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), dst, m, d, k, jc, (uint32_t)s);
  else
    return (int)cudaErrorInvalidValue;
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  countsketch_reduce_kernel<<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), N, n_chunks);
  return (int)cudaGetLastError();
}
