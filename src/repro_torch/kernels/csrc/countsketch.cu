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
// every sum is in f32; σ·x is exact, so σ·x + acc as one fma rounds as the
// plain version's product and sum do, and only the order of the sums
// differs.  k need not divide d; buckets c ≥ d (k > d) are 0.
//
// What bounds it on an H100 (m = 32, d = 2^20, k = 4096): one read of x
// and one write of the sketch, m·d·4 + m·k·4 B ≈ 135 MB, ~40 µs at
// 3.35 TB/s in f32 (~20 µs in bf16).  A first version (one thread an
// output, one hash and 64-bit index arithmetic an element) issued ~25
// instructions an element, more than bf16's bytes allow, and ran bf16 no
// faster than f32.
//
// Design, for instructions below the bytes and the bytes in flight:
// - One hash per coordinate.  A thread owns V adjacent buckets (one 16-byte
//   vector: V = 8 at bf16, 4 at f32) in a tile of R = 4 rows.  For each term
//   it makes the V signs once and applies them to all R rows, so the hash
//   costs ~9/R instructions an element; σ is ±1.0f and σ·x + acc one fma.
// - 16-byte loads and 32-bit offsets.  Each row's base is formed once in
//   64 bits; offsets inside a row are uint32 wherever d + k ≤ 2^32 (I =
//   uint32_t; a 64-bit instantiation takes larger shapes).  The vector path
//   (VEC) needs k % V == 0, d·sizeof(T) % 16 == 0 and x 16-byte aligned, so
//   each term's V buckets are one aligned vector, all in range or all out;
//   otherwise scalar loads fill the same tiling.
// - Loads in flight.  A thread takes its terms in groups of UNROLL, every
//   load of a group issued at once, and loads the next group while it sums
//   the last (two groups in registers, in turn); without that the card
//   idled while the warps summed.
// - The terms split inside the block.  A block is W warps over a tile of
//   LB·V buckets × R rows; a warp's lanes are LB on bucket vectors × 32/LB
//   on terms (LB < 32 only when k is small), and the W warps take
//   consecutive runs of the block's terms.  Each of the W·32/LB parts sums
//   its terms in order; the parts are summed through shared memory in part
//   order.  At the main shape (LB = 32, W = 8) that is 16 × 8 = 128 blocks
//   at bf16 (32 × 8 at f32) whose warps take 32 terms each.
// - When the blocks alone cannot fill the card (k = 8 in the reference's
//   tests) the terms are also cut into S chunks, one per grid slice z: each
//   writes a partial sketch to scratch, and a second kernel sums the S
//   partials in order.
// No float atomics: every sum's order is a function of the launch plan,
// which is a function of (m, d, k, dtype, alignment), so two runs give the
// same bits, and the scalar, vector, 32- and 64-bit paths give the same
// bits under one plan.  The plan is made in Python (kernels/countsketch.py,
// launch_plan) and checked here.  Any d and k ≥ 1 and m rows up to
// 4·65535: the wrapper holds a run to rt::MAX_WORKERS workers, and a
// campaign's R runs fold into R·m independent rows of one launch.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 8;
// rows of x a block sums: each term's signs are made once for all of them
constexpr int R = 4;
// terms of a group, loaded (×R rows) together while the last group is
// summed: two 16-byte vectors a row, or one term of V scalars (registers)
template <bool VEC> constexpr int UNROLL = VEC ? 2 : 1;

__device__ __forceinline__ int64_t lesser(int64_t a, int64_t b) { return a < b ? a : b; }

// ±1.0f: the sign bit is bit 0 of the hash
__device__ __forceinline__ float sign_of(uint32_t i, uint32_t s) {
  uint32_t h = (i + s) * 2654435761u;
  h ^= h >> 15;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return __uint_as_float(0x3f800000u | (h << 31));
}

// Lane values of one 16-byte vector (V entries), upcast to f32 exactly.
__device__ __forceinline__ void unpack(const uint4 r, float* v, float) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4 r, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// U terms (from j, every lt-th) of a thread's V buckets in R rows, as
// loaded: 16-byte vectors (VEC) or V scalars a row and term.
template <typename T, bool VEC, typename I, int U>
struct Group {
  static constexpr int V = 16 / sizeof(T);
  I idx[U];   // the terms' first coordinates c0 + j·k
  bool ok[U]; // the term is the thread's and its first coordinate lies below d
  std::conditional_t<VEC, uint4[U][R], T[U][R][V]> raw;

  // Every load is issued, from offset 0 of a valid row where the term is
  // out of range, and its words zeroed after: loads under a predicate were
  // issued one term at a time, not all U·R at once.
  __device__ __forceinline__ void fetch(const T* const* rowp, int rows, int64_t j, int64_t j1,
                                        int lt, I c0, I d, I k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t ju = j + (int64_t)u * lt;
      idx[u] = c0 + (I)ju * k;  // < d + k when ju < J
      ok[u] = ju < j1 && idx[u] < d;
    }
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          raw[u][r] = __ldg(reinterpret_cast<const uint4*>(rowp[r] + (ok[u] ? idx[u] : 0)));
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (!ok[u] || r >= rows) raw[u][r] = make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const bool in = ok[u] && c0 + v < k && idx[u] + v < d;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            raw[u][r][v] = rowp[r][in ? idx[u] + v : 0];
            if (!in || r >= rows) raw[u][r][v] = T(0.f);
          }
        }
    }
  }

  // acc[r][v] += σ·x over the U terms in order, each term's V signs made
  // once for the R rows
  __device__ __forceinline__ void add_to(float (&acc)[R][V], uint32_t s) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float sg[V];
#pragma unroll
      for (int v = 0; v < V; ++v) sg[v] = sign_of((uint32_t)(idx[u] + v), s);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float val[V];
        if constexpr (VEC) {
          unpack(raw[u][r], val, T());
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) val[v] = rt::to_f32(raw[u][r][v]);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(sg[v], val[v], acc[r][v]);
      }
    }
  }
};

// Grid (ceil(k / (LB·V)), ceil(m / R), S), block W·32 threads.  Block
// (bx, by, z) sums terms [z·jc, min((z+1)·jc, J)) of buckets [bx·LB·V,
// (bx+1)·LB·V) in rows [by·R, by·R + R); warp q takes the block's terms
// from q·jw on, jw of them, its lane (b, t) = (lane % LB, lane / LB) the
// bucket vector b and every (32/LB)-th of those terms from t on, U at a
// time, the next U loading while the last are summed.  The result goes to
// dst[z·m·k + w·k + c] (dst is the sketch when S = 1, the scratch of
// partials otherwise).
template <typename T, bool VEC, typename I>
__global__ void __launch_bounds__(MAX_WARPS * 32)
countsketch_kernel(const T* __restrict__ x, float* __restrict__ dst, int64_t m, I d, I k,
                   int64_t jc, int64_t jw, int lb, uint32_t s) {
  constexpr int V = 16 / sizeof(T);
  constexpr int U = UNROLL<VEC>;
  // the parts' sums, [part][row][bucket of the tile]; parts·buckets ≤ 32·V·W
  __shared__ __align__(16) float sums[MAX_WARPS * 32 * R * V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lt = 32 / lb, nb = lb * V;
  const int bl = lane % lb, tl = lane / lb;
  const I c0 = (I)blockIdx.x * nb + bl * V;
  const int64_t row0 = (int64_t)blockIdx.y * R;
  const int rows = (int)lesser(R, m - row0);
  const int64_t n_terms = (d + k - 1) / k;
  const int64_t jb = (int64_t)blockIdx.z * jc;
  const int64_t j0 = jb + (int64_t)warp * jw;
  const int64_t j1 = lesser(lesser(j0 + jw, jb + jc), n_terms);
  const T* rowp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rowp[r] = x + (row0 + lesser(r, rows - 1)) * (int64_t)d;

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

  if (c0 < k) {
    // two groups in turn: one is summed while the other loads
    const int64_t step = (int64_t)U * lt;
    Group<T, VEC, I, U> a, b;
    int64_t j = j0 + tl;
    if (j < j1) a.fetch(rowp, rows, j, j1, lt, c0, d, k);
    while (j < j1) {
      if (j + step < j1) b.fetch(rowp, rows, j + step, j1, lt, c0, d, k);
      a.add_to(acc, s);
      j += step;
      if (j >= j1) break;
      if (j + step < j1) a.fetch(rowp, rows, j + step, j1, lt, c0, d, k);
      b.add_to(acc, s);
      j += step;
    }
  }

  // part p = warp·lt + tl of every output of the tile, then each output's
  // parts summed in part order
  const int part = warp * lt + tl;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; v += 4)
      *reinterpret_cast<float4*>(&sums[(part * R + r) * nb + bl * V + v]) =
          make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2], acc[r][v + 3]);
  __syncthreads();
  const int parts = (blockDim.x >> 5) * lt;
  for (int o = threadIdx.x; o < R * nb; o += blockDim.x) {
    const int r = o / nb, b = o % nb;
    const int64_t c = (int64_t)blockIdx.x * nb + b;
    if (r >= rows || c >= (int64_t)k) continue;
    float total = 0.f;
    for (int p = 0; p < parts; ++p) total += sums[(p * R + r) * nb + b];
    dst[((int64_t)blockIdx.z * m + row0 + r) * (int64_t)k + c] = total;
  }
}

// out[n] = Σ_{y < S} part[y·N + n], y in order.
__global__ void __launch_bounds__(256)
countsketch_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                          int64_t N, int64_t S) {
  const int64_t n = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int64_t y = 0; y < S; ++y) acc += part[y * N + n];
  out[n] = acc;
}

struct Launch {
  const void* x;
  float* dst;
  int64_t m, d, k, jc, jw, lb;
  uint32_t s;
  dim3 grid;
  unsigned threads;
  cudaStream_t st;
};

template <typename T, bool VEC, typename I>
void launch(const Launch& a) {
  countsketch_kernel<T, VEC, I><<<a.grid, a.threads, 0, a.st>>>(
      static_cast<const T*>(a.x), a.dst, a.m, (I)a.d, (I)a.k, a.jc, a.jw, (int)a.lb, a.s);
}

template <typename T>
void launch_typed(const Launch& a, bool vec, bool wide) {
  if (vec)
    wide ? launch<T, true, int64_t>(a) : launch<T, true, uint32_t>(a);
  else
    wide ? launch<T, false, int64_t>(a) : launch<T, false, uint32_t>(a);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x only; the sketch is f32).  s is the salted
// hash offset (salt·0x9E3779B9 + 1) mod 2^32.  The rest is the launch plan
// (kernels/countsketch.py, launch_plan): vec (16-byte loads), wide (64-bit
// offsets inside a row; required when d + k > 2^32), rows R (4),
// warps W (1..8), lanes LB on bucket vectors (a power of two ≤ 32),
// chunks S, terms a chunk jc and a warp jw, with S·jc ≥ J = ceil(d / k)
// and W·jw ≥ jc.  For S > 1, part is scratch of S·m·k floats (unused when
// S = 1).  Returns 0 or the CUDA error of the first launch that failed.
extern "C" int rt_countsketch(int64_t dtype, const void* x, void* part, void* out, int64_t m,
                              int64_t d, int64_t k, int64_t s, int64_t vec, int64_t wide,
                              int64_t rows, int64_t warps, int64_t lanes, int64_t chunks,
                              int64_t jc, int64_t jw, int64_t device, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int64_t V = dtype == 0 ? 4 : 8;
  const int64_t n_terms = d >= 1 && k >= 1 ? (d + k - 1) / k : 0;
  if (m < 1 || d < 1 || k < 1 || s < 0 || s > 0xFFFFFFFFll ||
      rows != R || warps < 1 || warps > MAX_WARPS || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || chunks < 1 || chunks > 65535 || jc < 1 || jw < 1 ||
      chunks * jc < n_terms || warps * jw < jc || (!wide && d + k > (1ll << 32)))
    return (int)cudaErrorInvalidValue;
  if (vec && (k % V || d % V || !rt::aligned(x, 16))) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (k + lanes * V - 1) / (lanes * V);
  if (tiles > 0x7fffffff || (m + R - 1) / R > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch a{x, static_cast<float*>(chunks == 1 ? out : part), m, d, k, jc, jw, lanes,
                 (uint32_t)s, dim3((unsigned)tiles, (unsigned)((m + R - 1) / R),
                                   (unsigned)chunks),
                 (unsigned)(warps * 32), st};
  if (dtype == 0)
    launch_typed<float>(a, vec, wide);
  else
    launch_typed<__nv_bfloat16>(a, vec, wide);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const int64_t N = m * k;
  const int64_t blocks = (N + 255) / 256;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  countsketch_reduce_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), N, chunks);
  return (int)cudaGetLastError();
}
