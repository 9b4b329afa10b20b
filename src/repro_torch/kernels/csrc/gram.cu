// The worker Gram matrix G = X Xᵀ on Hopper.
//
// Replaces: repro/kernels/pairdist.py, gram_pallas (body _gram_kernel).
// X is (m, d) f32 or bf16, G is (m, m) f32.  Every product is upcast to f32
// (exact for bf16) and accumulated in f32 with CUDA-core FMAs: TF32 tensor
// cores would miss the 2e-5 tolerance of the reference's Gram tests.
//
// What bounds it on an H100 (m = 32, d = 2^20, f32): one read of X,
// m·d·4 B = 134 MB, ~40 µs at 3.35 TB/s, against 2·m²·d = 2.15 GFLOP,
// ~32 µs at the 67 TFLOP/s f32 CUDA-core rate.  So it is bound by bytes;
// bf16 halves the bytes (~20 µs) and the FMAs become the floor.
//
// Design: the gram_g half of fused_guard.cu.  The Pallas grid walks d in
// order and carries the (m, m) sum from strip to strip; CUDA blocks run in
// parallel, so d is split across blocks instead: block x takes the
// 64-column tiles x, x + gridDim.x, ... and keeps its share of the Gram in
// registers (a 4x4 tile per thread; four groups of 64 threads each take 16
// of a tile's 64 columns).  The next tile's loads are issued before the
// current tile's FMAs and held as raw words (bf16 is upcast only when it is
// stored to shared memory), so they stay in flight during the FMAs.  Each
// block writes its partial Gram to a scratch buffer and a second kernel
// sums the partials in a fixed order: no float atomics, so two runs give
// the same bits (Krum's and the medoid's argmin pick the same row every
// time).  Workers come in tiles of 32 (grid y, z),
// so any m from 1 to 128 and any d are taken with masked tails and no
// padded copy; offsets are int64 (m·d may pass 2^31).

#include "common.cuh"

namespace {

constexpr int MT = 32;        // workers per output tile
constexpr int TK = 64;        // columns of d per shared-memory tile
constexpr int LDS = TK + 4;   // padded row: 16-B aligned, conflict-free float4 reads
constexpr int NT = 256;       // threads per block
constexpr int KG = 4;         // column groups of 64 threads each
constexpr int KW = TK / KG;   // columns of a tile per group
constexpr int SMEM_TILE = 2 * MT * LDS;
constexpr int SMEM_RED = KG * MT * MT;
constexpr int SMEM = SMEM_TILE > SMEM_RED ? SMEM_TILE : SMEM_RED;

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 2)
gram_kernel(const T* __restrict__ x, float* __restrict__ part, int64_t m, int64_t d,
            int64_t mp) {
  __shared__ __align__(16) float smem[SMEM];
  const int ti = blockIdx.y, tj = blockIdx.z;
  const bool diag = ti == tj;  // one tile of rows serves both operands
  float* sI = smem;
  float* sJ = diag ? sI : smem + MT * LDS;

  const int tid = threadIdx.x;
  // load mapping: tile rows lr and lr + 16, columns lc .. lc + 3
  const int lr = tid >> 4;
  const int lc = (tid & 15) * 4;
  // compute mapping: column group kg; output rows tr + 8·ii, columns tc + 8·jj
  const int kg = tid >> 6;
  const int tr = (tid & 63) >> 3;
  const int tc = tid & 7;

  int64_t rowI[2], rowJ[2];
  bool vI[2], vJ[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    rowI[p] = (int64_t)ti * MT + lr + 16 * p;
    rowJ[p] = (int64_t)tj * MT + lr + 16 * p;
    vI[p] = rowI[p] < m;
    vJ[p] = rowJ[p] < m;
  }

  // the next tile's raw words, upcast only when they are stored to shared
  // memory: an upcast right after the load would stall until the data came
  using R = typename rt::Raw4<T>::type;
  R pi[2], pj[2];
  auto fetch = [&](int64_t tile) {
    const int64_t c = tile * TK + lc;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      pi[p] = vI[p] ? rt::load4_raw<T, VEC>(x + rowI[p] * d, c, d) : R{};
      if (!diag) pj[p] = vJ[p] ? rt::load4_raw<T, VEC>(x + rowJ[p] * d, c, d) : R{};
    }
  };

  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;

  const int64_t n_tiles = (d + TK - 1) / TK;
  int64_t tile = blockIdx.x;
  if (tile < n_tiles) fetch(tile);
  for (; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's FMAs are done with shared memory
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int o = (lr + 16 * p) * LDS + lc;
      *reinterpret_cast<float4*>(&sI[o]) = rt::unpack4(pi[p]);
      if (!diag) *reinterpret_cast<float4*>(&sJ[o]) = rt::unpack4(pj[p]);
    }
    __syncthreads();
    if (tile + gridDim.x < n_tiles) fetch(tile + gridDim.x);  // in flight during the FMAs

#pragma unroll
    for (int s4 = 0; s4 < KW; s4 += 4) {
      const int k = kg * KW + s4;
      float4 cj[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        cj[jj] = *reinterpret_cast<const float4*>(&sJ[(tc + 8 * jj) * LDS + k]);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 a = *reinterpret_cast<const float4*>(&sI[(tr + 8 * ii) * LDS + k]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float& s = acc[ii][jj];
          s = fmaf(a.x, cj[jj].x, s);
          s = fmaf(a.y, cj[jj].y, s);
          s = fmaf(a.z, cj[jj].z, s);
          s = fmaf(a.w, cj[jj].w, s);
        }
      }
    }
  }

  // sum the four column groups in a fixed order, then write this block's
  // partial (MT, MT) tile
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      red[kg * MT * MT + (tr + 8 * ii) * MT + tc + 8 * jj] = acc[ii][jj];
  __syncthreads();
  for (int ij = tid; ij < MT * MT; ij += NT) {
    float s = red[ij];
#pragma unroll
    for (int q = 1; q < KG; ++q) s += red[q * MT * MT + ij];
    const int64_t gi = (int64_t)ti * MT + ij / MT;
    const int64_t gj = (int64_t)tj * MT + ij % MT;
    part[((int64_t)blockIdx.x * mp + gi) * mp + gj] = s;
  }
}

// Sums the nb partials of every output in a fixed order: eight lanes per
// output take every eighth partial, then a fixed tree over the eight.
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ gram, int64_t m,
                   int64_t mp, int64_t nb) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t o = t >> 3;
  const int l = (int)(t & 7);
  const int64_t off = (o / m) * mp + o % m;
  float s = 0.f;
  if (o < m * m)
    for (int64_t b = l; b < nb; b += 8) s += part[b * mp * mp + off];
  s += __shfl_down_sync(0xffffffffu, s, 4, 8);
  s += __shfl_down_sync(0xffffffffu, s, 2, 8);
  s += __shfl_down_sync(0xffffffffu, s, 1, 8);
  if (o < m * m && l == 0) gram[o] = s;
}

template <typename T>
cudaError_t launch(const void* x, float* part, int64_t m, int64_t d, int64_t nb,
                   cudaStream_t stream) {
  const int64_t nt = (m + MT - 1) / MT, mp = nt * MT;
  const dim3 grid((unsigned)nb, (unsigned)nt, (unsigned)nt);
  const bool vec = d % 4 == 0 && rt::aligned(x, 4 * sizeof(T));
  const T* xt = static_cast<const T*>(x);
  if (vec)
    gram_kernel<T, true><<<grid, NT, 0, stream>>>(xt, part, m, d, mp);
  else
    gram_kernel<T, false><<<grid, NT, 0, stream>>>(xt, part, m, d, mp);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x only; the Gram is f32).  The scratch buffer
// holds nb·mp·mp floats, mp = 32·ceil(m/32).  Returns 0 or the CUDA error
// of the first launch that failed.
extern "C" int rt_gram(int64_t dtype, const void* x, void* part, void* gram, int64_t m,
                       int64_t d, int64_t nb, int64_t device, void* stream) {
  if (m < 1 || m > 4 * MT || d < 1 || nb < 1 || nb > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    err = launch<float>(x, p, m, d, nb, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, p, m, d, nb, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const int64_t mp = ((m + MT - 1) / MT) * MT;
  const int64_t threads = 8 * m * m;
  gram_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      p, static_cast<float*>(gram), m, mp, nb);
  return cudaGetLastError();
}
