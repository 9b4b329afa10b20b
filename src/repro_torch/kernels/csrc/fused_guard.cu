// One-pass guard statistics on Hopper.
//
// Replaces: repro/kernels/fused_guard.py, fused_guard_pallas (body
// _fused_guard_kernel), sanitize=False.  One sweep over the (m, d) worker
// gradients g and the martingale matrix B gives
//   gram_g = g gᵀ (m, m) f32,  cross = B gᵀ (m, m) f32 (pre-update B),
//   a_inc  = g·δ  (m,)   f32,  B_new = B + g (m, d), rounded once to B's type.
// g, B and δ are f32 or bf16; every product is upcast to f32 (exact for
// bf16) and accumulated in f32 with CUDA-core FMAs (no TF32 tensor cores,
// which would break the 1e-5 tolerance against the plain version).
//
// What bounds it on an H100 (m = 32, d = 2^20): f32 moves 3·m·d·4 B =
// 402,653,184 B, ~120 µs at 3.35 TB/s, against 4·m²·d ≈ 4.4 GFLOP, ~65 µs at
// the 67 TFLOP/s f32 CUDA-core rate, so f32 is bound by bytes; bf16 halves
// the bytes to ~60 µs and the FMAs become the bound.
//
// Design.  The Pallas grid walks d in order and carries the (m, m)
// accumulators from one strip to the next; CUDA blocks run in parallel and
// carry nothing.  So d is split across blocks instead: block x takes the
// 64-column tiles x, x + gridDim.x, ... and keeps its share of both Grams
// in registers (a 4x4 register tile of gram_g and of cross per thread, four
// groups of 64 threads each taking 16 of a tile's 64 columns).  Each tile
// of g and B is read from device memory once; the same registers write
// B_new and the A-increments, so the sweep reads g, B, δ once and writes
// B_new once.  The next tile's loads are issued before the current tile's
// FMAs, so loads overlap compute.  Each block writes its partial Grams to a
// scratch buffer, and a second small kernel sums the partials in a fixed
// order: no float atomics, so two runs give the same bits.  Workers are
// taken in tiles of 32 (grid y, z); any m from 1 to 128 and any d are
// handled with masked tails and no padded copy, and all offsets are int64
// (m·d may pass 2^31).

#include "common.cuh"

namespace {

constexpr int MT = 32;        // workers per output tile
constexpr int TK = 64;        // columns of d per shared-memory tile
constexpr int LDS = TK + 4;   // padded row: 16-B aligned, conflict-free float4 reads
constexpr int NT = 256;       // threads per block
constexpr int KG = 4;         // column groups of 64 threads each
constexpr int KW = TK / KG;   // columns of a tile per group
constexpr int SMEM_TILE = 3 * MT * LDS;
constexpr int SMEM_RED = KG * 2 * MT * MT;
constexpr int SMEM = SMEM_TILE > SMEM_RED ? SMEM_TILE : SMEM_RED;

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 2)
fused_guard_kernel(const T* __restrict__ g, const T* __restrict__ B,
                   const T* __restrict__ delta, T* __restrict__ B_new,
                   float* __restrict__ gram_part, float* __restrict__ cross_part,
                   float* __restrict__ a_part, int64_t m, int64_t d, int64_t mp) {
  __shared__ __align__(16) float smem[SMEM];
  const int ti = blockIdx.y, tj = blockIdx.z;
  const bool diag = ti == tj;  // this block also writes B_new and a_inc of tile ti
  float* sGI = smem;
  float* sBI = smem + MT * LDS;
  float* sGJ = diag ? sGI : smem + 2 * MT * LDS;

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
    // rows past m are never dereferenced; clamp so the pointers stay in range
    if (!vI[p]) rowI[p] = m - 1;
    if (!vJ[p]) rowJ[p] = m - 1;
  }

  float pg[2][4], pb[2][4], pj[2][4], pd[4];
  auto fetch = [&](int64_t tile) {
    const int64_t c = tile * TK + lc;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (vI[p]) {
        rt::load4<T, VEC>(g + rowI[p] * d, c, d, pg[p]);
        rt::load4<T, VEC>(B + rowI[p] * d, c, d, pb[p]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) pg[p][q] = pb[p][q] = 0.f;
      }
      if (!diag) {
        if (vJ[p]) {
          rt::load4<T, VEC>(g + rowJ[p] * d, c, d, pj[p]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) pj[p][q] = 0.f;
        }
      }
    }
    if (diag) rt::load4<T, VEC>(delta, c, d, pd);
  };

  float acc_g[4][4], acc_c[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc_g[ii][jj] = acc_c[ii][jj] = 0.f;
  float a_acc[2] = {0.f, 0.f};

  const int64_t n_tiles = (d + TK - 1) / TK;
  int64_t tile = blockIdx.x;
  if (tile < n_tiles) fetch(tile);
  for (; tile < n_tiles; tile += gridDim.x) {
    if (diag) {
      const int64_t c = tile * TK + lc;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (!vI[p]) continue;
        float s[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[q] = pb[p][q] + pg[p][q];  // f32 add, rounded once by the store
          a_acc[p] = fmaf(pg[p][q], pd[q], a_acc[p]);
        }
        rt::store4<T, VEC>(B_new + rowI[p] * d, c, d, s);
      }
    }
    __syncthreads();  // the previous tile's FMAs are done with shared memory
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int o = (lr + 16 * p) * LDS + lc;
      *reinterpret_cast<float4*>(&sGI[o]) = make_float4(pg[p][0], pg[p][1], pg[p][2], pg[p][3]);
      *reinterpret_cast<float4*>(&sBI[o]) = make_float4(pb[p][0], pb[p][1], pb[p][2], pb[p][3]);
      if (!diag)
        *reinterpret_cast<float4*>(&sGJ[o]) = make_float4(pj[p][0], pj[p][1], pj[p][2], pj[p][3]);
    }
    __syncthreads();
    if (tile + gridDim.x < n_tiles) fetch(tile + gridDim.x);  // in flight during the FMAs

#pragma unroll
    for (int s4 = 0; s4 < KW; s4 += 4) {
      const int k = kg * KW + s4;
      float4 cj[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        cj[jj] = *reinterpret_cast<const float4*>(&sGJ[(tc + 8 * jj) * LDS + k]);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 a = *reinterpret_cast<const float4*>(&sGI[(tr + 8 * ii) * LDS + k]);
        const float4 b = *reinterpret_cast<const float4*>(&sBI[(tr + 8 * ii) * LDS + k]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float& ag = acc_g[ii][jj];
          float& ac = acc_c[ii][jj];
          ag = fmaf(a.x, cj[jj].x, ag); ac = fmaf(b.x, cj[jj].x, ac);
          ag = fmaf(a.y, cj[jj].y, ag); ac = fmaf(b.y, cj[jj].y, ac);
          ag = fmaf(a.z, cj[jj].z, ag); ac = fmaf(b.z, cj[jj].z, ac);
          ag = fmaf(a.w, cj[jj].w, ag); ac = fmaf(b.w, cj[jj].w, ac);
        }
      }
    }
  }

  // sum the four column groups in a fixed order, then write this block's
  // partial (m, m) tiles
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ij = (tr + 8 * ii) * MT + tc + 8 * jj;
      red[(kg * 2 + 0) * MT * MT + ij] = acc_g[ii][jj];
      red[(kg * 2 + 1) * MT * MT + ij] = acc_c[ii][jj];
    }
  __syncthreads();
  for (int o = tid; o < 2 * MT * MT; o += NT) {
    const int which = o / (MT * MT);
    const int ij = o % (MT * MT);
    float s = red[which * MT * MT + ij];
#pragma unroll
    for (int q = 1; q < KG; ++q) s += red[(q * 2 + which) * MT * MT + ij];
    const int64_t gi = (int64_t)ti * MT + ij / MT;
    const int64_t gj = (int64_t)tj * MT + ij % MT;
    float* dst = which ? cross_part : gram_part;
    dst[((int64_t)blockIdx.x * mp + gi) * mp + gj] = s;
  }
  if (diag) {
    // the 16 lanes that loaded a row hold its A-increment in pieces
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v = a_acc[p];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if ((tid & 15) == 0)
        a_part[(int64_t)blockIdx.x * mp + (int64_t)ti * MT + lr + 16 * p] = v;
    }
  }
}

// Sums the nb partials of every output in a fixed order: eight lanes per
// output take every eighth partial, then a fixed tree over the eight.
__global__ void __launch_bounds__(256)
fused_guard_reduce_kernel(const float* __restrict__ gram_part,
                          const float* __restrict__ cross_part,
                          const float* __restrict__ a_part, float* __restrict__ gram,
                          float* __restrict__ cross, float* __restrict__ a_inc,
                          int64_t m, int64_t mp, int64_t nb) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t o = t >> 3;
  const int l = (int)(t & 7);
  const int64_t mm = m * m, total = 2 * mm + m;
  const float* src = a_part;
  float* dst = a_inc;
  int64_t off = 0, stride = mp, out = 0;
  if (o < 2 * mm) {
    const int64_t ij = o < mm ? o : o - mm;
    src = o < mm ? gram_part : cross_part;
    dst = o < mm ? gram : cross;
    off = (ij / m) * mp + ij % m;
    stride = mp * mp;
    out = ij;
  } else if (o < total) {
    off = o - 2 * mm;
    out = off;
  }
  float s = 0.f;
  if (o < total)
    for (int64_t b = l; b < nb; b += 8) s += src[b * stride + off];
  s += __shfl_down_sync(0xffffffffu, s, 4, 8);
  s += __shfl_down_sync(0xffffffffu, s, 2, 8);
  s += __shfl_down_sync(0xffffffffu, s, 1, 8);
  if (o < total && l == 0) dst[out] = s;
}

template <typename T>
cudaError_t launch(const void* g, const void* B, const void* delta, void* B_new,
                   float* gram_part, float* cross_part, float* a_part, int64_t m,
                   int64_t d, int64_t nb, cudaStream_t stream) {
  const int64_t nt = (m + MT - 1) / MT, mp = nt * MT;
  const dim3 grid((unsigned)nb, (unsigned)nt, (unsigned)nt);
  const bool vec = d % 4 == 0 && rt::aligned(g, 4 * sizeof(T)) &&
                   rt::aligned(B, 4 * sizeof(T)) && rt::aligned(delta, 4 * sizeof(T)) &&
                   rt::aligned(B_new, 4 * sizeof(T));
  const T* gt = static_cast<const T*>(g);
  const T* bt = static_cast<const T*>(B);
  const T* dt = static_cast<const T*>(delta);
  T* bn = static_cast<T*>(B_new);
  if (vec)
    fused_guard_kernel<T, true><<<grid, NT, 0, stream>>>(gt, bt, dt, bn, gram_part,
                                                         cross_part, a_part, m, d, mp);
  else
    fused_guard_kernel<T, false><<<grid, NT, 0, stream>>>(gt, bt, dt, bn, gram_part,
                                                          cross_part, a_part, m, d, mp);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (g, B, delta and B_new share it).  The scratch
// buffers hold nb·mp·mp (Grams) and nb·mp (A) floats, mp = 32·ceil(m/32).
// Returns 0 or the CUDA error of the first launch that failed.
extern "C" int rt_fused_guard(int64_t dtype, const void* g, const void* B, const void* delta,
                              void* B_new, void* gram_part, void* cross_part, void* a_part,
                              void* gram, void* cross, void* a_inc, int64_t m, int64_t d,
                              int64_t nb, int64_t device, void* stream) {
  if (m < 1 || m > 4 * MT || d < 1 || nb < 1 || nb > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gp = static_cast<float*>(gram_part);
  float* cp = static_cast<float*>(cross_part);
  float* ap = static_cast<float*>(a_part);
  if (dtype == 0)
    err = launch<float>(g, B, delta, B_new, gp, cp, ap, m, d, nb, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(g, B, delta, B_new, gp, cp, ap, m, d, nb, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const int64_t mp = ((m + MT - 1) / MT) * MT;
  const int64_t threads = 8 * (2 * m * m + m);
  fused_guard_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      gp, cp, ap, static_cast<float*>(gram), static_cast<float*>(cross),
      static_cast<float*>(a_inc), m, mp, nb);
  return (int)cudaGetLastError();
}
