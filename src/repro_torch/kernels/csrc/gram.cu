// The worker Gram matrix G = X Xᵀ on Hopper.
//
// Replaces: repro/kernels/pairdist.py, gram_pallas (body _gram_kernel).
// X is (m, d) f32 or bf16, G is (m, m) f32.
//
// What bounds it on an H100 (m = 32, d = 2^20): one read of X, m·d·e bytes
// (e = 4 or 2), 134 MB in f32 (~40 µs at 3.35 TB/s) and 67 MB in bf16
// (~20 µs), against m·m·d = 1.07 G multiply-adds: ~32 µs at the 67 TFLOP/s
// f32 CUDA-core rate, ~2 µs at the 989 TFLOP/s bf16 tensor-core rate.  So
// both dtypes are bound by bytes, f32 with the FMAs close behind.
//
// What held the first version back (0.082 ms in both dtypes): each block
// kept one 64-column tile of loads in flight in registers, upcast bf16 to
// f32 in shared memory and ran the same FMA loop for both dtypes, so the
// two took the same time, far from either floor.  This version:
//   * keeps STAGES = 4 tiles of 512 bytes a row in flight per block in a
//     shared-memory ring filled by cp.async (16-byte copies, no registers,
//     no upcast), ~50 KB of loads in flight per block;
//   * sums at most FLUSH = 16 tiles in a register accumulator before it
//     joins a running sum in shared memory, so the f32 sums stay short
//     chains at any d (a block walks ~2,000 tiles at d = 2^26);
//   * bf16: tensor cores.  Fragments come straight from the bf16 tiles by
//     ldmatrix and go to mma.sync m16n8k16 with f32 accumulators; a
//     bf16×bf16 product is exact in f32, so only the order of the f32 sums
//     differs from the plain version.  Each of the 8 warps takes its own
//     16-column slices of a tile for the whole 32×32 output;
//   * f32: IEEE f32 FMAs on the CUDA cores (no TF32, which would miss the
//     2e-5 tolerance of the reference's Gram tests).  Each thread holds an
//     8×4 register tile, so 12 float4 reads of shared memory feed 128 FMAs
//     (the first version's 4×4 tile: 8 for 64), and each of the 8 warps
//     takes its own columns of a tile.  The row pitch makes every warp's
//     float4 reads of a row tile fall in distinct banks.  Measured on an
//     H100 (PERF.md §6): the copies alone take 0.049 ms of this kernel and
//     the FMAs alone 0.052, together 0.070, so neither is the wall; an 8×8
//     tile over only the 10 of 16 sub-tiles on or above the diagonal (5/8
//     of the FMAs, 1 byte of shared memory per FMA) took 0.072, so this
//     simpler form stays.
// d is split across blocks: split z takes the tiles z, z + nb, ... and
// keeps its share of the Gram in registers; its 8 warps are summed in a
// fixed order in shared memory, and the block writes its partial Gram to a
// scratch buffer.  A second kernel sums the nb partials in a fixed order:
// no float atomics, so two calls give the same bits (Krum's and the
// medoid's argmin pick the same row every time).  Workers come in tiles of
// 32 on grid x and y (the fastest, so blocks that run at the same time
// read the same columns and share them in L2); only tile pairs ti <= tj
// run, and both G[i][j] and G[j][i] are read from the (min, max) entry, so
// G is exactly symmetric.  Any m from 1 to MAX_WORKERS and any d are taken
// with zero-filled tails and no padded copy; offsets are int64 (m·d may
// pass 2^31).  Rows whose length is not a multiple of 16 bytes (or an
// unaligned X) are copied by plain loads instead of cp.async.
//
// The run axis (entry rt_gram_runs): the R runs of a campaign group in one
// launch, X (R, m, d), G (R, m, m).  Grid x is run · nt + ti; each run
// reads its own X, writes its own partials (an R axis in front of the
// scratch) and sums them in the one-run order, so with the nb of a one-run
// launch each G is that launch's bits; R = 1 is rt_gram.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MT = 32;               // workers per output tile
constexpr int NT = 256;              // threads per block (8 warps)
constexpr int STAGES = 4;            // tiles in the cp.async ring
constexpr int ROW_BYTES = 512;       // bytes of one row per tile: 256 bf16 or 128 f32
constexpr int PITCH = ROW_BYTES + 16;  // padded shared-memory row (132 words)
constexpr int CHUNKS = MT * ROW_BYTES / 16;  // 16-byte copies per row tile
constexpr int OPERAND_BYTES = MT * PITCH;
constexpr int ACC = 32;        // f32 accumulators a thread holds (bf16: 2×4×4, f32: 8×4)
constexpr int FLUSH = 16;      // tiles summed in registers before they join the running sum
constexpr int RUN_BYTES = ACC * NT * 4;  // the running sums, after the ring

// Rows row0 .. row0 + 31 of X, columns [col0, col0 + ROW_BYTES / e), into
// one operand slot of the ring; rows at or past m and columns at or past d
// are zero.  VEC: every row is 16-byte aligned and d·e is a multiple of 16,
// so each 16-byte chunk is wholly in range or wholly out.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* slot, const T* __restrict__ x,
                                          int64_t row0, int64_t col0, int64_t m, int64_t d) {
  constexpr int E = (int)sizeof(T);
  constexpr int PER = 16 / E;  // elements per chunk
  for (int c = threadIdx.x; c < CHUNKS; c += NT) {
    const int r = c / (ROW_BYTES / 16);
    const int q = c % (ROW_BYTES / 16);
    const int64_t row = row0 + r;
    const int64_t col = col0 + (int64_t)q * PER;
    unsigned char* dst = slot + r * PITCH + q * 16;
    if constexpr (VEC) {
      const bool in = row < m && col < d;
      rt::cp_async16(dst, in ? (const void*)(x + row * d + col) : (const void*)x, in ? 16 : 0);
    } else {
      // the raw bits, element by element (a zero word is 0.0 in both types)
      using U = typename std::conditional<E == 2, uint16_t, uint32_t>::type;
      const U* xb = reinterpret_cast<const U*>(x);
      U v[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) v[e] = (row < m && col + e < d) ? xb[row * d + col + e] : U(0);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// bf16: warp w takes the 16-column slices w and w + 8 of each 256-column
// tile, for the whole 32×32 output: 2 row blocks of 16 (A) × 4 column
// blocks of 8 (B), fragments by ldmatrix.x4 from the row tiles.  For a
// diagonal block the B fragments are the A fragments.
struct Bf16Acc {
  float c[2][4][4];
};

__device__ __forceinline__ void compute_bf16(Bf16Acc& acc, const unsigned char* sI,
                                             const unsigned char* sJ, bool diag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // ldmatrix.x4: lane l gives the row of matrix l / 8; matrices 0..3 are
  // (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 16 * (lane >> 4);  // bytes: k offset 8 elements
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int kb = 32 * (warp + 8 * q);  // byte offset of the 16-column slice
    unsigned a[2][4], b[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) rt::ldmatrix_x4(a[h], sI + (16 * h + lrow) * PITCH + kb + lcol);
    if (diag) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < 4; ++t) b[h][t] = a[h][t];
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) rt::ldmatrix_x4(b[h], sJ + (16 * h + lrow) * PITCH + kb + lcol);
    }
    // column block n of 8 rows of X_J: (b[n/2][n%2], b[n/2][n%2 + 2])
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        rt::mma_bf16(acc.c[mi][n], a[mi], b[n >> 1][n & 1], b[n >> 1][(n & 1) + 2]);
  }
}

// f32: warp w is column group w: it takes float4 columns w, w + 8, w + 16
// and w + 24 of each 128-column tile.  Lane (tr, tc) = (lane / 8, lane % 8)
// holds output rows tr + 4·ii (ii < 8) and columns tc + 8·jj (jj < 4): per
// float4 of k, 8 reads of A and 4 of B feed 128 FMAs.  At a pitch of 132
// words the 8 rows tc + 8·jj of a B read sit 4 banks apart (all 32 banks
// once), and the 4 rows of an A read likewise (the rest are broadcasts).
__device__ __forceinline__ void compute_f32(float acc[8][4], const unsigned char* sI,
                                            const unsigned char* sJ) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tr = lane >> 3, tc = lane & 7;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int off = 16 * (warp + 8 * s);
    float4 a[8];
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
      a[ii] = *reinterpret_cast<const float4*>(sI + (tr + 4 * ii) * PITCH + off);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 b = *reinterpret_cast<const float4*>(sJ + (tc + 8 * jj) * PITCH + off);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        float& v = acc[ii][jj];
        v = fmaf(a[ii].x, b.x, v);
        v = fmaf(a[ii].y, b.y, v);
        v = fmaf(a[ii].z, b.z, v);
        v = fmaf(a[ii].w, b.w, v);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 2)
gram_kernel(const T* __restrict__ x, float* __restrict__ part, int64_t m, int64_t d,
            int64_t mp, int64_t nt, int ops) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ti = (int)(blockIdx.x % nt), tj = blockIdx.y;
  const int64_t run_idx = blockIdx.x / nt;
  x += run_idx * m * d;
  part += run_idx * gridDim.z * mp * mp;
  if (ti > tj) return;  // G is symmetric: the pair (tj, ti) gives this tile
  const bool diag = ti == tj;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int64_t TKE = ROW_BYTES / sizeof(T);  // columns per tile
  const int64_t n_tiles = (d + TKE - 1) / TKE;
  const int64_t nb = gridDim.z, split = blockIdx.z;
  const int64_t cnt = split < n_tiles ? (n_tiles - 1 - split) / nb + 1 : 0;
  auto slot = [&](int64_t k, int which) {
    return smem + ((k % STAGES) * ops + which) * OPERAND_BYTES;
  };
  auto load = [&](int64_t k) {
    const int64_t col0 = (split + k * nb) * TKE;
    load_tile<T, VEC>(slot(k, 0), x, (int64_t)ti * MT, col0, m, d);
    if (!diag) load_tile<T, VEC>(slot(k, 1), x, (int64_t)tj * MT, col0, m, d);
  };

  Bf16Acc hacc;
  float facc[8][4];
  if constexpr (BF16) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int t = 0; t < 4; ++t) hacc.c[mi][n][t] = 0.f;
  } else {
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) facc[ii][jj] = 0.f;
  }
  // A register accumulator takes FLUSH tiles, then joins this thread's
  // running sum in shared memory and starts again from zero: chains of at
  // most FLUSH tiles of FMAs, however long d is (at d = 2^26 a block walks
  // ~2,000 tiles), so the f32 rounding stays that of a short sum.
  float* run = reinterpret_cast<float*>(smem + (size_t)STAGES * ops * OPERAND_BYTES);
#pragma unroll
  for (int q = 0; q < ACC; ++q) run[q * NT + threadIdx.x] = 0.f;
  auto flush = [&]() {
    if constexpr (BF16) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            run[((mi * 4 + n) * 4 + t) * NT + threadIdx.x] += hacc.c[mi][n][t];
            hacc.c[mi][n][t] = 0.f;
          }
    } else {
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          run[(ii * 4 + jj) * NT + threadIdx.x] += facc[ii][jj];
          facc[ii][jj] = 0.f;
        }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < cnt) load(s);
    rt::cp_async_commit();
  }
  for (int64_t k = 0; k < cnt; ++k) {
    rt::cp_async_wait<STAGES - 2>();  // tile k has landed (this thread's copies)
    __syncthreads();                  // ... everyone's, and tile k - 1 is consumed
    if (k + STAGES - 1 < cnt) load(k + STAGES - 1);
    rt::cp_async_commit();
    const unsigned char* sI = slot(k, 0);
    const unsigned char* sJ = diag ? sI : slot(k, 1);
    if constexpr (BF16)
      compute_bf16(hacc, sI, sJ, diag);
    else
      compute_f32(facc, sI, sJ);
    if ((k + 1) % FLUSH == 0) flush();
  }
  rt::cp_async_wait<0>();
  flush();
  __syncthreads();

  // sum the 8 warps in a fixed order, then write this block's partial
  // (MT, MT) tile
  float* red = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (BF16) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int r = 16 * mi + gid + 8 * (t >> 1);
          const int c = 8 * n + 2 * tig + (t & 1);
          red[warp * MT * MT + r * MT + c] = run[((mi * 4 + n) * 4 + t) * NT + threadIdx.x];
        }
  } else {
    const int tr = lane >> 3, tc = lane & 7;
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        red[warp * MT * MT + (tr + 4 * ii) * MT + tc + 8 * jj] =
            run[(ii * 4 + jj) * NT + threadIdx.x];
  }
  __syncthreads();
  for (int ij = threadIdx.x; ij < MT * MT; ij += NT) {
    float s = red[ij];
#pragma unroll
    for (int q = 1; q < NT / 32; ++q) s += red[q * MT * MT + ij];
    const int64_t gi = (int64_t)ti * MT + ij / MT;
    const int64_t gj = (int64_t)tj * MT + ij % MT;
    part[(split * mp + gi) * mp + gj] = s;
  }
}

// Sums the nb partials of every output in a fixed order: the 32 lanes of a
// warp take every 32nd partial, then a fixed shuffle tree over the 32.
// G[i][j] and G[j][i] both read the partials' (min, max) entry.
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ gram, int64_t m,
                   int64_t mp, int64_t nb, int64_t runs) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t o = t >> 5;  // output o % m² of run o / m²
  const int l = (int)(t & 31);
  const int64_t run = o / (m * m), ij = o % (m * m);
  const int64_t i = ij / m, j = ij % m;
  const int64_t off = run * nb * mp * mp + (i < j ? i : j) * mp + (i < j ? j : i);
  float s = 0.f;
  if (run < runs) {
#pragma unroll 4
    for (int64_t b = l; b < nb; b += 32) s += part[b * mp * mp + off];
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) s += __shfl_down_sync(0xffffffffu, s, k);
  if (run < runs && l == 0) gram[o] = s;
}

template <typename T, bool VEC>
cudaError_t launch_one(const T* x, float* part, int64_t m, int64_t d, int64_t nb, int64_t nt,
                       int64_t runs, cudaStream_t stream) {
  const int ops = nt > 1 ? 2 : 1;
  const size_t bytes = (size_t)STAGES * ops * OPERAND_BYTES + RUN_BYTES;
  // the largest ring this kernel takes, allowed once per device (above the
  // default 48 KB of dynamic shared memory)
  static uint64_t allowed = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((allowed >> device) & 1)) {
    err = cudaFuncSetAttribute(gram_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGES * 2 * OPERAND_BYTES + RUN_BYTES);
    if (err != cudaSuccess) return err;
    allowed |= 1ull << device;
  }
  const dim3 grid((unsigned)(nt * runs), (unsigned)nt, (unsigned)nb);
  gram_kernel<T, VEC><<<grid, NT, bytes, stream>>>(x, part, m, d, nt * MT, nt, ops);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, float* part, int64_t m, int64_t d, int64_t nb,
                   int64_t runs, cudaStream_t stream) {
  const int64_t nt = (m + MT - 1) / MT;
  // every run's rows share the first run's alignment when d·e % 16 == 0
  const bool vec = (d * (int64_t)sizeof(T)) % 16 == 0 && rt::aligned(x, 16);
  const T* xt = static_cast<const T*>(x);
  return vec ? launch_one<T, true>(xt, part, m, d, nb, nt, runs, stream)
             : launch_one<T, false>(xt, part, m, d, nb, nt, runs, stream);
}

int run_gram(int64_t dtype, int64_t runs, const void* x, void* part, void* gram, int64_t m,
             int64_t d, int64_t nb, int64_t device, void* stream) {
  if (m < 1 || m > rt::MAX_WORKERS || d < 1 || nb < 1 || nb > 65535 || runs < 1 ||
      ((m + MT - 1) / MT) * runs > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    err = launch<float>(x, p, m, d, nb, runs, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, p, m, d, nb, runs, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const int64_t mp = ((m + MT - 1) / MT) * MT;
  const int64_t threads = 32 * m * m * runs;
  gram_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      p, static_cast<float*>(gram), m, mp, nb, runs);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x only; the Gram is f32).  The scratch buffer
// holds nb·mp·mp floats, mp = 32·ceil(m/32).  1 <= m <= MAX_WORKERS.
// Returns 0 or the CUDA error of the first launch that failed.
extern "C" int rt_gram(int64_t dtype, const void* x, void* part, void* gram, int64_t m,
                       int64_t d, int64_t nb, int64_t device, void* stream) {
  return run_gram(dtype, 1, x, part, gram, m, d, nb, device, stream);
}

// The run axis: x (runs, m, d), part (runs, nb, mp, mp), gram (runs, m, m),
// one launch.  runs = 1 is rt_gram.
extern "C" int rt_gram_runs(int64_t dtype, int64_t runs, const void* x, void* part,
                            void* gram, int64_t m, int64_t d, int64_t nb, int64_t device,
                            void* stream) {
  return run_gram(dtype, runs, x, part, gram, m, d, nb, device, stream);
}
