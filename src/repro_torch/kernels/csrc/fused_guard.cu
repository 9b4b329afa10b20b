// One-pass guard statistics on Hopper.
//
// Replaces: repro/kernels/fused_guard.py, fused_guard_pallas (body
// _fused_guard_kernel, and _fused_guard_sanitize_kernel for sanitize=True).
// One sweep over the (m, d) worker gradients g and the martingale matrix B
// gives
//   gram_g = g gᵀ (m, m) f32,  cross = B gᵀ (m, m) f32 (pre-update B),
//   a_inc  = g·δ  (m,)   f32,  B_new = B + g (m, d), rounded once to B's type.
// The sanitizing variant (template flag SAN, entry rt_fused_guard_sanitize)
// zeroes every NaN/Inf entry of g after the upcast, before any product and
// before the B_new store, and adds a fifth output nf (m,) int32: each row's
// count of non-finite entries.  B and δ are not tested (finite by
// construction).  On finite input its four shared outputs equal the plain
// variant's bit for bit: the same sums in the same order.
// The generating variant (entry rt_fused_guard_gen) replaces
// fused_guard_gen_pallas (body _fused_guard_gen_kernel, strip prologue
// _gen_strip): it reads no g, but generates each tile of g from the worker
// keys and the attack parameters (gen_rows.cuh), rounded once through B's
// type as the materialising path stores its batch.  Given the same rows it
// gives the plain variant's bits: at f32 it generates each tile in
// registers where the plain sweep loads it and everything after the load
// is the same code (template flag GEN), and at bf16 all three variants
// run one consumer (guard_sweep.cuh).
// ALIE rows need the honest column moments μ, σ over all m rows, which a
// 32-row tile does not hold when m > 32: a small first kernel
// (gen_moments_kernel) writes them to 2·d floats, and returns at once when
// no phase plays ALIE.  The caller keeps them for gen_xi (filtered_mean.cu),
// which then skips its own moments pass: one moments pass a step.
//
// f32: every product in f32 on the CUDA cores with FMAs (no TF32, which
// would break the 1e-5 tolerance against the plain version).  bf16: the
// Grams on the tensor cores (mma.sync, bf16 in, f32 sums; a bf16×bf16
// product is exact in f32), B_new and a_inc in f32 on the CUDA cores.
//
// What bounds it on an H100 (m = 32, d = 2^20): f32 moves 3·m·d·4 B =
// 402,653,184 B, ~120 µs at 3.35 TB/s, against 4·m²·d ≈ 4.4 GFLOP, ~65 µs at
// the 67 TFLOP/s f32 CUDA-core rate, so f32 is bound by bytes; bf16 halves
// the bytes to ~60 µs and, on the tensor cores, stays bound by them.  The
// generating variant moves only B and B_new (2·m·d·e B) but issues
// threefry's ~72 integer operations per generated element (each diagonal
// block generates its tile once, each off-diagonal one two tiles): at
// m = 32 that is ~2.4 G integer operations, ~0.14 ms at 64 per clock per
// SM, so it is bound by integer operations.
//
// Design.  The Pallas grid walks d in order and carries the (m, m)
// accumulators from one strip to the next; CUDA blocks run in parallel and
// carry nothing.  So d is split across blocks instead: split x takes the
// 64-column tiles x, x + nb, ... and keeps its share of both Grams
// in registers (a 4x4 register tile of gram_g and of cross per thread, four
// groups of 64 threads each taking 16 of a tile's 64 columns).  Each tile
// of g and B is read from device memory once; the same registers write
// B_new and the A-increments, so the sweep reads g, B, δ once and writes
// B_new once.  The next tile's loads are issued before the current tile's
// FMAs, so loads overlap compute.  Each block writes its partial Grams to a
// scratch buffer, and a second small kernel sums the partials in a fixed
// order: no float atomics, so two runs give the same bits.  Workers are
// taken in tiles of 32 (grid y, z); any m from 1 to rt::MAX_WORKERS and any
// d are handled with masked tails and no padded copy, and all offsets are
// int64 (m·d may pass 2^31).  The wrapper picks nb from the shape alone
// (fewer d-splits as the nt² worker-tile pairs grow), so the partials stay
// bounded and the bits repeat.  Only diagonal blocks (ti == tj) write
// B_new, a_inc and the SAN counts, so each row is written once whatever nt.
// The bf16 sweep (guard_sweep.cuh) keeps this grid, the partials and their
// reduction.
//
// The run axis (entries rt_fused_guard_runs and rt_fused_guard_gen_runs):
// what vmap of the Pallas call computes, one launch for the R runs of a
// campaign group.  Grid x is run · nb + split; each run reads its own g
// (GEN: its own generator operands, gen_rows.cuh's Args::at_run), B and δ
// and writes its own partials (an R axis in front of the scratch) and
// outputs, and the reductions walk each run's partials in the one-run
// order.  With the nb of a one-run launch every run's outputs are that
// launch's bits; R = 1 is today's launch.  The run offsets are int64
// (R·m·d may pass 2^31).
//
// The sanitizing variant zeroes g where it is used, after the prefetch has
// landed, so no extra instruction waits on a load.  Each entry of g is
// counted once: in the diagonal blocks (ti == tj), which load every row of
// their tile exactly once over the sweep; off-diagonal blocks zero their
// second row tile without counting.  Per-block counts go to scratch and a
// third small kernel sums them per row (integers, no atomics).

#include "guard_sweep.cuh"

namespace {

using rt::guard::MT;
using rt::guard::sum16;
using rt::guard::guard_bf16_kernel;
namespace bf = rt::guard::bf;
constexpr int TK = 64;        // columns of d per shared-memory tile
constexpr int LDS = TK + 4;   // padded row: 16-B aligned, conflict-free float4 reads
constexpr int NT = 256;       // threads per block
constexpr int KG = 4;         // column groups of 64 threads each
constexpr int KW = TK / KG;   // columns of a tile per group
constexpr int SMEM_TILE = 3 * MT * LDS;
constexpr int SMEM_RED = KG * 2 * MT * MT;
constexpr int SMEM = SMEM_TILE > SMEM_RED ? SMEM_TILE : SMEM_RED;

// The plain, sanitizing and generating f32 sweep.
template <bool VEC, bool SAN, bool GEN>
__global__ void __launch_bounds__(NT, 2)
fused_guard_kernel(const float* __restrict__ g, const float* __restrict__ B,
                   const float* __restrict__ delta, float* __restrict__ B_new,
                   float* __restrict__ gram_part, float* __restrict__ cross_part,
                   float* __restrict__ a_part, int* __restrict__ nf_part, int64_t m,
                   int64_t d, int64_t mp, int64_t nb, rt::gen::Args ga) {
  static_assert(!(SAN && GEN), "the generating sweep has no sanitizing variant");
  __shared__ __align__(16) float smem[SMEM];
  // grid x is run · nb + split: run r's operands, partials and outputs lie
  // r strides past the first run's
  const int64_t run = blockIdx.x / nb, split = blockIdx.x % nb;
  if (run) {
    if constexpr (GEN) ga = ga.at_run(run);
    else g += run * m * d;
    B += run * m * d;
    B_new += run * m * d;
    delta += run * d;
    gram_part += run * nb * mp * mp;
    cross_part += run * nb * mp * mp;
    a_part += run * nb * mp;
    if constexpr (SAN) nf_part += run * nb * mp;
  }
  // GEN: the constants of the block's two row tiles (I, then J)
  __shared__ rt::gen::Row srow[GEN ? 2 * MT : 1];
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

  float ns = 0.f, tgnrm = 0.f;
  if constexpr (GEN) {
    for (int r = tid; r < 2 * MT; r += NT) {
      const int64_t i = (int64_t)(r < MT ? ti : tj) * MT + r % MT;
      srow[r] = i < m ? rt::gen::load_row(ga, i) : rt::gen::padding_row();
    }
    ns = ga.params[rt::gen::P_NSCALE];
    tgnrm = ga.params[rt::gen::P_TGNRM];
    __syncthreads();
  }

  float pg[2][4], pb[2][4], pj[2][4], pd[4];
  auto fetch = [&](int64_t tile) {
    const int64_t c = tile * TK + lc;
    if constexpr (GEN) {
      // rows lr and lr + 16 of each row tile, columns c .. c + 3, generated
      // where the plain sweep loads them (f32: exact)
      rt::gen::Col col[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) col[q] = rt::gen::load_col(ga, c + q < d ? c + q : d - 1);
      const rt::gen::Row rI[2] = {srow[lr], srow[lr + 16]};
      rt::gen::values_at<2, 4>(rI, col, ns, tgnrm, ga.moments, c, d, pg);
      if (!diag) {
        const rt::gen::Row rJ[2] = {srow[MT + lr], srow[MT + lr + 16]};
        rt::gen::values_at<2, 4>(rJ, col, ns, tgnrm, ga.moments, c, d, pj);
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (vI[p]) {
        if constexpr (!GEN) rt::load4<float, VEC>(g + rowI[p] * d, c, d, pg[p]);
        rt::load4<float, VEC>(B + rowI[p] * d, c, d, pb[p]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) pg[p][q] = pb[p][q] = 0.f;
      }
      if (!diag && !GEN) {
        if (vJ[p]) {
          rt::load4<float, VEC>(g + rowJ[p] * d, c, d, pj[p]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) pj[p][q] = 0.f;
        }
      }
    }
    if (diag) rt::load4<float, VEC>(delta, c, d, pd);
  };

  float acc_g[4][4], acc_c[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc_g[ii][jj] = acc_c[ii][jj] = 0.f;
  float a_acc[2] = {0.f, 0.f};
  int nf_acc[2] = {0, 0};  // SAN: this thread's non-finite entries of rows I

  const int64_t n_tiles = (d + TK - 1) / TK;
  int64_t tile = split;
  if (tile < n_tiles) fetch(tile);
  for (; tile < n_tiles; tile += nb) {
    if constexpr (SAN) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool bad = rt::nonfinite(pg[p][q]);
          if (diag) nf_acc[p] += bad;
          pg[p][q] = bad ? 0.f : pg[p][q];
          if (!diag) pj[p][q] = rt::nonfinite(pj[p][q]) ? 0.f : pj[p][q];
        }
    }
    if (diag) {
      const int64_t c = tile * TK + lc;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (!vI[p]) continue;
        float s[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[q] = pb[p][q] + pg[p][q];  // f32 add
          a_acc[p] = fmaf(pg[p][q], pd[q], a_acc[p]);
        }
        rt::store4<float, VEC>(B_new + rowI[p] * d, c, d, s);
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
    if (tile + nb < n_tiles) fetch(tile + nb);  // in flight during the FMAs

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
    dst[(split * mp + gi) * mp + gj] = s;
  }
  if (diag) {
    // the 16 lanes that loaded a row hold its A-increment in pieces
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int64_t o = split * mp + (int64_t)ti * MT + lr + 16 * p;
      const float v = sum16(a_acc[p]);
      if ((tid & 15) == 0) a_part[o] = v;
      if constexpr (SAN) {
        const int c = sum16(nf_acc[p]);
        if ((tid & 15) == 0) nf_part[o] = c;
      }
    }
  }
}

// Sums the nb partials of every output in a fixed order: eight lanes per
// output take every eighth partial, then a fixed tree over the eight.  The
// outputs of run r follow those of run r − 1; each run's sums take the
// order of a one-run launch.
__global__ void __launch_bounds__(256)
fused_guard_reduce_kernel(const float* __restrict__ gram_part,
                          const float* __restrict__ cross_part,
                          const float* __restrict__ a_part, float* __restrict__ gram,
                          float* __restrict__ cross, float* __restrict__ a_inc,
                          int64_t m, int64_t mp, int64_t nb, int64_t runs) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int l = (int)(t & 7);
  const int64_t mm = m * m, total = 2 * mm + m;
  const int64_t run = (t >> 3) / total;
  const int64_t o = run < runs ? (t >> 3) % total : total;
  if (run < runs) {
    gram_part += run * nb * mp * mp;
    cross_part += run * nb * mp * mp;
    a_part += run * nb * mp;
    gram += run * mm;
    cross += run * mm;
    a_inc += run * m;
  }
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

// Sums each row's nb per-block non-finite counts (sanitizing variant only),
// for every row of every run.
__global__ void __launch_bounds__(128)
nf_reduce_kernel(const int* __restrict__ nf_part, int* __restrict__ nf, int64_t m,
                 int64_t mp, int64_t nb, int64_t runs) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= runs * m) return;
  const int64_t run = t / m, i = t % m;
  const int* part = nf_part + run * nb * mp;
  int s = 0;
  for (int64_t b = 0; b < nb; ++b) s += part[b * mp + i];
  nf[t] = s;
}

// The outputs and scratch of one sweep, as the entry points receive them.
struct Sweep {
  const void* g;  // null for the generating variant
  const void* B;
  const void* delta;
  void* B_new;
  float* gram_part;
  float* cross_part;
  float* a_part;
  int* nf_part;
  int64_t m, d, nb;
  int64_t runs;  // runs of one launch, each with its own operands
};

template <bool SAN, bool GEN>
cudaError_t launch_f32(const Sweep& w, const rt::gen::Args& ga, cudaStream_t stream) {
  const int64_t nt = (w.m + MT - 1) / MT, mp = nt * MT;
  const dim3 grid((unsigned)(w.nb * w.runs), (unsigned)nt, (unsigned)nt);
  const bool vec = w.d % 4 == 0 && (GEN || rt::aligned(w.g, 16)) && rt::aligned(w.B, 16) &&
                   rt::aligned(w.delta, 16) && rt::aligned(w.B_new, 16);
  const float* gt = static_cast<const float*>(w.g);
  const float* bt = static_cast<const float*>(w.B);
  const float* dt = static_cast<const float*>(w.delta);
  float* bn = static_cast<float*>(w.B_new);
  if (vec)
    fused_guard_kernel<true, SAN, GEN><<<grid, NT, 0, stream>>>(
        gt, bt, dt, bn, w.gram_part, w.cross_part, w.a_part, w.nf_part, w.m, w.d, mp, w.nb,
        ga);
  else
    fused_guard_kernel<false, SAN, GEN><<<grid, NT, 0, stream>>>(
        gt, bt, dt, bn, w.gram_part, w.cross_part, w.a_part, w.nf_part, w.m, w.d, mp, w.nb,
        ga);
  return cudaGetLastError();
}

template <bool VEC, bool SAN, bool GEN>
cudaError_t launch_bf16_one(const Sweep& w, const rt::gen::Args& ga, cudaStream_t stream) {
  const int64_t nt = (w.m + MT - 1) / MT;
  const int ops = nt > 1 ? 3 : 2;
  // the largest ring this kernel takes, allowed once per device (above the
  // default 48 KB of dynamic shared memory)
  static uint64_t allowed = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !((allowed >> device) & 1)) {
    err = cudaFuncSetAttribute(guard_bf16_kernel<VEC, SAN, GEN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bf::STAGES * bf::stage_bytes(3));
    if (err != cudaSuccess) return err;
    allowed |= 1ull << device;
  }
  const dim3 grid((unsigned)(w.nb * w.runs), (unsigned)nt, (unsigned)nt);
  const int threads = GEN ? bf::NC + bf::NG : bf::NC;
  guard_bf16_kernel<VEC, SAN, GEN><<<grid, threads, (size_t)bf::STAGES * bf::stage_bytes(ops),
                                     stream>>>(
      static_cast<const __nv_bfloat16*>(w.g), static_cast<const __nv_bfloat16*>(w.B),
      static_cast<const __nv_bfloat16*>(w.delta), static_cast<__nv_bfloat16*>(w.B_new),
      w.gram_part, w.cross_part, w.a_part, w.nf_part, w.m, w.d, nt * MT, w.nb, ops, ga);
  return cudaGetLastError();
}

template <bool SAN, bool GEN>
cudaError_t launch_bf16(const Sweep& w, const rt::gen::Args& ga, cudaStream_t stream) {
  // VEC: whole 16-byte chunks (8 bf16) of every row, aligned
  const bool vec = w.d % 8 == 0 && (GEN || rt::aligned(w.g, 16)) && rt::aligned(w.B, 16) &&
                   rt::aligned(w.delta, 16) && rt::aligned(w.B_new, 16);
  return vec ? launch_bf16_one<true, SAN, GEN>(w, ga, stream)
             : launch_bf16_one<false, SAN, GEN>(w, ga, stream);
}

template <bool SAN, bool GEN>
int run(int64_t dtype, const Sweep& w, void* gram, void* cross, void* a_inc, void* nf,
        const rt::gen::Args& ga, int64_t device, void* stream) {
  // GEN: the moments kernel's grid y is the run
  if (w.m < 1 || w.m > rt::MAX_WORKERS || w.d < 1 || w.nb < 1 || w.runs < 1 ||
      w.nb * w.runs > 0x7fffffff || (GEN && w.runs > 65535))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (GEN) {
    err = rt::gen::launch_moments(ga, w.m, w.d, s, w.runs);
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype == 0)
    err = launch_f32<SAN, GEN>(w, ga, s);
  else if (dtype == 1)
    err = launch_bf16<SAN, GEN>(w, ga, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const int64_t mp = ((w.m + MT - 1) / MT) * MT;
  const int64_t threads = 8 * (2 * w.m * w.m + w.m) * w.runs;
  fused_guard_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      w.gram_part, w.cross_part, w.a_part, static_cast<float*>(gram),
      static_cast<float*>(cross), static_cast<float*>(a_inc), w.m, mp, w.nb, w.runs);
  if constexpr (SAN) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nf_reduce_kernel<<<(unsigned)((w.m * w.runs + 127) / 128), 128, 0, s>>>(
        w.nf_part, static_cast<int*>(nf), w.m, mp, w.nb, w.runs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (g, B, delta and B_new share it).  The scratch
// buffers hold nb·mp·mp (Grams) and nb·mp (A) floats, mp = 32·ceil(m/32);
// nb is the number of d-splits, chosen by the caller from the shape (the
// f32 sweep walks d in tiles of 64 columns, the bf16 one in tiles of 128).
// Returns 0 or the CUDA error of the first launch that failed.
extern "C" int rt_fused_guard(int64_t dtype, const void* g, const void* B, const void* delta,
                              void* B_new, void* gram_part, void* cross_part, void* a_part,
                              void* gram, void* cross, void* a_inc, int64_t m, int64_t d,
                              int64_t nb, int64_t device, void* stream) {
  const Sweep w{g, B, delta, B_new, static_cast<float*>(gram_part),
                static_cast<float*>(cross_part), static_cast<float*>(a_part), nullptr, m, d,
                nb, 1};
  return run<false, false>(dtype, w, gram, cross, a_inc, nullptr, rt::gen::Args{}, device,
                           stream);
}

// The sanitizing variant: as rt_fused_guard, plus nb·mp int32 of scratch
// (nf_part) and the (m,) int32 output nf.
extern "C" int rt_fused_guard_sanitize(int64_t dtype, const void* g, const void* B,
                                       const void* delta, void* B_new, void* gram_part,
                                       void* cross_part, void* a_part, void* nf_part,
                                       void* gram, void* cross, void* a_inc, void* nf,
                                       int64_t m, int64_t d, int64_t nb, int64_t device,
                                       void* stream) {
  const Sweep w{g, B, delta, B_new, static_cast<float*>(gram_part),
                static_cast<float*>(cross_part), static_cast<float*>(a_part),
                static_cast<int*>(nf_part), m, d, nb, 1};
  return run<true, false>(dtype, w, gram, cross, a_inc, nf, rt::gen::Args{}, device, stream);
}

// The run axis: one launch for `runs` independent sweeps of one shape (a
// campaign's runs, stacked), each run's operands, scratch and outputs
// contiguous after the last run's: g, B, B_new (runs, m, d), delta
// (runs, d), the partials (runs, nb, mp, mp) and (runs, nb, mp), gram and
// cross (runs, m, m), a_inc (runs, m); sanitize adds nf_part (runs, nb, mp)
// and nf (runs, m).  Each run takes the blocks, partials and reduction
// order of a one-run launch with the same nb, so its outputs are that
// launch's bits; runs = 1 is rt_fused_guard / rt_fused_guard_sanitize.
extern "C" int rt_fused_guard_runs(int64_t dtype, int64_t runs, int64_t sanitize,
                                   const void* g, const void* B, const void* delta,
                                   void* B_new, void* gram_part, void* cross_part,
                                   void* a_part, void* nf_part, void* gram, void* cross,
                                   void* a_inc, void* nf, int64_t m, int64_t d, int64_t nb,
                                   int64_t device, void* stream) {
  const Sweep w{g, B, delta, B_new, static_cast<float*>(gram_part),
                static_cast<float*>(cross_part), static_cast<float*>(a_part),
                static_cast<int*>(nf_part), m, d, nb, runs};
  if (sanitize)
    return run<true, false>(dtype, w, gram, cross, a_inc, nf, rt::gen::Args{}, device, stream);
  return run<false, false>(dtype, w, gram, cross, a_inc, nullptr, rt::gen::Args{}, device,
                           stream);
}

// The generating variant: as rt_fused_guard with no g; instead the
// generator's operands (gen_rows.cuh): x, h, x*, het_dir (d,) f32, keys
// (m, 2) uint32 words, skew (m,) f32, slot (m,) int32, params (12,) f32,
// and 2·d floats for the honest column moments.  The moments kernel runs
// first (and returns at once unless an ALIE id is in play) and leaves them
// there for rt_gen_xi; then the sweep generates each tile of g where
// rt_fused_guard loads it.
extern "C" int rt_fused_guard_gen(int64_t dtype, const void* B, const void* delta,
                                  void* B_new, void* gram_part, void* cross_part, void* a_part,
                                  void* gram, void* cross, void* a_inc, const void* x,
                                  const void* h, const void* xs, const void* hd,
                                  const void* keys, const void* skew, const void* slot,
                                  const void* params, void* moments, int64_t m, int64_t d,
                                  int64_t nb, int64_t device, void* stream) {
  const rt::gen::Args ga{static_cast<const float*>(x),        static_cast<const float*>(h),
                         static_cast<const float*>(xs),       static_cast<const float*>(hd),
                         static_cast<const uint32_t*>(keys),  static_cast<const float*>(skew),
                         static_cast<const int*>(slot),       static_cast<const float*>(params),
                         static_cast<float*>(moments)};
  const Sweep w{nullptr, B, delta, B_new, static_cast<float*>(gram_part),
                static_cast<float*>(cross_part), static_cast<float*>(a_part), nullptr, m, d,
                nb, 1};
  return run<false, true>(dtype, w, gram, cross, a_inc, nullptr, ga, device, stream);
}

// The generating variant over a run axis: one launch for `runs` sweeps of
// one shape (a campaign group's runs), each with its own B, delta, B_new
// (as rt_fused_guard_runs lays them out), worker keys (runs, m, 2), skew
// and slot (runs, m), params (runs, 12) and moments (runs, 2, d); x, h, x*
// and het_dir are each (runs, d), or (d,) shared by every run when its
// flag in `shared` (bit 0 x, 1 h, 2 x*, 3 het_dir) is set.  The moments
// kernel runs over the runs first (grid y), then the sweep; each run takes
// the blocks, partials and reduction order of its one-run launch with the
// same nb, so its outputs and moments are that launch's bits.  runs = 1
// with no flag set is rt_fused_guard_gen.
extern "C" int rt_fused_guard_gen_runs(int64_t dtype, int64_t runs, int64_t shared,
                                       const void* B, const void* delta, void* B_new,
                                       void* gram_part, void* cross_part, void* a_part,
                                       void* gram, void* cross, void* a_inc, const void* x,
                                       const void* h, const void* xs, const void* hd,
                                       const void* keys, const void* skew, const void* slot,
                                       const void* params, void* moments, int64_t m,
                                       int64_t d, int64_t nb, int64_t device, void* stream) {
  const bool flags[4] = {(shared & 1) != 0, (shared & 2) != 0, (shared & 4) != 0,
                         (shared & 8) != 0};
  const rt::gen::Args ga = rt::gen::with_run_strides(
      rt::gen::Args{static_cast<const float*>(x),       static_cast<const float*>(h),
                    static_cast<const float*>(xs),      static_cast<const float*>(hd),
                    static_cast<const uint32_t*>(keys), static_cast<const float*>(skew),
                    static_cast<const int*>(slot),      static_cast<const float*>(params),
                    static_cast<float*>(moments)},
      m, d, flags);
  const Sweep w{nullptr, B, delta, B_new, static_cast<float*>(gram_part),
                static_cast<float*>(cross_part), static_cast<float*>(a_part), nullptr, m, d,
                nb, runs};
  return run<false, true>(dtype, w, gram, cross, a_inc, nullptr, ga, device, stream);
}
