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
//
// The run axis (entry rt_filtered_mean_runs): the R ≤ 65535 runs of a
// campaign group in one launch, x (R, m, d), w (R, m), ξ (R, d); grid y is
// the run, and each run's ξ is the one-run launch's bits.
//
// gen_xi (entries rt_gen_xi and, with grid y over a campaign group's runs,
// rt_gen_xi_runs) replaces fused_guard.py's gen_xi_pallas (body
// _gen_xi_kernel): the same loop over rows in order, with each row
// generated (gen_rows.cuh) rather than loaded, and two accumulators:
//   ξ   = Σᵢ w_xi[i]·round_S(rowᵢ)   (S the statistics type, f32 or bf16:
//         what the materialising guard's filtered mean reads),
//   byz = Σᵢ w_byz[i]·rowᵢ           (the raw f32 rows: the adversary's
//         feedback sum).
// ξ is fmaf(w, v, acc) over i = 0 .. m−1 as above, so on the same rounded
// rows it equals rt_filtered_mean with denom = 1 bit for bit.  byz sums
// each chunk of 128 rows in order and adds the chunks' sums in order: its
// rows (ALIE's μ − zσ on a quarter of the fleet) share a sign, and one
// f32 chain over 12288 of them would drift by ~2e-5.  It reads
// only the (d,) vectors and writes 2·d floats; what bounds it is
// threefry's ~80 integer operations per generated element (m·d of them,
// ~0.15 ms at m = 32, d = 2^20 at 64 per clock per SM).  Each thread loads
// its columns' data once and reuses it over the m rows, whose constants
// it stages in shared memory 128 rows at a time (any m up to MAX_WORKERS).

#include "gen_rows.cuh"

namespace {

constexpr int NT = 256;
constexpr int64_t MAX_RUNS = 65535;  // the run axis is grid y

// RUNS: grid y is the run, and run r's x, w and ξ lie r strides past the
// first run's; a one-run launch keeps the kernel without the offsets.
template <typename T, bool VEC, bool SAN, bool RUNS>
__global__ void __launch_bounds__(NT)
filtered_mean_kernel(const T* __restrict__ x, const float* __restrict__ w, float denom,
                     float* __restrict__ out, int64_t m, int64_t d) {
  extern __shared__ float sw[];
  if constexpr (RUNS) {
    const int64_t run = blockIdx.y;
    x += run * m * d;
    w += run * m;
    out += run * d;
  }
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

template <typename T, bool SAN, bool RUNS>
cudaError_t launch_one(const void* x, const float* w, float denom, float* out, int64_t m,
                       int64_t d, int64_t runs, cudaStream_t stream) {
  const int64_t n4 = (d + 3) / 4;
  const int64_t blocks = (n4 + NT - 1) / NT < (1 << 20) ? (n4 + NT - 1) / NT : (1 << 20);
  // every run's row starts share the first run's alignment when d % 4 == 0
  const bool vec = d % 4 == 0 && rt::aligned(x, 4 * sizeof(T)) && rt::aligned(out, 16);
  const size_t smem = (size_t)m * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const dim3 grid((unsigned)blocks, (unsigned)runs);
  if (vec)
    filtered_mean_kernel<T, true, SAN, RUNS><<<grid, NT, smem, stream>>>(xt, w, denom, out, m,
                                                                         d);
  else
    filtered_mean_kernel<T, false, SAN, RUNS><<<grid, NT, smem, stream>>>(xt, w, denom, out, m,
                                                                          d);
  return cudaGetLastError();
}

template <typename T, bool SAN>
cudaError_t launch(const void* x, const float* w, float denom, float* out, int64_t m,
                   int64_t d, int64_t runs, cudaStream_t stream) {
  return runs > 1 ? launch_one<T, SAN, true>(x, w, denom, out, m, d, runs, stream)
                  : launch_one<T, SAN, false>(x, w, denom, out, m, d, runs, stream);
}

template <bool SAN>
int run(int64_t dtype, const void* x, const void* w, float denom, void* out, int64_t m,
        int64_t d, int64_t runs, int64_t device, void* stream) {
  if (m < 1 || m > rt::MAX_WORKERS || d < 1 || runs < 1 || runs > MAX_RUNS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (dtype == 0) return (int)launch<float, SAN>(x, wf, denom, of, m, d, runs, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16, SAN>(x, wf, denom, of, m, d, runs, s);
  return (int)cudaErrorInvalidValue;
}

template <typename S>
__global__ void __launch_bounds__(NT)
gen_xi_kernel(const float* __restrict__ w_xi, const float* __restrict__ w_byz,
              float* __restrict__ xi, float* __restrict__ byz, rt::gen::Args ga, int64_t m,
              int64_t d) {
  // grid y is the run: run r's weights, outputs and generator operands lie
  // r strides past the first run's (a one-run launch has one)
  if (blockIdx.y) {
    const int64_t run = blockIdx.y;
    ga = ga.at_run(run);
    w_xi += run * m;
    w_byz += run * m;
    xi += run * d;
    byz += run * d;
  }
  constexpr int CH = rt::gen::ROW_CHUNK;
  __shared__ float sx[CH], sb[CH];
  __shared__ rt::gen::Row srow[CH];
  const float ns = ga.params[rt::gen::P_NSCALE], tgnrm = ga.params[rt::gen::P_TGNRM];
  const int64_t n4 = (d + 3) / 4;
  // the block's threads walk their columns in step, so each chunk of
  // worker constants is staged block-wide
  for (int64_t q0 = (int64_t)blockIdx.x * NT; q0 < n4; q0 += (int64_t)gridDim.x * NT) {
    const int64_t q = q0 + threadIdx.x;
    const bool on = q < n4;
    const int64_t c = 4 * q;
    rt::gen::Col col[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) col[k] = rt::gen::load_col(ga, c + k < d ? c + k : d - 1);
    float ax[4] = {0.f, 0.f, 0.f, 0.f}, ab[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t i0 = 0; i0 < m; i0 += CH) {
      const int len = (int)(m - i0 < CH ? m - i0 : CH);
      __syncthreads();  // every thread is done with the last chunk
      for (int i = threadIdx.x; i < len; i += NT) {
        sx[i] = w_xi[i0 + i];
        sb[i] = w_byz[i0 + i];
        srow[i] = rt::gen::load_row(ga, i0 + i);
      }
      __syncthreads();
      if (!on) continue;
      // byz: this chunk's sum, added to the total after it (short f32
      // chains at any m; at m <= CH the plain row-order sum)
      float cb[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < len; ++i) {
        const float wx = sx[i], wb = sb[i];
        float v[1][4];
        rt::gen::values_at<1, 4>(&srow[i], col, ns, tgnrm, ga.moments, c, d, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ax[k] = fmaf(wx, rt::gen::round_through(v[0][k], S()), ax[k]);
          cb[k] = fmaf(wb, v[0][k], cb[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) ab[k] = __fadd_rn(ab[k], cb[k]);
    }
    if (on) {
      rt::store4<float, false>(xi, c, d, ax);
      rt::store4<float, false>(byz, c, d, ab);
    }
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x only; w and out are f32).  m ≤ MAX_WORKERS
// (the weights fit the default 48 KB of shared memory).  Returns 0 or the CUDA
// error of the launch.
extern "C" int rt_filtered_mean(int64_t dtype, const void* x, const void* w, float denom,
                                void* out, int64_t m, int64_t d, int64_t device,
                                void* stream) {
  return run<false>(dtype, x, w, denom, out, m, d, 1, device, stream);
}

// The sanitizing variant, with the same arguments.
extern "C" int rt_filtered_mean_sanitize(int64_t dtype, const void* x, const void* w,
                                         float denom, void* out, int64_t m, int64_t d,
                                         int64_t device, void* stream) {
  return run<true>(dtype, x, w, denom, out, m, d, 1, device, stream);
}

// The run axis: x (runs, m, d), w (runs, m), out (runs, d), one launch,
// 1 <= runs <= 65535; sanitize selects the sanitizing variant.  runs = 1
// is the entries above.
extern "C" int rt_filtered_mean_runs(int64_t dtype, int64_t runs, int64_t sanitize,
                                     const void* x, const void* w, float denom, void* out,
                                     int64_t m, int64_t d, int64_t device, void* stream) {
  if (sanitize) return run<true>(dtype, x, w, denom, out, m, d, runs, device, stream);
  return run<false>(dtype, x, w, denom, out, m, d, runs, device, stream);
}

// gen_xi: dtype is the statistics type ξ's rows round through (0 = f32,
// 1 = bf16); w_xi, w_byz (m,) f32; xi, byz (d,) f32 outputs; then the
// generator's operands as for rt_fused_guard_gen (moments: 2·d floats).
// m ≤ MAX_WORKERS.  Unless moments_ready, launches the moments kernel (a
// no-op unless an ALIE id is in play); with moments_ready the buffer holds
// what rt_fused_guard_gen wrote there for the same operands, and the step
// runs one moments pass, not two.  Then the sums.  Returns 0 or the first
// CUDA error.
namespace {

int gen_xi_run(int64_t dtype, int64_t runs, const void* w_xi, const void* w_byz, void* xi,
               void* byz, const rt::gen::Args& ga, int64_t moments_ready, int64_t m, int64_t d,
               int64_t device, void* stream) {
  if (m < 1 || m > rt::MAX_WORKERS || d < 1 || runs < 1 || runs > MAX_RUNS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!moments_ready) {
    err = rt::gen::launch_moments(ga, m, d, s, runs);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n4 = (d + 3) / 4;
  const int64_t blocks = (n4 + NT - 1) / NT < (1 << 20) ? (n4 + NT - 1) / NT : (1 << 20);
  const dim3 grid((unsigned)blocks, (unsigned)runs);
  const float* wx = static_cast<const float*>(w_xi);
  const float* wb = static_cast<const float*>(w_byz);
  float* ox = static_cast<float*>(xi);
  float* ob = static_cast<float*>(byz);
  if (dtype == 0)
    gen_xi_kernel<float><<<grid, NT, 0, s>>>(wx, wb, ox, ob, ga, m, d);
  else if (dtype == 1)
    gen_xi_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(wx, wb, ox, ob, ga, m, d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_gen_xi(int64_t dtype, const void* w_xi, const void* w_byz, void* xi,
                         void* byz, const void* x, const void* h, const void* xs,
                         const void* hd, const void* keys, const void* skew, const void* slot,
                         const void* params, void* moments, int64_t moments_ready, int64_t m,
                         int64_t d, int64_t device, void* stream) {
  const rt::gen::Args ga{static_cast<const float*>(x),        static_cast<const float*>(h),
                         static_cast<const float*>(xs),       static_cast<const float*>(hd),
                         static_cast<const uint32_t*>(keys),  static_cast<const float*>(skew),
                         static_cast<const int*>(slot),       static_cast<const float*>(params),
                         static_cast<float*>(moments)};
  return gen_xi_run(dtype, 1, w_xi, w_byz, xi, byz, ga, moments_ready, m, d, device, stream);
}

// gen_xi over a run axis, 1 <= runs <= 65535 (grid y): w_xi, w_byz
// (runs, m); xi, byz (runs, d); keys (runs, m, 2), skew and slot (runs, m),
// params (runs, 12), moments (runs, 2, d); x, h, x*, het_dir each
// (runs, d), or (d,) shared by the runs when its bit of `shared` is set
// (bit 0 x, 1 h, 2 x*, 3 het_dir), as rt_fused_guard_gen_runs takes them.
// moments_ready: the buffer holds what rt_fused_guard_gen_runs wrote
// there for the same operands.  Each run's ξ and byz are the bits of its
// one-run rt_gen_xi.
extern "C" int rt_gen_xi_runs(int64_t dtype, int64_t runs, int64_t shared, const void* w_xi,
                              const void* w_byz, void* xi, void* byz, const void* x,
                              const void* h, const void* xs, const void* hd, const void* keys,
                              const void* skew, const void* slot, const void* params,
                              void* moments, int64_t moments_ready, int64_t m, int64_t d,
                              int64_t device, void* stream) {
  const bool flags[4] = {(shared & 1) != 0, (shared & 2) != 0, (shared & 4) != 0,
                         (shared & 8) != 0};
  const rt::gen::Args ga = rt::gen::with_run_strides(
      rt::gen::Args{static_cast<const float*>(x),       static_cast<const float*>(h),
                    static_cast<const float*>(xs),      static_cast<const float*>(hd),
                    static_cast<const uint32_t*>(keys), static_cast<const float*>(skew),
                    static_cast<const int*>(slot),      static_cast<const float*>(params),
                    static_cast<float*>(moments)},
      m, d, flags);
  return gen_xi_run(dtype, runs, w_xi, w_byz, xi, byz, ga, moments_ready, m, d, device,
                    stream);
}
