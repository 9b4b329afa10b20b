// The in-kernel gradient generator shared by the generating kernels (the
// generating sweeps of fused_guard.cu and guard_sweep.cuh, filtered_mean.cu's
// gen_xi): each worker's attacked gradient at coordinate j, rebuilt from
// (worker key, j) instead of read from an (m, d) batch.
//
// Replaces: repro/kernels/fused_guard.py, _gen_strip, and the row math of
// repro/kernels/gradgen.py, gen_worker_rows; plain version:
// repro_torch/kernels/gradgen.py, gen_worker_rows.  Per worker i and
// coordinate j:
//   t   = h_j·(x_j − x*_j)                       (the true gradient)
//   g   = t + ns·(2·((bits >> 9) + 0.5)·2⁻²³ − 1) with bits = word 0 of
//         threefry2x32(key_i, (0, j)), ns the noise scale
//   g  += skew_i·het_dir_j                       (when skew_i ≠ 0)
//   row = the attack of worker i's slot on g, t, ∇f/‖∇f‖ and the honest
//         column moments μ_j, σ_j (ALIE, ids 4 and 8)
//   out = row, or 0 for a padding row (slot −1) or j ≥ d.
// Every product and sum is written with __fmul_rn/__fadd_rn/__fsub_rn:
// nvcc contracts a*b + c into one FMA by default, and these intrinsics are
// never contracted, so each term rounds as the plain version's separate
// torch operations do and the rows equal it bit for bit (bar the moments,
// whose sums run in another order).

#pragma once

#include "common.cuh"

namespace rt {
namespace gen {

// slots of the (12,) f32 parameter vector (kernels/gradgen.py)
enum {
  P_ID_A, P_SF_A, P_Z_A, P_CONST_A, P_IPC_A,
  P_ID_B, P_SF_B, P_Z_B, P_CONST_B, P_IPC_B,
  P_TGNRM, P_NSCALE, NPARAMS
};

// The generator's operands: (d,) f32 coordinate data, (m,) worker data,
// the parameters, and the honest column moments (2·d floats, written by
// gen_moments_kernel; read only when an ALIE id is in play).
//
// The run axis (entries rt_*_gen_runs): run r's operands lie r run strides
// past the first run's.  The worker data, the parameters and the moments
// are each run's own; a (d,) vector may be each run's own (stride d) or
// shared by the runs (stride 0), so a shared x* or h is not copied R
// times.  One-run entries leave every stride 0.  Strides are in elements.
struct Args {
  const float* x;
  const float* h;
  const float* xs;
  const float* hd;
  const uint32_t* keys;  // (m, 2) words
  const float* skew;
  const int* slot;
  const float* params;
  float* moments;        // μ at [0, d), σ at [d, 2d)
  int64_t x_rs, h_rs, xs_rs, hd_rs;  // 0 or d
  int64_t keys_rs, row_rs, params_rs, moments_rs;  // 2·m, m, NPARAMS, 2·d

  // run r's operands (int64 offsets: R·m·d may pass 2^31)
  __host__ __device__ Args at_run(int64_t r) const {
    Args a = *this;
    a.x += r * x_rs;
    a.h += r * h_rs;
    a.xs += r * xs_rs;
    a.hd += r * hd_rs;
    a.keys += r * keys_rs;
    a.skew += r * row_rs;
    a.slot += r * row_rs;
    a.params += r * params_rs;
    a.moments += r * moments_rs;
    return a;
  }
};

// One worker's constants, resolved from its slot and the parameters.
struct Row {
  uint32_t k0, k1;
  float skew;
  int slot;
  float aid, sf, zf, cst, ipc;
};

__device__ __forceinline__ Row load_row(const Args& a, int64_t i) {
  Row r;
  r.k0 = a.keys[2 * i];
  r.k1 = a.keys[2 * i + 1];
  r.skew = a.skew[i];
  r.slot = a.slot[i];
  const int o = r.slot == 2 ? P_ID_B : P_ID_A;
  r.aid = a.params[o];
  r.sf = a.params[o + 1];
  r.zf = a.params[o + 2];
  r.cst = a.params[o + 3];
  r.ipc = a.params[o + 4];
  return r;
}

// True when a phase plays ALIE or alie_update, whose rows need μ and σ.
__device__ __forceinline__ bool needs_moments(const float* params) {
  const float a = params[P_ID_A], b = params[P_ID_B];
  return a == 4.f || a == 8.f || b == 4.f || b == 8.f;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define RT_TF_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;

// Word 0 of threefry2x32 (20 rounds) under key (k0, k1) on counter (0, j):
// the JAX package's noise_bits.
__device__ __forceinline__ uint32_t noise_bits(uint32_t k0, uint32_t k1, uint32_t j) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;      // 0 + k0
  uint32_t x1 = j + k1;
  RT_TF_ROUND(13) RT_TF_ROUND(15) RT_TF_ROUND(26) RT_TF_ROUND(6)
  x0 += k1; x1 += ks2 + 1u;
  RT_TF_ROUND(17) RT_TF_ROUND(29) RT_TF_ROUND(16) RT_TF_ROUND(24)
  x0 += ks2; x1 += k0 + 2u;
  RT_TF_ROUND(13) RT_TF_ROUND(15) RT_TF_ROUND(26) RT_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  RT_TF_ROUND(17) RT_TF_ROUND(29) RT_TF_ROUND(16) RT_TF_ROUND(24)
  x0 += k1; x1 += ks2 + 4u;
  RT_TF_ROUND(13) RT_TF_ROUND(15) RT_TF_ROUND(26) RT_TF_ROUND(6)
  return x0 + ks2;
}

#undef RT_TF_ROUND

// bits → f32 in (−1, 1): the 23-bit mantissa ladder, then centred.
__device__ __forceinline__ float centered_uniform(uint32_t bits) {
  const float u = __fmul_rn(__fadd_rn((float)(bits >> 9), 0.5f), 1.1920928955078125e-7f);
  return __fsub_rn(__fmul_rn(2.f, u), 1.f);
}

// The column's coordinate data: t = h·(x − x*) and het_dir.
struct Col {
  float t, hd;
};

__device__ __forceinline__ Col load_col(const Args& a, int64_t j) {
  Col c;
  c.t = __fmul_rn(__ldg(a.h + j), __fsub_rn(__ldg(a.x + j), __ldg(a.xs + j)));
  c.hd = __ldg(a.hd + j);
  return c;
}

// Worker (k0, k1, skew)'s honest gradient at coordinate j.
__device__ __forceinline__ float honest(uint32_t k0, uint32_t k1, float skew, const Col& c,
                                        float ns, int64_t j) {
  const float u = centered_uniform(noise_bits(k0, k1, (uint32_t)j));
  const float g = __fadd_rn(c.t, __fmul_rn(ns, u));
  return skew != 0.f ? __fadd_rn(g, __fmul_rn(skew, c.hd)) : g;  // a select, not a branch
}

// Worker r's outputs at the N coordinates j0 .. j0 + N − 1 (column data
// c[], clamped to d − 1 past the end) from its honest values g[]: its
// attack, the where-chain of gen_worker_rows (ids 0, 2 and any other fall
// through to g; gn = t/‖∇f‖; ALIE's ids 4 and 8 read the honest column
// moments μ, σ), decided once for the row (a warp whose threads share the
// row takes one branch), then 0 for a padding row (slot −1) or j ≥ d.
template <int N>
__device__ __forceinline__ void attack_row(const Row& r, const float* g, const Col* c,
                                           float tgnrm, const float* mom, int64_t j0,
                                           int64_t d, float* out) {
  const float a = r.aid;
  if (r.slot <= 0 || !(a == 1.f || a == 3.f || a == 4.f || a == 8.f || a == 5.f || a == 6.f)) {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = g[e];
  } else if (a == 1.f) {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = __fmul_rn(r.sf, g[e]);
  } else if (a == 3.f) {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = __fadd_rn(r.cst, 0.f);
  } else if (a == 4.f || a == 8.f) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int64_t j = j0 + e < d ? j0 + e : d - 1;
      const float zs = __fmul_rn(r.zf, mom[d + j]);
      out[e] = a == 4.f ? __fsub_rn(mom[j], zs) : __fadd_rn(mom[j], zs);
    }
  } else if (a == 5.f) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      out[e] = __fsub_rn(c[e].t, __fmul_rn(r.ipc, __fdiv_rn(c[e].t, tgnrm)));
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = __fadd_rn(c[e].t, r.cst);
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (r.slot < 0 || j0 + e >= d) out[e] = 0.f;
}

// Rows rows[0 .. R − 1] at the N coordinates j0 .. j0 + N − 1 (column
// data c[]): the values the plain version gives.  All R·N honest values
// come first, with no branch between them, so the compiler interleaves
// their threefry chains (one chain alone waits on each of its ~40
// dependent steps); then each row's attack.
template <int R, int N>
__device__ __forceinline__ void values_at(const Row* rows, const Col* c, float ns, float tgnrm,
                                          const float* mom, int64_t j0, int64_t d,
                                          float (*out)[N]) {
  float g[R][N];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e)
      g[i][e] = honest(rows[i].k0, rows[i].k1, rows[i].skew, c[e], ns, j0 + e);
#pragma unroll
  for (int i = 0; i < R; ++i) attack_row<N>(rows[i], g[i], c, tgnrm, mom, j0, d, out[i]);
}

// The constants of a row past m: a padding row, whose outputs are 0.
__device__ __forceinline__ Row padding_row() {
  Row r;
  r.k0 = r.k1 = 0u;
  r.skew = 0.f;
  r.slot = -1;
  r.aid = r.sf = r.zf = r.cst = r.ipc = 0.f;
  return r;
}

// v rounded once through T (round-to-nearest-even for bf16) and back.
__device__ __forceinline__ float round_through(float v, float) { return v; }
__device__ __forceinline__ float round_through(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Worker constants staged in shared memory at a time: the generating
// kernels walk the m rows in chunks of ROW_CHUNK, so any m up to
// MAX_WORKERS is taken with a fixed amount of shared memory.
constexpr int ROW_CHUNK = 128;

// The honest column moments of ALIE: μ_j = Σ g / n, σ_j = √(Σ (g − μ)² / n
// + 1e-12) over the n = max(#honest, 1) rows of slot 0, each row
// regenerated twice (two passes, no row kept).  Each sum runs in row order
// within a chunk of ROW_CHUNK rows, and the chunks' sums are added in
// order: at m <= ROW_CHUNK that is the plain row-order sum, and at
// m = 12288 no f32 chain is longer than 128 + 96 terms.  One thread per
// column; a block's threads walk their columns in step, so the chunks of
// worker constants can be staged block-wide.  The whole grid returns at
// once when no phase plays ids 4 or 8.  Launched before the generating
// sweep, on the same stream; gen_xi launches it again only when the caller
// does not hand it the sweep's moments.  Grid y is the run (Args::at_run);
// each run decides from its own parameters.
__global__ void __launch_bounds__(256)
gen_moments_kernel(Args a, int64_t m, int64_t d) {
  a = a.at_run(blockIdx.y);
  if (!needs_moments(a.params)) return;
  __shared__ uint32_t sk[2 * ROW_CHUNK];
  __shared__ float ss[ROW_CHUNK];
  __shared__ int sslot[ROW_CHUNK];
  // stages rows i0 .. i0 + len − 1, after every thread is done with the last chunk
  auto stage = [&](int64_t i0, int len) {
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      sk[2 * i] = a.keys[2 * (i0 + i)];
      sk[2 * i + 1] = a.keys[2 * (i0 + i) + 1];
      ss[i] = a.skew[i0 + i];
      sslot[i] = a.slot[i0 + i];
    }
    __syncthreads();
  };
  const float ns = a.params[P_NSCALE];
  for (int64_t j0 = (int64_t)blockIdx.x * blockDim.x; j0 < d;
       j0 += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = j0 + threadIdx.x;
    const bool on = j < d;
    const Col c = load_col(a, on ? j : d - 1);
    int n = 0;
    float s = 0.f;
    for (int64_t i0 = 0; i0 < m; i0 += ROW_CHUNK) {
      const int len = (int)(m - i0 < ROW_CHUNK ? m - i0 : ROW_CHUNK);
      stage(i0, len);
      float cs = 0.f;
      for (int i = 0; i < len; ++i)
        if (sslot[i] == 0) {
          ++n;
          if (on) cs = __fadd_rn(cs, honest(sk[2 * i], sk[2 * i + 1], ss[i], c, ns, j));
        }
      s = __fadd_rn(s, cs);
    }
    const float n_good = n > 0 ? (float)n : 1.f;
    const float mu = __fdiv_rn(s, n_good);
    float v = 0.f;
    for (int64_t i0 = 0; i0 < m; i0 += ROW_CHUNK) {
      const int len = (int)(m - i0 < ROW_CHUNK ? m - i0 : ROW_CHUNK);
      stage(i0, len);
      float cv = 0.f;
      if (on)
        for (int i = 0; i < len; ++i)
          if (sslot[i] == 0) {
            const float e = __fsub_rn(honest(sk[2 * i], sk[2 * i + 1], ss[i], c, ns, j), mu);
            cv = __fadd_rn(cv, __fmul_rn(e, e));
          }
      v = __fadd_rn(v, cv);
    }
    if (on) {
      a.moments[j] = mu;
      a.moments[d + j] = __fsqrt_rn(__fadd_rn(__fdiv_rn(v, n_good), 1e-12f));
    }
  }
}

// runs <= 65535 (grid y)
inline cudaError_t launch_moments(const Args& a, int64_t m, int64_t d, cudaStream_t s,
                                  int64_t runs = 1) {
  const int64_t blocks = (d + 255) / 256 < (1 << 20) ? (d + 255) / 256 : (1 << 20);
  gen_moments_kernel<<<dim3((unsigned)blocks, (unsigned)runs), 256, 0, s>>>(a, m, d);
  return cudaGetLastError();
}

// The run strides of a launch over `runs` runs with m workers and d
// coordinates; shared[q] tells whether (d,) vector q (x, h, x*, het_dir) is
// one for all runs.
inline Args with_run_strides(Args a, int64_t m, int64_t d, const bool shared[4]) {
  a.x_rs = shared[0] ? 0 : d;
  a.h_rs = shared[1] ? 0 : d;
  a.xs_rs = shared[2] ? 0 : d;
  a.hd_rs = shared[3] ? 0 : d;
  a.keys_rs = 2 * m;
  a.row_rs = m;
  a.params_rs = NPARAMS;
  a.moments_rs = 2 * d;
  return a;
}

}  // namespace gen
}  // namespace rt
