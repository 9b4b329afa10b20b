// The guard sweep at bf16 (included by fused_guard.cu, which holds the
// f32 sweep, the reductions and the entry points; its header comment
// states what the sweep computes).
//
// guard_bf16_kernel<VEC, SAN, GEN>: one tensor-core sweep for the plain,
// sanitizing and generating variants at bf16.  Raw bf16 tiles of B (and
// of g, where g is read) reach a STAGES-deep shared-memory ring by
// cp.async with no upcast; in GEN, 16 generator warps write each tile of
// g, rounded once to bf16, into the same ring slot that the plain sweep
// fills by copy, running ahead of the consumers by up to STAGES tiles,
// each warp on its own (a pair of mbarriers per slot).  Every variant
// then runs the same consumer code over the ring: ldmatrix fragments into
// mma.sync m16n8k16 (bf16 in, f32 accumulators; a bf16×bf16 product is
// exact in f32, so only the order of the f32 sums moves), and for
// diagonal blocks B_new = B + g (one f32 add rounded once to bf16) and
// a_inc = g·δ (an f32 FMA chain).  So given the same rows the three
// variants give the same bits.  Each of the 8
// consumer warps owns one 16×8 block of gram_g and the same block of cross
// over all of d, so no two warps sum into one output.  A register
// accumulator takes FLUSH tiles (16 mma.sync), joins a middle sum that
// takes FLUSH2 of them, which joins the running sum: short f32 chains at
// any d (a block walks ~2,000 tiles at d = 2^26).  SAN first zeroes each
// non-finite entry of g in the ring slot, in place, and counts it
// (diagonal blocks read each entry of their rows once), then runs the same
// consumer.  The plain and SAN sweeps are bound by bytes; GEN by the
// generator's integer operations.
//
// The generator warps give each warp one set of rows over consecutive
// columns, so a row's attack is one branch for the whole warp, and
// compute a thread's honest values for all its rows and columns before
// any attack (gen::values_at), so the compiler interleaves those threefry
// chains.

#pragma once

#include "gen_rows.cuh"

namespace rt {
namespace guard {

constexpr int MT = 32;        // workers per output tile

// The 16 lanes that hold pieces of one row's sum add them in a fixed tree;
// lane 0 of the 16 returns the total.
template <typename V>
__device__ __forceinline__ V sum16(V v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------- bf16

namespace bf {
constexpr int TK = 128;              // columns of d per tile
constexpr int ROW = 2 * TK;          // bytes of one row of a tile
constexpr int PITCH = ROW + 16;      // padded shared-memory row: conflict-free ldmatrix
constexpr int OP = MT * PITCH;       // bytes of one 32-row operand tile
constexpr int CHUNKS = ROW / 16;     // 16-byte chunks of a row
constexpr int STAGES = 4;            // tiles in the ring
constexpr int NC = 256;              // consumer threads (8 warps)
constexpr int NG = 512;              // generator threads (GEN)
constexpr int RG = MT * (TK / 2) / NG;  // rows of a row tile a generator takes (4)
constexpr int FLUSH = 2;             // tiles a register chain takes (16 mma.sync)
constexpr int FLUSH2 = 32;           // register chains a middle sum takes
// a stage: g rows I, B rows I, [g rows J when the grid has off-diagonal
// blocks], then the tile's δ
__host__ __device__ constexpr int stage_bytes(int ops) { return ops * OP + ROW; }
}  // namespace bf

// A barrier over the GEN sweep's consumer threads (the first bf::NC) alone.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(bf::NC) : "memory");
}

// Columns col .. col + 7 of one bf16 row (row_ok: the row exists) into 16
// bytes of shared memory, columns at or past d as 0.  VEC: d % 8 == 0 and
// the row start is 16-byte aligned, so the 8 are all in range or all out.
template <bool VEC>
__device__ __forceinline__ void load_chunk(unsigned char* dst, const __nv_bfloat16* x,
                                           const __nv_bfloat16* row, bool row_ok, int64_t col,
                                           int64_t d) {
  if constexpr (VEC) {
    const bool in = row_ok && col < d;
    cp_async16(dst, in ? (const void*)(row + col) : (const void*)x, in ? 16 : 0);
  } else {
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(row);
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t lo = row_ok && col + 2 * h < d ? bits[col + 2 * h] : 0u;
      const uint32_t hi = row_ok && col + 2 * h + 1 < d ? bits[col + 2 * h + 1] : 0u;
      w[h] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Rows row0 .. row0 + 31 of x, columns col0 .. col0 + TK − 1, into one
// operand tile of the ring, by the NC consumer threads.
template <bool VEC>
__device__ __forceinline__ void load_rows(unsigned char* dst, const __nv_bfloat16* x,
                                          int64_t row0, int64_t col0, int64_t m, int64_t d,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < MT * bf::CHUNKS / bf::NC; ++i) {
    const int c = tid + i * bf::NC;
    const int r = c / bf::CHUNKS, q = c % bf::CHUNKS;
    const int64_t row = row0 + r;
    const bool ok = row < m;
    load_chunk<VEC>(dst + r * bf::PITCH + 16 * q, x, x + (ok ? row : 0) * d, ok, col0 + 8 * q, d);
  }
}

// A pair of bf16 with each NaN or ±Inf half replaced by +0 (exponent bits
// all ones: the f32 test of rt::nonfinite on the upper half-word).
__device__ __forceinline__ unsigned zero_nonfinite_bf16x2(unsigned v) {
  const unsigned lo = (v & 0x00007f80u) == 0x00007f80u ? 0u : 0x0000ffffu;
  const unsigned hi = (v & 0x7f800000u) == 0x7f800000u ? 0u : 0xffff0000u;
  return v & (lo | hi);
}

__device__ __forceinline__ void unpack8(uint4 w, float f[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    f[2 * h] = __uint_as_float(u[h] << 16);
    f[2 * h + 1] = __uint_as_float(u[h] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);  // round-to-nearest-even, a low
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <bool VEC, bool SAN, bool GEN>
__global__ void __launch_bounds__(GEN ? bf::NC + bf::NG : bf::NC, GEN ? 1 : 2)
guard_bf16_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ B,
                  const __nv_bfloat16* __restrict__ delta, __nv_bfloat16* __restrict__ B_new,
                  float* __restrict__ gram_part, float* __restrict__ cross_part,
                  float* __restrict__ a_part, int* __restrict__ nf_part, int64_t m, int64_t d,
                  int64_t mp, int64_t nb, int ops, gen::Args ga) {
  static_assert(!(SAN && GEN), "the generating sweep has no sanitizing variant");
  // grid x is run · nb + split (fused_guard.cu's run axis): run r's
  // operands, partials and outputs lie r strides past the first run's
  const int64_t run = blockIdx.x / nb, split = blockIdx.x % nb;
  if (run) {
    if constexpr (GEN) ga = ga.at_run(run);  // the generator's operands of run r
    else g += run * m * d;
    B += run * m * d;
    B_new += run * m * d;
    delta += run * d;
    gram_part += run * nb * mp * mp;
    cross_part += run * nb * mp * mp;
    a_part += run * nb * mp;
    if constexpr (SAN) nf_part += run * nb * mp;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ gen::Row srow[GEN ? 2 * MT : 1];
  // GEN: per ring slot, "g written" (NG arrivals) then "slot read" (NC)
  __shared__ __align__(8) uint64_t bars[GEN ? 2 * bf::STAGES : 1];
  const int tid = threadIdx.x;
  const int ti = blockIdx.y, tj = blockIdx.z;
  const bool diag = ti == tj;  // this block also writes B_new, a_inc (and nf) of tile ti
  const int64_t n_tiles = (d + bf::TK - 1) / bf::TK;
  const int64_t cnt = split < n_tiles ? (n_tiles - 1 - split) / nb + 1 : 0;
  const int sbytes = bf::stage_bytes(ops);
  auto stage = [&](int64_t k) { return smem + (int)(k % bf::STAGES) * sbytes; };
  const bool consumer = !GEN || tid < bf::NC;

  float ns = 0.f, tgnrm = 0.f;
  if constexpr (GEN) {
    for (int r = tid; r < 2 * MT; r += blockDim.x) {
      const int64_t i = (int64_t)(r < MT ? ti : tj) * MT + r % MT;
      srow[r] = i < m ? gen::load_row(ga, i) : gen::padding_row();
    }
    ns = ga.params[gen::P_NSCALE];
    tgnrm = ga.params[gen::P_TGNRM];
    if (tid == 0)
      for (int q = 0; q < bf::STAGES; ++q) {
        mbar_init(&bars[q], bf::NG);
        mbar_init(&bars[bf::STAGES + q], bf::NC);
      }
    __syncthreads();
  }

  // GEN: generator thread gt takes columns 2·(gt % 64), +1 of the tile and
  // rows RG·(gt / 64) .. + RG − 1 of each row tile, so a warp shares its
  // rows (the row's attack is one branch for the warp); values rounded once
  // to bf16
  auto generate = [&](unsigned char* st, int64_t col0, int gt) {
    const int gp = gt % (bf::TK / 2), gr = gt / (bf::TK / 2) * bf::RG;
    const int64_t c = col0 + 2 * gp;
    gen::Col col[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) col[e] = gen::load_col(ga, c + e < d ? c + e : d - 1);
    for (int w = 0; w < (diag ? 1 : 2); ++w) {
      unsigned char* base = st + (w ? 2 * bf::OP : 0) + 4 * gp;
      float v[bf::RG][2];
      gen::values_at<bf::RG, 2>(&srow[w * MT + gr], col, ns, tgnrm, ga.moments, c, d, v);
#pragma unroll
      for (int u = 0; u < bf::RG; ++u)
        *reinterpret_cast<uint32_t*>(base + (gr + u) * bf::PITCH) = pack2(v[u][0], v[u][1]);
    }
  };
  auto produce = [&](int64_t k) {
    unsigned char* st = stage(k);
    const int64_t col0 = (split + k * nb) * bf::TK;
    if (consumer) {
      if constexpr (!GEN) {
        load_rows<VEC>(st, g, (int64_t)ti * MT, col0, m, d, tid);
        if (!diag) load_rows<VEC>(st + 2 * bf::OP, g, (int64_t)tj * MT, col0, m, d, tid);
      }
      load_rows<VEC>(st + bf::OP, B, (int64_t)ti * MT, col0, m, d, tid);
      if (diag && tid < bf::CHUNKS)
        load_chunk<VEC>(st + ops * bf::OP + 16 * tid, delta, delta, true, col0 + 8 * tid, d);
    } else if constexpr (GEN) {
      generate(st, col0, tid - bf::NC);
    }
  };

  // consumer warp w owns rows 16·mi .. 16·mi + 15 and columns 8·n .. 8·n + 7
  // of both Grams
  const int lane = tid & 31, warp = tid >> 5;
  const int mi = warp >> 2, n = warp & 3;
  // ldmatrix.x4 of an A operand: lane l gives row (l % 8) + 8·((l / 8) % 2),
  // k offset 8·(l / 16); of two B operands (k steps s, s + 1): row l % 8 of
  // the column block, k offset 8·(l / 8)
  const int a_off = (16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1)) * bf::PITCH + 16 * (lane >> 4);
  const int b_off = (8 * n + (lane & 7)) * bf::PITCH + 16 * (lane >> 3);
  float acc_g[4] = {0.f, 0.f, 0.f, 0.f}, acc_c[4] = {0.f, 0.f, 0.f, 0.f};
  float mid_g[4] = {0.f, 0.f, 0.f, 0.f}, mid_c[4] = {0.f, 0.f, 0.f, 0.f};
  float run_g[4] = {0.f, 0.f, 0.f, 0.f}, run_c[4] = {0.f, 0.f, 0.f, 0.f};
  float a_acc[2] = {0.f, 0.f};
  int nf_acc[2] = {0, 0};  // SAN: non-finite entries of this thread's rows of tile I

  // the Grams of one tile on the tensor cores
  auto products = [&](const unsigned char* st) {
    const unsigned char* sGI = st;
    const unsigned char* sBI = st + bf::OP;
    const unsigned char* sGJ = diag ? st : st + 2 * bf::OP;
#pragma unroll
    for (int s = 0; s < bf::TK / 16; s += 2) {
      unsigned bq[4];
      ldmatrix_x4(bq, sGJ + b_off + 32 * s);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned ag[4], ab[4];
        ldmatrix_x4(ag, sGI + a_off + 32 * (s + h));
        ldmatrix_x4(ab, sBI + a_off + 32 * (s + h));
        mma_bf16(acc_g, ag, bq[2 * h], bq[2 * h + 1]);
        mma_bf16(acc_c, ab, bq[2 * h], bq[2 * h + 1]);
      }
    }
  };
  // Thread t's chunks of one tile: columns 8·(t % 16) .. + 7 of rows t / 16
  // and t / 16 + 16.  SAN first zeroes the non-finite entries of g there, in
  // the ring, counting those of rows I in diagonal blocks (off-diagonal
  // blocks zero both row tiles of g and count nothing).  Diagonal blocks
  // then write B_new = B + g and add g·δ to a_inc.
  auto rows_pass = [&](unsigned char* st, int64_t k) {
    const int q = tid % bf::CHUNKS;
    if constexpr (SAN) {
      for (int w = 0; w < (diag ? 1 : 2); ++w)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint4* chunk = reinterpret_cast<uint4*>(st + (w ? 2 * bf::OP : 0) +
                                                  (tid / bf::CHUNKS + 16 * p) * bf::PITCH +
                                                  16 * q);
          const uint4 raw = *chunk;
          const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t z[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            z[h] = zero_nonfinite_bf16x2(u[h]);
            if (diag)
              nf_acc[p] += ((u[h] & 0x00007f80u) == 0x00007f80u) +
                           ((u[h] & 0x7f800000u) == 0x7f800000u);
          }
          if ((z[0] ^ u[0]) | (z[1] ^ u[1]) | (z[2] ^ u[2]) | (z[3] ^ u[3]))
            *chunk = make_uint4(z[0], z[1], z[2], z[3]);
        }
    }
    if (!diag) return;
    const unsigned char* sD = st + ops * bf::OP;
    const int64_t c = (split + k * nb) * bf::TK + 8 * q;
    float dl[8];
    unpack8(*reinterpret_cast<const uint4*>(sD + 16 * q), dl);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int r = tid / bf::CHUNKS + 16 * p;
      float gv[8], bv[8], sv[8];
      unpack8(*reinterpret_cast<const uint4*>(st + r * bf::PITCH + 16 * q), gv);
      unpack8(*reinterpret_cast<const uint4*>(st + bf::OP + r * bf::PITCH + 16 * q), bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sv[e] = bv[e] + gv[e];  // f32 add, rounded once by the store
        a_acc[p] = fmaf(gv[e], dl[e], a_acc[p]);
      }
      const int64_t row = (int64_t)ti * MT + r;
      if (row < m) {
        __nv_bfloat16* dst = B_new + row * d;
        if constexpr (VEC) {
          if (c < d)
            *reinterpret_cast<uint4*>(dst + c) =
                make_uint4(pack2(sv[0], sv[1]), pack2(sv[2], sv[3]), pack2(sv[4], sv[5]),
                           pack2(sv[6], sv[7]));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c + e < d) dst[c + e] = __float2bfloat16_rn(sv[e]);
        }
      }
    }
  };

  // the consumer of tile k, the same code for every variant
  auto consume = [&](int64_t k) {
    unsigned char* st = stage(k);
    if constexpr (SAN) {
      rows_pass(st, k);
      __syncthreads();  // g is sanitized before any fragment is read
      products(st);
    } else {
      products(st);
      rows_pass(st, k);
    }
    if ((k + 1) % bf::FLUSH == 0) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        mid_g[t] += acc_g[t];
        mid_c[t] += acc_c[t];
        acc_g[t] = acc_c[t] = 0.f;
      }
      if ((k + 1) % (bf::FLUSH * bf::FLUSH2) == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          run_g[t] += mid_g[t];
          run_c[t] += mid_c[t];
          mid_g[t] = mid_c[t] = 0.f;
        }
      }
    }
  };

  if constexpr (GEN) {
    // the generators run up to STAGES tiles ahead of the consumers, each
    // warp on its own: a slot's g is written once the consumers have
    // released the slot's last tile
    if (!consumer) {
      for (int64_t it = 0; it < cnt; ++it) {
        const int q = (int)(it % bf::STAGES);
        if (it >= bf::STAGES)
          mbar_wait(&bars[bf::STAGES + q], (unsigned)((it / bf::STAGES) & 1) ^ 1u);
        generate(stage(it), (split + it * nb) * bf::TK, tid - bf::NC);
        mbar_arrive(&bars[q]);
      }
      return;
    }
    for (int64_t it = 0; it < cnt + bf::STAGES - 1; ++it) {
      const int64_t k = it - (bf::STAGES - 1);
      if (k >= 0) {
        cp_async_wait<bf::STAGES - 2>();  // tile k's B has landed (this thread's copies)
        consumers_sync();                 // ... every consumer's; tile k − 1 is consumed
      }
      if (it < cnt) produce(it);
      cp_async_commit();
      if (k >= 0) {
        const int q = (int)(k % bf::STAGES);
        mbar_wait(&bars[q], (unsigned)((k / bf::STAGES) & 1));  // tile k's g is written
        consume(k);
        mbar_arrive(&bars[bf::STAGES + q]);
      }
    }
  } else {
    // iteration it fills the ring with tile it and consumes tile
    // it − (STAGES − 1)
    for (int64_t it = 0; it < cnt + bf::STAGES - 1; ++it) {
      const int64_t k = it - (bf::STAGES - 1);
      if (k >= 0) {
        cp_async_wait<bf::STAGES - 2>();  // tile k has landed (this thread's copies)
        __syncthreads();                  // ... everyone's, and tile k − 1 is consumed
      }
      if (it < cnt) produce(it);
      cp_async_commit();
      if (k >= 0) consume(k);
    }
  }
  cp_async_wait<0>();
  if (!consumer) return;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    run_g[t] += mid_g[t] + acc_g[t];
    run_c[t] += mid_c[t] + acc_c[t];
  }

  // each output has one owner: write the partials straight from the
  // accumulator fragments (c[t]: row lane / 4 + 8·(t / 2), column
  // 2·(lane % 4) + t % 2 of the 16×8 block)
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int64_t gi = (int64_t)ti * MT + 16 * mi + (lane >> 2) + 8 * (t >> 1);
    const int64_t gj = (int64_t)tj * MT + 8 * n + 2 * (lane & 3) + (t & 1);
    gram_part[(split * mp + gi) * mp + gj] = run_g[t];
    cross_part[(split * mp + gi) * mp + gj] = run_c[t];
  }
  if (diag) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int64_t o = split * mp + (int64_t)ti * MT + tid / bf::CHUNKS + 16 * p;
      const float a = sum16(a_acc[p]);
      if (tid % bf::CHUNKS == 0) a_part[o] = a;
      if constexpr (SAN) {
        const int c = sum16(nf_acc[p]);
        if (tid % bf::CHUNKS == 0) nf_part[o] = c;
      }
    }
  }
}

}  // namespace guard
}  // namespace rt
