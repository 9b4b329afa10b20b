// Batcher's odd-even merge sort on M wires, unrolled at compile time into
// register names, and its compare-exchanges for f32 and for packed bf16
// pairs.  csrc/sorted_reduce.cu sorts each column of its register path
// (m <= 32) with it.
//
// The network is built on P = the next power of two >= M, keeping only the
// comparators whose upper wire is below M.  That is exact: every comparator
// of Batcher's network is ascending (min to the lower wire), so wires at or
// past M act as +Inf pads that no comparator moves.  At M = 32 it has 191
// comparators, against the 496 of the odd-even transposition network the
// Pallas kernel sorts with (M(M−1)/2); the sorted sequence is the same, so
// are the order statistics.  tests/test_torch_sortnet.py writes the same
// loop in Python (batcher_network), holds it to the 0-1 principle and to the
// JAX kernels, and on a card holds rt_sort_network (sorted_reduce.cu) to it.
#pragma once

#include <stdint.h>

#include <utility>

namespace sortnet {

struct Comparator {
  int lo, hi;
};

// Batcher's network on m wires, walked in its order: the t-th comparator
// (lo < hi) for 0 <= t < its size, else {size, -1}.  The four loops are
// the iterative form of the odd-even merge sort: merges of width 2p, each
// as compare-exchanges at distance k = p, p/2, ..., 1 inside one merge.
__host__ __device__ constexpr Comparator batcher(int m, int t) {
  int n = 0;
  for (int p = 1; p < m; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j + k < m; j += 2 * k)
        for (int i = 0; i < k && i + j + k < m; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (n == t) return {i + j, i + j + k};
            ++n;
          }
  return {n, -1};
}

__host__ __device__ constexpr int batcher_size(int m) { return batcher(m, -1).lo; }

// One instruction each (sm_80+): NaN when either input is NaN, as
// jnp.minimum/jnp.maximum.  The NaN tests and selects written out in C took
// ~3 instructions a side and left the network bound by instruction issue.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void compare_exchange(float& a, float& b) {
  const float lo = min_nan(a, b);
  b = max_nan(a, b);
  a = lo;
}

// Two bf16 columns in one 32-bit word (the lower column in the low half),
// compared lane by lane: one min.NaN.bf16x2 and one max.NaN.bf16x2 order
// both columns' pair.  bf16 order is f32 order of the exact upcasts.
__device__ __forceinline__ void compare_exchange(uint32_t& a, uint32_t& b) {
  uint32_t lo, hi;
  asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(lo) : "r"(a), "r"(b));
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(hi) : "r"(a), "r"(b));
  a = lo;
  b = hi;
}

// The wires of each comparator are template arguments, so the front end
// evaluates the network and v's indices are constants: v stays in
// registers (the build's -Xptxas -v shows no stack and no spill).
template <int LO, int HI, typename V>
__device__ __forceinline__ void compare_exchange_at(V* v) {
  compare_exchange(v[LO], v[HI]);
}

template <int M, typename V, int... T>
__device__ __forceinline__ void sort_unrolled(V* v, std::integer_sequence<int, T...>) {
  (compare_exchange_at<batcher(M, T).lo, batcher(M, T).hi>(v), ...);
}

// Sorts v[0 .. M−1] ascending.  A NaN on any wire turns every wire to NaN:
// a comparator that meets one outputs NaN on both wires, and every input of
// a sorting network reaches every output.
template <int M, typename V>
__device__ __forceinline__ void sort(V* v) {
  sort_unrolled<M>(v, std::make_integer_sequence<int, batcher_size(M)>{});
}

}  // namespace sortnet
