// The pair search of one Gaussian-mixture merge pass as bit masks, for the
// merge kernels (one CTA per particle, blockDim a multiple of 32).  The slot
// fields and the masks live in shared memory (the small forms, N <= 1024)
// or in the particle's part of a global workspace (the large forms); the
// functions take either, through generic pointers.
//
// Over the alive slots below hi (one past the highest alive slot):
//   gate_rows   G[j * W + w] bit b: slot k = 32 w + b < j is gated with j,
//               both alive.  A warp takes two rows j at a time, their
//               fields in registers, one lane per k (its fields loaded
//               once for both), one ballot per row and word: each gate is
//               evaluated once per pass.  A row with no bit set marks
//               its slot safe in A (bit j of A[j / 32], by atomicOr): it
//               has no gated partner below it, so it may absorb this pass
//               (the safe-absorber rule).
//   claim       slot j is claimed by the lowest set bit of G[j] & A: its
//               lowest safe gated partner (ops/gm.py:_merge_pass's
//               first_i); each absorber keeps its lowest claim by
//               atomicMin.  ceil(j / 32) word tests instead of up to j
//               gate evaluations.
//   clear_safe  zeroes A for the next pass, anywhere after the last claim.
// W = ceil(N / 32) words a row; G holds N * W words (indexed with 32-bit
// ints: N * W < 2^31), A holds W.  Between clear_safe, gate_rows and claim
// the block needs a __syncthreads.
//
// Gate is the kernel's pair test: fields(s) loads slot s's fields,
// test(fk, fj) decides the pair (k, j), k < j.

#pragma once

#include <cuda_runtime.h>

namespace merge_bitmask {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int words(int n) { return (n + 31) >> 5; }

template <class Gate>
__device__ __forceinline__ void gate_rows(const Gate& gate, const int* alive,
                                          int hi, int W, unsigned* G,
                                          unsigned* A) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  // two rows at a time, j1 and j2 = j1 + n_warps: they share the loads of
  // slot k's fields and their tests are independent chains
  for (int j1 = threadIdx.x >> 5; j1 < hi; j1 += 2 * n_warps) {
    const int j2 = j1 + n_warps;
    const bool a1 = alive[j1] != 0;
    const bool a2 = j2 < hi && alive[j2] != 0;
    if (!a1 && !a2) continue;  // a dead slot's row is never read
    const auto f1 = gate.fields(j1);
    const auto f2 = gate.fields(a2 ? j2 : j1);
    unsigned* row1 = G + j1 * W;
    unsigned* row2 = G + j2 * W;
    unsigned any1 = 0, any2 = 0;
    for (int w = 0; w < words(a2 ? j2 : j1); ++w) {
      const int k = 32 * w + lane;
      const bool ak = k < hi && alive[k];
      const auto fk = gate.fields(ak ? k : 0);
      const bool g1 = a1 && ak && k < j1 && gate.test(fk, f1);
      const bool g2 = a2 && ak && k < j2 && gate.test(fk, f2);
      const unsigned b1 = __ballot_sync(kFull, g1);
      const unsigned b2 = __ballot_sync(kFull, g2);
      any1 |= b1;
      any2 |= b2;
      if (lane == 0) {
        if (a1 && w < words(j1)) row1[w] = b1;
        if (a2) row2[w] = b2;
      }
    }
    if (lane == 0) {
      if (a1 && any1 == 0) atomicOr(&A[j1 >> 5], 1u << (j1 & 31));
      if (a2 && any2 == 0) atomicOr(&A[j2 >> 5], 1u << (j2 & 31));
    }
  }
}

__device__ __forceinline__ void claim(int j, const int* alive, int hi, int W,
                                      const unsigned* G, const unsigned* A,
                                      int* jstar) {
  if (j >= hi || !alive[j]) return;
  for (int w = 0; w < words(j); ++w) {
    const unsigned m = G[j * W + w] & A[w];
    if (m) {
      atomicMin(&jstar[32 * w + __ffs(m) - 1], j);
      return;
    }
  }
}

__device__ __forceinline__ void clear_safe(unsigned* A, int W) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) A[w] = 0;
}

// A slot-wise phase over slots 0 .. n - 1.  The small form (blockDim >= n):
// thread i takes slot i alone, one branch and no loop.  The large form:
// each thread takes every blockDim-th slot from its own.
template <bool kLarge, class F>
__device__ __forceinline__ void for_slots(int n, F&& f) {
  if constexpr (kLarge) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) f(i);
  } else if (static_cast<int>(threadIdx.x) < n) {
    f(static_cast<int>(threadIdx.x));
  }
}

}  // namespace merge_bitmask
