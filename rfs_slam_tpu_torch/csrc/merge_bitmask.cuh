// The pair search of one Gaussian-mixture merge pass as bit masks, for the
// merge kernels (one CTA per particle, blockDim a multiple of 32).  The slot
// fields and the masks live in shared memory (the small forms, N <= 1024)
// or in the particle's part of a global workspace (merge3d's large form);
// the functions take either, through generic pointers.
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

// The mask-free search of merge2d's large form.  It needs two facts of
// the gate mask G above, not G itself: whether row j has any bit (j is
// unsafe), and the lowest bit of G[j] & A.  alive and safe are bit words
// (bit s % 32 of word s / 32), safe zero on entry; link holds N for every
// slot on entry.  After each step the block needs a barrier.
//   safe_sweep   a warp takes an alive row j, its fields in registers, and
//                walks the words of k < j from the top one down (a word
//                with no alive slot is skipped), one ballot per word over
//                the alive lanes, to its first gated partner: only whether
//                one exists matters, and a partner is most often near.  A
//                row that finds none sets its safe bit.
//   safe_words   one warp lists the non-zero safe words in ascending
//                order: list[0 .. *count).
//   claim_sweep  a warp takes each alive row j that is not safe and walks
//                the listed safe words below j, testing only the safe
//                lanes; the lowest lane of the first non-zero ballot is
//                j's claim (G[j] & A's lowest bit), kept in link by the
//                absorber's atomicMin as in claim(): an absorber's
//                link[i] is its lowest claim (j_star).
// Both evaluate the gates in the same arithmetic as gate_rows, so the
// claims, and every pass after them, are the mask's to the bit.
__device__ __forceinline__ bool bit(const unsigned* words, int s) {
  return (words[s >> 5] >> (s & 31)) & 1u;
}

template <class Gate>
__device__ __forceinline__ void safe_sweep(const Gate& gate,
                                           const unsigned* alive, int hi,
                                           unsigned* safe) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < hi; j += blockDim.x >> 5) {
    if (!bit(alive, j)) continue;
    const auto fj = gate.fields(j);
    bool found = false;
    for (int w = words(j) - 1; w >= 0 && !found; --w) {
      const unsigned aw = alive[w];
      if (aw == 0) continue;
      const int k = 32 * w + lane;
      const bool ak = ((aw >> lane) & 1u) && k < j;
      const auto fk = gate.fields(ak ? k : 0);
      found = __ballot_sync(kFull, ak && gate.test(fk, fj)) != 0;
    }
    if (lane == 0 && !found) atomicOr(&safe[j >> 5], 1u << (j & 31));
  }
}

__device__ __forceinline__ void safe_words(const unsigned* safe, int W,
                                           int* list, int* count) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int n = 0;
  for (int base = 0; base < W; base += 32) {
    const int w = base + lane;
    const unsigned sw = w < W ? safe[w] : 0u;
    const unsigned b = __ballot_sync(kFull, sw != 0);
    if (sw) list[n + __popc(b & ((1u << lane) - 1u))] = w;
    n += __popc(b);
  }
  if (lane == 0) *count = n;
}

template <class Gate>
__device__ __forceinline__ void claim_sweep(const Gate& gate,
                                            const unsigned* alive,
                                            const unsigned* safe,
                                            const int* list, int n, int hi,
                                            int* link) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < hi; j += blockDim.x >> 5) {
    if (!bit(alive, j) || bit(safe, j)) continue;
    const auto fj = gate.fields(j);
    for (int q = 0; q < n; ++q) {
      const int w = list[q];
      if (32 * w >= j) break;
      const unsigned sw = safe[w];
      const int k = 32 * w + lane;
      const bool sk = ((sw >> lane) & 1u) && k < j;
      const auto fk = gate.fields(sk ? k : 0);
      const unsigned b = __ballot_sync(kFull, sk && gate.test(fk, fj));
      if (b) {
        if (lane == 0) atomicMin(&link[32 * w + __ffs(b) - 1], j);
        break;
      }
    }
  }
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
