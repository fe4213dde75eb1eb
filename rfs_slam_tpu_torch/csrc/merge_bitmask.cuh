// The pair search of one Gaussian-mixture merge pass, for the merge
// kernels (one CTA per particle, blockDim a multiple of 32).  Two searches:
// the gate bit mask of the small forms (N <= 1024, the slot fields and the
// mask in shared memory), and the mask-free sweeps of the large forms
// (below), which take their fields and bits through generic pointers, in
// shared memory or in a global workspace.
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

// The mask-free search of the large forms.  It needs two facts of the
// gate mask G above, not G itself: whether row j has any bit (j is
// unsafe), and the lowest bit of G[j] & A.  alive and safe are bit words
// (bit s % 32 of word s / 32), safe zero on entry; link holds N for every
// slot on entry.  After each step the block needs a barrier.
//   safe_sweep   a warp takes an alive row j, its fields in registers, and
//                walks the words of k < j from the top one down (a word
//                with no alive slot is skipped), one ballot per word over
//                the alive lanes, to its first gated partner: only whether
//                one exists matters, and a partner is most often near.  A
//                row that finds none sets its safe bit.
//   safe_sweep2  the same, two rows a warp (j and j + warps), as
//                gate_rows takes them: both walk down together, each
//                word's fields loaded once for both tests (two independent
//                chains), and a row leaves the walk at its first partner.
//   safe_words   one warp lists the non-zero safe words in ascending
//                order: list[0 .. *count).
//   claim_sweep  a warp takes each alive row j that is not safe and walks
//                the listed safe words below j, testing only the safe
//                lanes; the lowest lane of the first non-zero ballot is
//                j's claim (G[j] & A's lowest bit), kept in link by the
//                absorber's atomicMin as in claim(): an absorber's
//                link[i] is its lowest claim (j_star).
// All evaluate the gates in the same arithmetic as gate_rows, so the
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

template <class Gate>
__device__ __forceinline__ void safe_sweep2(const Gate& gate,
                                            const unsigned* alive, int hi,
                                            unsigned* safe) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int j1 = threadIdx.x >> 5; j1 < hi; j1 += 2 * n_warps) {
    const int j2 = j1 + n_warps;
    const bool a1 = bit(alive, j1);
    const bool a2 = j2 < hi && bit(alive, j2);
    if (!a1 && !a2) continue;
    const auto f1 = gate.fields(j1);
    const auto f2 = gate.fields(a2 ? j2 : j1);
    // open: still searching (an alive row with no partner found yet)
    bool open1 = a1, open2 = a2;
    for (int w = words(a2 ? j2 : j1) - 1; w >= 0 && (open1 || open2); --w) {
      const unsigned aw = alive[w];
      if (aw == 0) continue;
      const int k = 32 * w + lane;
      const bool ak = (aw >> lane) & 1u;
      const auto fk = gate.fields(ak ? k : 0);
      const bool g1 = open1 && ak && k < j1 && gate.test(fk, f1);
      const bool g2 = open2 && ak && k < j2 && gate.test(fk, f2);
      open1 = open1 && __ballot_sync(kFull, g1) == 0;
      open2 = open2 && __ballot_sync(kFull, g2) == 0;
    }
    if (lane == 0) {
      if (open1) atomicOr(&safe[j1 >> 5], 1u << (j1 & 31));
      if (open2) atomicOr(&safe[j2 >> 5], 1u << (j2 & 31));
    }
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

// A slot-wise phase of the small forms (blockDim >= n): thread i takes
// slot i alone, one branch and no loop.
template <class F>
__device__ __forceinline__ void for_slots(int n, F&& f) {
  if (static_cast<int>(threadIdx.x) < n) f(static_cast<int>(threadIdx.x));
}

// Where a large form keeps a particle's data (large_tier), by the bytes of
// a slot's gate fields: all in shared memory; the gate fields in the
// workspace; all in the workspace.  Shared memory starts with a 16-byte
// header (hi and the count of listed safe words), which keeps the float4
// fields aligned; the claims (4 bytes a slot), the alive bits, the safe
// bits and the list of safe words (12 bytes per 32 slots) follow the
// fields.  The wrapper's launch_plan sizes the same layout.
constexpr int kAllShared = 0, kFieldsGlobal = 1, kAllGlobal = 2;
// the opt-in limit of a Hopper block's shared memory
constexpr size_t kMaxSmem = 232448, kHeader = 16;

inline size_t claim_bytes(int N) {
  return 4 * static_cast<size_t>(N) + 12 * static_cast<size_t>(words(N));
}
inline int large_tier(size_t field_bytes, int N) {
  if (kHeader + field_bytes + claim_bytes(N) <= kMaxSmem) return kAllShared;
  return kHeader + claim_bytes(N) <= kMaxSmem ? kFieldsGlobal : kAllGlobal;
}

// A large form's launch at N slots, field_bytes of gate fields a slot: its
// tier, the float4s of a particle's part of the workspace, and whether
// smem bytes of shared memory and the workspace ws (ws_bytes) hold it.
struct LargeLayout {
  int tier;
  size_t stride;
  bool ok;
};
inline LargeLayout large_layout(size_t field_bytes, int P, int N, int smem,
                                const void* ws, size_t ws_bytes) {
  const int tier = large_tier(field_bytes, N);
  const size_t shared = tier == kAllShared ? field_bytes + claim_bytes(N)
                        : tier == kFieldsGlobal ? claim_bytes(N)
                                                : 0;
  const size_t global = tier == kAllShared ? 0
                        : tier == kFieldsGlobal ? field_bytes
                                                : field_bytes + claim_bytes(N);
  const size_t stride = (global + 15) / 16;
  const bool ok = static_cast<size_t>(smem) >= kHeader + shared &&
                  (stride == 0 || (ws != nullptr &&
                                   ws_bytes >= P * stride * sizeof(float4)));
  return {tier, stride, ok};
}

}  // namespace merge_bitmask
