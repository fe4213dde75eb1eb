// Fused RB-PHD map update for 2-D range-bearing SLAM, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/map_update2d.py
// (_kernel, entry fused_map_update2d).  Per particle it computes the
// expected measurement and Jacobian, S, S^-1, the NaN-scrubbed gain K, the
// symmetrized (I-KH)C, Pd with the close-to-limit buffer, the gated
// [Zc, M] likelihood table with the Mahalanobis gate, the weight table and
// its column sums with the clutter intensity, the missed-detection weights
// with near-limit compensation, the unused-measurement flags, and the top
// T landmarks per measurement by iterated first-argmax (lowest index on
// ties).  Semantics: RBPHDFilter.hpp:597-725 and KalmanFilter.hpp:261-342.
//
// What bounds it on the card: at bench shape (P=200, M=128, Zc=40, T=8)
// the inputs and outputs are 2.8 MB, under a microsecond of HBM time, and
// the arithmetic is a few MFLOP.  Neither bytes nor operations bound it:
// latency does.  One CTA per particle runs phases separated by barriers,
// and within a phase a warp's instructions mostly wait on the one before,
// so a phase costs about its busiest warp's instruction count times the
// dependent latency (~8-10 cycles an instruction, measured with clock64
// stamps per phase).  The first port ran one thread per slot: each
// filled its 40 table cells one after another and each warp ran 10
// columns x 8 argmax rounds of shuffle trees.
//
// Design: one CTA per particle with 16 warps (launch_plan in the wrapper;
// 200 CTAs with two on most SMs, in one wave), each phase as wide as its
// work and short on its busiest warp:
//   1. slots, a warp per 32: the per-slot EKF algebra, the plane outputs,
//      and a stash of what the table needs (r, b, S^-1, norm, pd, w) in
//      shared memory; a ballot marks the slots that can have a nonzero
//      cell (alive, detectable, in range): "the table's slots", 23 of 128
//      on the mid-run state;
//   2. the table chunk [ZB, M] over the table's slots only: thread
//      q + ntab g takes the table's slot q, its fields in registers, and
//      every groups-th column;
//   3. a warp per column.  Over the table's slots (a lane each while they
//      number 32 or fewer, two up to 64; column_compact()): the column
//      sum in the first port's order, normalisation, the unused flag, and
//      the top T.  Where the column has at most T positive entries
//      (nearly always) each positive's pick is its rank among them, from
//      one shuffle per positive; else T rounds of first-argmax on a 32-bit
//      order key (redux.sync max, then redux.sync min of the lowest index
//      holding it).  More table slots, or a negative or NaN entry:
//      column(), over all M slots with the T rounds, the column reread
//      from shared memory and its picks marked in a bit mask;
//   4. each slot sums its table row in column order (the first port's
//      order), then the missed-detection weights.
// The table is held in chunks of ZB columns (all Zc at bench shape), so
// the table's shared memory stays bounded at any M.  The arithmetic is the
// first port's expression for expression (pd * w * lik is (pd * w) * lik,
// the column sums in its order), so nvcc contracts it as it did and every
// output rounds as the first port's; a zero divided by the column sum is
// set as IEEE division gives it, without the division.  atan2f replaces the
// TPU kernel's polynomial atan2 (Mosaic has none), and wrap_angle rounds
// half to even (rintf) as jnp.round does.
//
// Block form (a map split over ranks, the particles x map mesh): the
// column sums span every slot, so a block's launch cannot finish alone.
// Two instantiations of the same kernel do the work of one launch on a
// block of M slots: kHead runs phases 1-2 and writes the plane outputs
// and the block's column sums without the clutter (phase 3's sum, in its
// order); the caller combines the blocks' sums over the map ranks and
// kTail runs phases 1-2 again (writing no planes), then phases 3-4 with
// the given column sums (clutter included): normalisation, the block's
// unused flags, its top T with the slot numbers offset by m_off, and the
// missed-detection weights.  kWhole is the one-launch form, unchanged.
//
// Large form (M > 1024, every mode; kLarge): in the small form a lane's
// table bits are one 32-bit word (bit r: slot lane + 32 r), and so are its
// picks' bits in column(), which bounds M at 32 x 32.  The large form reads
// a slot's table bit from the shared words s_tabw (bit lane of word r: the
// same bit) and keeps the picks' bits in lane-private shared words; the
// per-slot stash stays in shared memory while it fits (M up to ~3,300 at
// Zc=40) and moves to a global workspace past that (launch_plan).  Every
// statement of arithmetic and every loop order is the small form's, so the
// column sums add the table's slots in the same order and a map padded
// with dead slots gives the small form's bits on its slots.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  float r_max, r_min, r_buf, pd_const, clutter, R00, R01, R11, md_t2,
      birth_w, t_r, t_b;
};

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTwoPiSq = 39.47841760435743f;  // (2 pi)^2
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
// slot flags
constexpr int kAlive = 1, kClose = 2;
// order key of +0.0 (a picked entry) and of a padding lane (below all)
constexpr unsigned kZeroKey = 0x80000000u, kPadKey = 0u;
// kernel forms: one launch, or a map block's head and tail launches
constexpr int kWhole = 0, kHead = 1, kTail = 2;

__device__ __forceinline__ float wrap_angle(float a) {
  return a - kTwoPi * rintf(a / kTwoPi);
}

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.0f;
}

// unsigned key that orders as the floats do, with -0 and +0 equal
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// a / b as the IEEE division rounds it, with no zero numerator reaching
// the division (it sends one down its slow path): 0 / b is the zero of
// the two signs, or NaN for b zero or NaN
__device__ __forceinline__ float div_nz(float a, float b) {
  const float q = (a != 0.f ? a : 1.f) / b;
  if (a != 0.f) return q;
  if (b == 0.f || b != b) return __int_as_float(0x7fffffff);
  return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                        0x80000000);
}

// index of the q-th (from 0) set bit of the bit string words[0..]: the
// word by popcounts, then the bit by halving the word five times
__device__ __forceinline__ int nth_set(const unsigned* words, int q) {
  int w = 0;
  unsigned word = words[0];
  for (int n = __popc(word); q >= n; n = __popc(word)) {
    q -= n;
    word = words[++w];
  }
  int pos = 32 * w;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const unsigned lo = word & ((1u << half) - 1u);
    const int n = __popc(lo);
    if (q >= n) {
      q -= n;
      word >>= half;
      pos += half;
    } else {
      word = lo;
    }
  }
  return pos;
}

// Whether slot lane + 32 r is in the table: bit r of the lane's tabmask
// (small form), or bit lane of the table's bit word r (large form).
template <bool kLarge>
__device__ __forceinline__ bool in_table(unsigned tabmask,
                                         const unsigned* tabw, int lane,
                                         int r) {
  if constexpr (kLarge) return (tabw[r] >> lane) & 1u;
  return (tabmask >> r) & 1u;
}

// One argmax round over the warp: the largest key and the lowest index
// that holds it, from each lane's best key and its lowest index.
__device__ __forceinline__ void warp_first_argmax(unsigned best, int bi,
                                                  unsigned& g, unsigned& idx) {
  g = __reduce_max_sync(kFull, best);
  idx = __reduce_min_sync(kFull, best == g ? static_cast<unsigned>(bi)
                                           : 0xffffffffu);
}

// Phase 3 for one column (a warp) over all M slots, where
// column_compact() does not apply: sum, normalise in place, unused flag,
// T rounds of first-argmax over the column reread from shared memory.
// Bit r of tabmask: slot lane + 32 r is in the table (in_table); the
// others' entries are zero and were not written this chunk.
// kTail: the column sum is given (cs_given, clutter included) and the
// picked slot numbers are offset by m_off.
// kLarge: the picks' bits are the lane's words of taken (bit r % 32 of
// word (r / 32) * 32 + lane), ceil(M / 1024) * 32 words for the warp.
template <int kMode, bool kLarge>
__device__ void column(float* col, unsigned tabmask, const unsigned* tabw,
                       unsigned* taken_w, int M, int T, int Zc, int k,
                       bool zm, float clutter, int lane, size_t p,
                       float* colsum_out, bool* unused_out, float* cand_w,
                       int64_t* cand_m, float cs_given, int m_off) {
  float c;
  if constexpr (kMode == kTail) {
    c = cs_given;
  } else {
    float s = 0.f;
    for (int j = lane, r = 0; j < M; j += 32, ++r)
      if (in_table<kLarge>(tabmask, tabw, lane, r)) s += col[j];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    c = clutter + s;
  }
  bool any = false;
  for (int j = lane, r = 0; j < M; j += 32, ++r) {
    const float v = in_table<kLarge>(tabmask, tabw, lane, r) ? col[j] : 0.f;
    const float x = zm ? div_nz(v, c) : 0.f;
    any |= x > 0.f;
    col[j] = x;
  }
  any = __any_sync(kFull, any);
  if (lane == 0) {
    if constexpr (kMode == kWhole) colsum_out[p * Zc + k] = c;
    unused_out[p * Zc + k] = zm && !any;
  }

  unsigned taken = 0;  // bit r set once entry lane + 32 r is picked
  if constexpr (kLarge)
    for (int q = lane; q < 32 * ((M + 1023) >> 10); q += 32) taken_w[q] = 0;
  for (int t = 0; t < T; ++t) {
    unsigned best = kPadKey;
    int bi = M;
    for (int j = lane, r = 0; j < M; j += 32, ++r) {
      bool picked;
      if constexpr (kLarge)
        picked = (taken_w[(r >> 5) * 32 + lane] >> (r & 31)) & 1u;
      else
        picked = (taken >> r) & 1u;
      const unsigned kj = picked ? kZeroKey : order_key(col[j]);
      if (kj > best) { best = kj; bi = j; }
    }
    unsigned g, idx;
    warp_first_argmax(best, bi, g, idx);
    if (lane == 0) {
      const size_t o = p * T * Zc + static_cast<size_t>(t) * Zc + k;
      cand_w[o] = key_value(g);
      cand_m[o] = min(static_cast<int>(idx), M - 1) + m_off;
    }
    if (idx < static_cast<unsigned>(M) && lane == static_cast<int>(idx & 31)) {
      const int r = idx >> 5;
      if constexpr (kLarge)
        taken_w[(r >> 5) * 32 + lane] |= 1u << (r & 31);
      else
        taken |= 1u << r;
    }
  }
}

// Phase 3 for one column over the table's slots only: the entry of the
// table's slot number q = lane + 32 c (slot index sm[c], increasing with
// q; -1 past the last) is held by lane q % 32; every other slot's entry is
// zero.  Same results as column() but on ceil(ntab / 32) entries a lane.
// Returns false, having written nothing, when an entry is negative or NaN:
// then the T rounds may pick zeros outside the table, and column() runs.
template <int CR, int kMode, bool kLarge>
__device__ bool column_compact(float* col, const int* sm, unsigned tabmask,
                               const unsigned* tabw, int M, int T, int Zc,
                               int k, bool zm,
                               float clutter, int lane, size_t p,
                               float* colsum_out, bool* unused_out,
                               float* cand_w, int64_t* cand_m,
                               float cs_given, int m_off) {
  float cs;
  if constexpr (kMode == kTail) {
    cs = cs_given;
  } else {
    // the sum in column()'s order, the first port's: lane partials over
    // the lane's slots lane + 32 r, then the butterfly (a zero adds
    // nothing)
    float s = 0.f;
    for (int j = lane, r = 0; j < M; j += 32, ++r)
      if (in_table<kLarge>(tabmask, tabw, lane, r)) s += col[j];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    cs = clutter + s;
  }
  float v[CR];
#pragma unroll
  for (int c = 0; c < CR; ++c) v[c] = sm[c] >= 0 ? col[sm[c]] : 0.f;
  const float xz = zm ? div_nz(0.f, cs) : 0.f;  // the other slots' entry
  bool bad = !(xz >= 0.f), any = false;
  float x[CR];
#pragma unroll
  for (int c = 0; c < CR; ++c) {
    x[c] = zm ? div_nz(v[c], cs) : 0.f;
    bad |= sm[c] >= 0 && !(x[c] >= 0.f);
    any |= sm[c] >= 0 && x[c] > 0.f;
  }
  if (__any_sync(kFull, bad)) return false;
  any = __any_sync(kFull, any);
#pragma unroll
  for (int c = 0; c < CR; ++c)
    if (sm[c] >= 0) col[sm[c]] = x[c];
  for (int j = lane, r = 0; j < M; j += 32, ++r)
    if (!in_table<kLarge>(tabmask, tabw, lane, r)) col[j] = xz;
  if (lane == 0) {
    if constexpr (kMode == kWhole) colsum_out[p * Zc + k] = cs;
    unused_out[p * Zc + k] = zm && !any;
  }

  unsigned key[CR], pos[CR];
  int npos = 0;
#pragma unroll
  for (int c = 0; c < CR; ++c) {
    key[c] = sm[c] >= 0 ? order_key(x[c]) : kPadKey;
    pos[c] = __ballot_sync(kFull, key[c] > kZeroKey);
    npos += __popc(pos[c]);
  }
  const size_t o = p * T * Zc + k;
  if (npos <= T) {
    // No entry is negative or NaN, so the T rounds pick every positive,
    // the largest first and the lowest index first among equals, each at
    // its rank, and then (0, 0): every entry left is zero, index 0 the
    // lowest.
    int rank[CR];
#pragma unroll
    for (int c = 0; c < CR; ++c) rank[c] = 0;
#pragma unroll
    for (int c2 = 0; c2 < CR; ++c2) {
      for (unsigned m = pos[c2]; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const unsigned kt = __shfl_sync(kFull, key[c2], src);
        const int qt = src + 32 * c2;
#pragma unroll
        for (int c = 0; c < CR; ++c)
          rank[c] += kt > key[c] || (kt == key[c] && qt < lane + 32 * c);
      }
    }
#pragma unroll
    for (int c = 0; c < CR; ++c) {
      if ((pos[c] >> lane) & 1u) {
        cand_w[o + static_cast<size_t>(rank[c]) * Zc] = key_value(key[c]);
        cand_m[o + static_cast<size_t>(rank[c]) * Zc] = sm[c] + m_off;
      }
    }
    for (int t = npos + lane; t < T; t += 32) {
      cand_w[o + static_cast<size_t>(t) * Zc] = 0.f;
      cand_m[o + static_cast<size_t>(t) * Zc] = m_off;
    }
    return true;
  }
  // more than T positives: every pick is one, by T rounds of first-argmax
  for (int t = 0; t < T; ++t) {
    unsigned best = kPadKey;
    int bi = M;
#pragma unroll
    for (int c = 0; c < CR; ++c) {
      if (key[c] > best) { best = key[c]; bi = sm[c]; }
    }
    unsigned g, idx;
    warp_first_argmax(best, bi, g, idx);
    if (lane == 0) {
      cand_w[o + static_cast<size_t>(t) * Zc] = key_value(g);
      cand_m[o + static_cast<size_t>(t) * Zc] = idx + m_off;
    }
#pragma unroll
    for (int c = 0; c < CR; ++c)
      if (sm[c] == static_cast<int>(idx)) key[c] = kZeroKey;
  }
  return true;
}

// at most 64 registers a thread, so two 512-thread CTAs fit on an SM and
// all 200 particles of the bench shape run in one wave on 132 SMs
template <int kMode, bool kLarge>
__global__ void __launch_bounds__(kMaxThreads, 2) map_update2d_kernel(
    Params prm, int M, int Zc, int T, int ZB, int m_off,
    float* __restrict__ stash,
    const float* __restrict__ colsum_in,
    const float* __restrict__ pose, const float* __restrict__ mx,
    const float* __restrict__ my, const float* __restrict__ c00,
    const float* __restrict__ c01, const float* __restrict__ c11,
    const float* __restrict__ w, const float* __restrict__ w_prev,
    const bool* __restrict__ alive, const float* __restrict__ z,
    const bool* __restrict__ zmask, float* __restrict__ out,
    bool* __restrict__ unused_out, int64_t* __restrict__ cand_m) {
  // shared memory: z [Zc, 2], z mask [Zc], 10 slot planes [M], the bit
  // words of the slots in the table [W = ceil(M / 32)], the table chunk
  // [ZB, M], and in the large form the warps' pick bits [warps, 32 *
  // ceil(M / 1024)] (the wrapper's launch_plan sizes it the same way).  A
  // large form given a stash keeps the 10 slot planes there instead, at
  // this particle's [10, M].
  extern __shared__ float smem[];
  float* s_z = smem;
  int* s_zm = reinterpret_cast<int*>(s_z + 2 * Zc);
  const bool in_global = kLarge && stash != nullptr;
  float* s_r = in_global ? stash + blockIdx.x * static_cast<size_t>(10 * M)
                         : reinterpret_cast<float*>(s_zm + Zc);
  float* s_b = s_r + M;
  float* s_i00 = s_b + M;
  float* s_i01 = s_i00 + M;
  float* s_i11 = s_i01 + M;
  float* s_norm = s_i11 + M;
  float* s_pd = s_norm + M;
  float* s_w = s_pd + M;
  float* s_row = s_w + M;      // row sums of the normalised table
  int* s_flag = reinterpret_cast<int*>(s_row + M);
  unsigned* s_tabw = reinterpret_cast<unsigned*>(
      in_global ? reinterpret_cast<float*>(s_zm + Zc)
                : reinterpret_cast<float*>(s_flag + M));  // [W]
  float* tab = reinterpret_cast<float*>(s_tabw + (M + 31) / 32);
  unsigned* s_taken = reinterpret_cast<unsigned*>(tab + ZB * M);

  // output planes, each [P, M], then col_sum [P, Zc] and cand_w [P, T*Zc];
  // kHead writes the planes but w and the column sums without clutter,
  // kTail w [P, M] then cand_w
  const int P = gridDim.x;
  const size_t PM = static_cast<size_t>(P) * M;
  float* w_out = out;
  float* wp_out = out + PM;
  float* pd_out = out + 2 * PM;
  float* k00_out = out + 3 * PM;
  float* k01_out = out + 4 * PM;
  float* k10_out = out + 5 * PM;
  float* k11_out = out + 6 * PM;
  float* cu00_out = out + 7 * PM;
  float* cu01_out = out + 8 * PM;
  float* cu11_out = out + 9 * PM;
  float* zer_out = out + 10 * PM;
  float* zeb_out = out + 11 * PM;
  float* colsum_out = out + 12 * PM;
  float* cand_w = kMode == kTail ? out + PM
                                 : colsum_out + static_cast<size_t>(P) * Zc;

  const size_t p = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nthr >> 5;

  const float px = pose[3 * p], py = pose[3 * p + 1], pth = pose[3 * p + 2];

  // ---- 1. per slot; a warp takes 32 slots at a time
  for (int k = tid; k < Zc; k += nthr) {
    s_z[2 * k] = z[2 * k];
    s_z[2 * k + 1] = z[2 * k + 1];
    s_zm[k] = zmask[k] ? 1 : 0;
  }
  for (int base = tid - lane; base < M; base += nthr) {
    const int m = base + lane;
    bool in_table = false;
    if (m < M) {
      const size_t pm = p * M + m;
      const float vx = mx[pm], vy = my[pm];
      const float s00c = c00[pm], s01c = c01[pm], s11c = c11[pm];
      const float wv = w[pm];
      const bool alv = alive[pm];

      // expected measurement + Jacobian (RangeBearing.measure_p)
      const float dx = vx - px, dy = vy - py;
      const float r2 = dx * dx + dy * dy;
      const float r = sqrtf(r2);
      const float b = wrap_angle(atan2f(dy, dx) - pth);
      const float r2s = fmaxf(r2, 1e-24f);
      const float rs = sqrtf(r2s);
      const float h00 = dx / rs, h01 = dy / rs;
      const float h10 = -dy / r2s, h11 = dx / r2s;

      // S = H C H^T + R, its determinant and inverse
      const float hs00 = h00 * s00c + h01 * s01c;
      const float hs01 = h00 * s01c + h01 * s11c;
      const float hs10 = h10 * s00c + h11 * s01c;
      const float hs11 = h10 * s01c + h11 * s11c;
      const float s00 = hs00 * h00 + hs01 * h01 + prm.R00;
      const float s01 = hs00 * h10 + hs01 * h11 + prm.R01;
      const float s11 = hs10 * h10 + hs11 * h11 + prm.R11;
      const float det = s00 * s11 - s01 * s01;
      const float i00 = s11 / det;
      const float i01 = -s01 / det;
      const float i11 = s00 / det;

      // K = C H^T S^-1, non-finite entries scrubbed (KalmanFilter.hpp:253-254)
      const float cht00 = s00c * h00 + s01c * h01;
      const float cht01 = s00c * h10 + s01c * h11;
      const float cht10 = s01c * h00 + s11c * h01;
      const float cht11 = s01c * h10 + s11c * h11;
      const float k00 = finite_or_zero(cht00 * i00 + cht01 * i01);
      const float k01 = finite_or_zero(cht00 * i01 + cht01 * i11);
      const float k10 = finite_or_zero(cht10 * i00 + cht11 * i01);
      const float k11 = finite_or_zero(cht10 * i01 + cht11 * i11);

      // (I - K H) C, symmetrized (KalmanFilter.hpp:240-245)
      const float a00 = 1.0f - (k00 * h00 + k01 * h10);
      const float a01 = -(k00 * h01 + k01 * h11);
      const float a10 = -(k10 * h00 + k11 * h10);
      const float a11 = 1.0f - (k10 * h01 + k11 * h11);
      const float u00 = a00 * s00c + a01 * s01c;
      const float u01 = a00 * s01c + a01 * s11c;
      const float u10 = a10 * s00c + a11 * s01c;
      const float u11 = a10 * s01c + a11 * s11c;

      // Pd with the close-to-limit buffer (RBPHDFilter.hpp:597-609)
      const bool mvalid = (r <= prm.r_max) && (r >= prm.r_min);
      const bool near_inner = mvalid && ((r >= prm.r_max - prm.r_buf) ||
                                         (r <= prm.r_min + prm.r_buf));
      const bool near_outer = !mvalid && (r <= prm.r_max + prm.r_buf) &&
                              (r >= prm.r_min - prm.r_buf);
      const bool close = (near_inner || near_outer) && alv;
      const float pd = close ? 1.0f : ((mvalid && alv) ? prm.pd_const : 0.0f);

      if constexpr (kMode != kTail) {
        pd_out[pm] = pd;
        k00_out[pm] = k00;
        k01_out[pm] = k01;
        k10_out[pm] = k10;
        k11_out[pm] = k11;
        cu00_out[pm] = u00;
        cu01_out[pm] = 0.5f * (u01 + u10);
        cu11_out[pm] = u11;
        zer_out[pm] = r;
        zeb_out[pm] = b;
        wp_out[pm] = alv ? wv : w_prev[pm];
      }

      s_r[m] = r;
      s_b[m] = b;
      s_i00[m] = i00;
      s_i01[m] = i01;
      s_i11[m] = i11;
      s_norm[m] = sqrtf(kTwoPiSq * det);
      s_pd[m] = pd;
      s_w[m] = wv;
      s_row[m] = 0.f;
      // a cell of this slot can be nonzero only if it is alive, detectable
      // and in range (the likelihood is zeroed out of range)
      in_table = alv && pd > 0.f && mvalid;
      s_flag[m] = (alv ? kAlive : 0) | (close ? kClose : 0);
    }
    const unsigned bits = __ballot_sync(kFull, in_table);
    if (lane == 0) s_tabw[base >> 5] = bits;
  }
  __syncthreads();
  // the slots in the table: ntab of them; bit r of tabmask: this lane's
  // slot lane + 32 r is one (phase 3)
  int ntab = 0;
  unsigned tabmask = 0;
  for (int r = 0; r < (M + 31) / 32; ++r) {
    const unsigned word = s_tabw[r];
    ntab += __popc(word);
    if constexpr (!kLarge) tabmask |= ((word >> lane) & 1u) << r;
  }
  // the table's slots number lane and lane + 32, for column_compact
  int sm[2];
  for (int c = 0; c < 2; ++c) {
    const int q = lane + 32 * c;
    sm[c] = q < ntab ? nth_set(s_tabw, q) : -1;
  }

  for (int k0 = 0; k0 < Zc; k0 += ZB) {
    const int nk = min(ZB, Zc - k0);

    // ---- 2. gated weight table over the table's slots, cell-parallel
    // (RBPHDFilter.hpp:620-659); the other slots' entries are zero.  Thread
    // u = q + ntab g takes the table's slot q, its fields in registers, and
    // the columns g, g + groups, ...
    const int groups = max(1, nthr / max(ntab, 1));
    for (int u = tid; u < ntab * groups; u += nthr) {
      const int m = nth_set(s_tabw, u % ntab);
      const float r = s_r[m], b = s_b[m], i00 = s_i00[m], i01 = s_i01[m],
                  i11 = s_i11[m], norm = s_norm[m], pd = s_pd[m],
                  wv = s_w[m];
      for (int kk = u / ntab; kk < nk; kk += groups) {
        const int k = k0 + kk;
        float v = 0.f;
        if (s_zm[k]) {
          const float ir = s_z[2 * k] - r;
          const float ib = wrap_angle(s_z[2 * k + 1] - b);
          const bool gate_ok = (prm.t_r <= 0.f || fabsf(ir) <= prm.t_r) &&
                               (prm.t_b <= 0.f || fabsf(ib) <= prm.t_b);
          const float md2 = i00 * ir * ir + 2.0f * i01 * ir * ib +
                            i11 * ib * ib;
          const float lik = finite_or_zero(expf(-0.5f * md2) / norm);
          if (gate_ok && md2 <= prm.md_t2 && lik > 0.f) v = pd * wv * lik;
        }
        tab[kk * M + m] = v;
      }
    }
    __syncthreads();

    // ---- 3. one warp per column: sums, normalisation, unused, top T
    // (RBPHDFilter.hpp:686-720 and the hierarchical selection)
    for (int kk = warp; kk < nk; kk += n_warps) {
      const int k = k0 + kk;
      float* col = tab + kk * M;
      if constexpr (kMode == kHead) {
        // the block's column sum, in column()'s order, without clutter
        float s = 0.f;
        for (int j = lane, r = 0; j < M; j += 32, ++r)
          if (in_table<kLarge>(tabmask, s_tabw, lane, r)) s += col[j];
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(kFull, s, off);
        if (lane == 0) colsum_out[p * Zc + k] = s;
      } else {
        const bool zm = s_zm[k] != 0;
        const float cs_given = kMode == kTail ? colsum_in[p * Zc + k] : 0.f;
        const bool done =
            ntab <= 32
                ? column_compact<1, kMode, kLarge>(
                      col, sm, tabmask, s_tabw, M, T, Zc, k, zm, prm.clutter,
                      lane, p, colsum_out, unused_out, cand_w, cand_m,
                      cs_given, m_off)
            : ntab <= 64
                ? column_compact<2, kMode, kLarge>(
                      col, sm, tabmask, s_tabw, M, T, Zc, k, zm, prm.clutter,
                      lane, p, colsum_out, unused_out, cand_w, cand_m,
                      cs_given, m_off)
                : false;
        if (!done)
          column<kMode, kLarge>(
              col, tabmask, s_tabw, s_taken + warp * 32 * ((M + 1023) >> 10),
              M, T, Zc, k, zm, prm.clutter, lane, p, colsum_out, unused_out,
              cand_w, cand_m, cs_given, m_off);
      }
    }
    __syncthreads();

    // ---- 4a. row sums in column order
    if constexpr (kMode != kHead) {
      for (int m = tid; m < M; m += nthr) {
        float row = s_row[m];
        for (int kk = 0; kk < nk; ++kk) row += tab[kk * M + m];
        s_row[m] = row;
      }
    }
    if (k0 + ZB < Zc) __syncthreads();  // the next chunk overwrites tab
  }
  if constexpr (kMode == kHead) return;

  // ---- 4b. missed-detection weights (hpp:686-706); each thread reads the
  // row sums it wrote
  for (int m = tid; m < M; m += nthr) {
    const size_t pm = p * M + m;
    const int f = s_flag[m];
    const float pd = s_pd[m], wv = s_w[m];
    float w_miss = (1.0f - pd) * wv;
    const float delta = pd * wv - s_row[m];
    if ((f & kClose) && wv > prm.birth_w && delta > 0.f)
      w_miss = fminf(w_miss + delta, 1.0f);
    w_out[pm] = (f & kAlive) ? w_miss : wv;
  }
}

}  // namespace

namespace {

Params unpack_params(const float* params) {
  Params prm;
  prm.r_max = params[0];
  prm.r_min = params[1];
  prm.r_buf = params[2];
  prm.pd_const = params[3];
  prm.clutter = params[4];
  prm.R00 = params[5];
  prm.R01 = params[6];
  prm.R11 = params[7];
  prm.md_t2 = params[8];
  prm.birth_w = params[9];
  prm.t_r = params[10];
  prm.t_b = params[11];
  return prm;
}

template <int kMode, bool kLarge>
int launch(int P, int M, int Zc, int T, int threads, int smem, int zb,
           int m_off, void* stash, const float* params,
           const void* colsum_in,
           const void* pose, const void* mx, const void* my, const void* c00,
           const void* c01, const void* c11, const void* w,
           const void* w_prev, const void* alive, const void* z,
           const void* zmask, void* out, void* unused_out, void* cand_m,
           void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      zb < 1 || M < 1 || (!kLarge && (M > 32 * 32 || stash != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm = unpack_params(params);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        map_update2d_kernel<kMode, kLarge>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  map_update2d_kernel<kMode, kLarge><<<P, threads, smem, st>>>(
      prm, M, Zc, T, zb, m_off, static_cast<float*>(stash),
      static_cast<const float*>(colsum_in),
      static_cast<const float*>(pose),
      static_cast<const float*>(mx), static_cast<const float*>(my),
      static_cast<const float*>(c00), static_cast<const float*>(c01),
      static_cast<const float*>(c11), static_cast<const float*>(w),
      static_cast<const float*>(w_prev), static_cast<const bool*>(alive),
      static_cast<const float*>(z), static_cast<const bool*>(zmask),
      static_cast<float*>(out), static_cast<bool*>(unused_out),
      static_cast<int64_t*>(cand_m));
  return static_cast<int>(cudaGetLastError());
}

// threads, smem and zb come from the wrapper's launch_plan; the form
// follows from M: the small form at M <= 1024, else the large form, whose
// stash (launch_plan's workspace, [P, 10, M] floats) may be null: then the
// slot planes stay in shared memory.
template <int kMode>
int launch_form(int P, int M, int Zc, int T, int threads, int smem, int zb,
                int m_off, void* stash, const float* params,
                const void* colsum_in, const void* pose, const void* mx,
                const void* my, const void* c00, const void* c01,
                const void* c11, const void* w, const void* w_prev,
                const void* alive, const void* z, const void* zmask,
                void* out, void* unused_out, void* cand_m, void* stream) {
  auto fn = M > 32 * 32 ? launch<kMode, true> : launch<kMode, false>;
  return fn(P, M, Zc, T, threads, smem, zb, m_off, stash, params, colsum_in,
            pose, mx, my, c00, c01, c11, w, w_prev, alive, z, zmask, out,
            unused_out, cand_m, stream);
}

}  // namespace

// out: one float buffer of 12 planes [P, M] (w, w_prev, pd, K00, K01, K10,
// K11, cov_upd 00/01/11, z_exp r/b), then col_sum [P, Zc], then cand_w
// [P, T * Zc].
extern "C" int map_update2d_launch(
    int P, int M, int Zc, int T, int threads, int smem, int zb,
    const float* params, const void* pose, const void* mx, const void* my,
    const void* c00, const void* c01, const void* c11, const void* w,
    const void* w_prev, const void* alive, const void* z, const void* zmask,
    void* out, void* unused_out, void* cand_m, void* stash, void* stream) {
  return launch_form<kWhole>(P, M, Zc, T, threads, smem, zb, 0, stash, params,
                             nullptr, pose, mx, my, c00, c01, c11, w, w_prev,
                             alive, z, zmask, out, unused_out, cand_m, stream);
}

// The block form on a block of M slots (the global slots m_off ..
// m_off + M - 1).  tail == 0 (kHead): out as above with plane 0 (w)
// unwritten and col_sum the block's sums without clutter; unused_out,
// cand_m and colsum_in unused.  tail == 1 (kTail): colsum_in [P, Zc] the
// global column sums with clutter; out holds w [P, M] then cand_w
// [P, T * Zc]; the picks are global slot numbers.
extern "C" int map_update2d_block_launch(
    int tail, int P, int M, int Zc, int T, int threads, int smem, int zb,
    int m_off, const float* params, const void* colsum_in,
    const void* pose, const void* mx, const void* my, const void* c00,
    const void* c01, const void* c11, const void* w, const void* w_prev,
    const void* alive, const void* z, const void* zmask, void* out,
    void* unused_out, void* cand_m, void* stash, void* stream) {
  auto fn = tail ? launch_form<kTail> : launch_form<kHead>;
  return fn(P, M, Zc, T, threads, smem, zb, m_off, stash, params,
            colsum_in, pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
            zmask, out, unused_out, cand_m, stream);
}
