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
// shared memory stays bounded for any M <= 1024.  The arithmetic is the
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
// Large form (M > 1024, every mode; map_update2d_large): the small form's
// loops over all M slots (a lane's table and pick bits in one word, the
// row sums and the argmax rounds over every slot, nth_set from word 0) cost
// what M costs, though only the table's slots can hold a nonzero cell (23
// of 2,048 on the padded replay state).  The large form works on a list of
// the table's slots, interleaved by lane: entry 32 i + L is lane L's i-th
// slot in the table among L, L + 32, ..., ascending.  A lane adds its
// column entries in the small form's order and the shuffle tree is the
// same: the same bits; a warp's accesses are 32 consecutive words.  The
// list has 32 x (the most slots a lane has) entries, the others holes,
// at most 32 ceil(M / 32).
//   1a. a warp takes a run of consecutive slot words: the table bits (and
//       the bits of the alive, close slots outside it), and per lane the
//       count; a lane's place in the list sums the warps' counts before;
//   1b. the same runs again: the per-slot algebra and the plane outputs;
//       the stash (11 planes) only for the table's slots, at their place in
//       the list.  Outside the table a slot's row sum is the fold of the
//       columns' entry there (0 / col_sum: a zero, or NaN where a column sum
//       is zero or NaN), so its missed-detection weight is final here for a
//       zero fold; the few that a NaN fold changes (alive, close, outside
//       the table) are rewritten at the end;
//   2-4. as the small form over the list: the table [Zc, entries] (in one
//       chunk whenever it fits), a warp a column (the sum, normalisation,
//       the unused flag; the picks by rounds over the positive entries in
//       order, then the small form's repeated pick, the slots outside the
//       table counted in as one class), the row sums and the weights.
// Shared memory is sized by launch_plan for a list of 32 ceil(M / 32).
// Where the stash does not fit beside the whole table, and the plan gave a
// workspace, the stash goes to this particle's part of it and the table
// takes the rest.

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

// the first slot from `from` on (below M) whose bit is clear, else M
__device__ __forceinline__ int next_unset(const unsigned* words, int from,
                                          int M) {
  for (int r = from >> 5; 32 * r < M; ++r) {
    unsigned free = ~words[r];
    if (r == from >> 5) free &= ~0u << (from & 31);
    if (free) return min(32 * r + __ffs(free) - 1, M);
  }
  return M;
}

// Range and Pd of a slot (RangeBearing.measure_p, RBPHDFilter.hpp:597-609)
struct SlotRange {
  float dx, dy, r2, r, pd;
  bool mvalid, close;
};

__device__ __forceinline__ SlotRange slot_range(const Params& prm, float px,
                                                float py, float vx, float vy,
                                                bool alv) {
  SlotRange s;
  s.dx = vx - px;
  s.dy = vy - py;
  s.r2 = s.dx * s.dx + s.dy * s.dy;
  s.r = sqrtf(s.r2);
  // Pd with the close-to-limit buffer (RBPHDFilter.hpp:597-609)
  s.mvalid = (s.r <= prm.r_max) && (s.r >= prm.r_min);
  const bool near_inner = s.mvalid && ((s.r >= prm.r_max - prm.r_buf) ||
                                       (s.r <= prm.r_min + prm.r_buf));
  const bool near_outer = !s.mvalid && (s.r <= prm.r_max + prm.r_buf) &&
                          (s.r >= prm.r_min - prm.r_buf);
  s.close = (near_inner || near_outer) && alv;
  s.pd = s.close ? 1.0f : ((s.mvalid && alv) ? prm.pd_const : 0.0f);
  return s;
}

// The per-slot algebra of phase 1: the expected measurement and Jacobian,
// S, its inverse, the scrubbed gain and the symmetrized update
struct SlotEkf {
  SlotRange s;
  float b, i00, i01, i11, norm, k00, k01, k10, k11, u00, u01s, u11;
};

__device__ __forceinline__ SlotEkf slot_ekf(const Params& prm, float px,
                                            float py, float pth, float vx,
                                            float vy, float s00c, float s01c,
                                            float s11c, bool alv) {
  SlotEkf e;
  e.s = slot_range(prm, px, py, vx, vy, alv);
  const float dx = e.s.dx, dy = e.s.dy, r2 = e.s.r2;

  // expected measurement + Jacobian (RangeBearing.measure_p)
  e.b = wrap_angle(atan2f(dy, dx) - pth);
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
  e.i00 = s11 / det;
  e.i01 = -s01 / det;
  e.i11 = s00 / det;
  e.norm = sqrtf(kTwoPiSq * det);

  // K = C H^T S^-1, non-finite entries scrubbed (KalmanFilter.hpp:253-254)
  const float cht00 = s00c * h00 + s01c * h01;
  const float cht01 = s00c * h10 + s01c * h11;
  const float cht10 = s01c * h00 + s11c * h01;
  const float cht11 = s01c * h10 + s11c * h11;
  e.k00 = finite_or_zero(cht00 * e.i00 + cht01 * e.i01);
  e.k01 = finite_or_zero(cht00 * e.i01 + cht01 * e.i11);
  e.k10 = finite_or_zero(cht10 * e.i00 + cht11 * e.i01);
  e.k11 = finite_or_zero(cht10 * e.i01 + cht11 * e.i11);

  // (I - K H) C, symmetrized (KalmanFilter.hpp:240-245)
  const float a00 = 1.0f - (e.k00 * h00 + e.k01 * h10);
  const float a01 = -(e.k00 * h01 + e.k01 * h11);
  const float a10 = -(e.k10 * h00 + e.k11 * h10);
  const float a11 = 1.0f - (e.k10 * h01 + e.k11 * h11);
  e.u00 = a00 * s00c + a01 * s01c;
  const float u01 = a00 * s01c + a01 * s11c;
  const float u10 = a10 * s00c + a11 * s01c;
  e.u11 = a10 * s01c + a11 * s11c;
  e.u01s = 0.5f * (u01 + u10);
  return e;
}

// planes 1-11 of out (w_prev, pd, K, cov_upd, z_exp) for slot pm
__device__ __forceinline__ void write_planes(float* out, size_t PM, size_t pm,
                                             const SlotEkf& e, float wp) {
  out[PM + pm] = wp;
  out[2 * PM + pm] = e.s.pd;
  out[3 * PM + pm] = e.k00;
  out[4 * PM + pm] = e.k01;
  out[5 * PM + pm] = e.k10;
  out[6 * PM + pm] = e.k11;
  out[7 * PM + pm] = e.u00;
  out[8 * PM + pm] = e.u01s;
  out[9 * PM + pm] = e.u11;
  out[10 * PM + pm] = e.s.r;
  out[11 * PM + pm] = e.b;
}

// one cell of the gated weight table (RBPHDFilter.hpp:620-659)
__device__ __forceinline__ float cell_weight(const Params& prm, float zr,
                                             float zb, bool zm, float r,
                                             float b, float i00, float i01,
                                             float i11, float norm, float pd,
                                             float wv) {
  float v = 0.f;
  if (zm) {
    const float ir = zr - r;
    const float ib = wrap_angle(zb - b);
    const bool gate_ok = (prm.t_r <= 0.f || fabsf(ir) <= prm.t_r) &&
                         (prm.t_b <= 0.f || fabsf(ib) <= prm.t_b);
    const float md2 = i00 * ir * ir + 2.0f * i01 * ir * ib + i11 * ib * ib;
    const float lik = finite_or_zero(expf(-0.5f * md2) / norm);
    if (gate_ok && md2 <= prm.md_t2 && lik > 0.f) v = pd * wv * lik;
  }
  return v;
}

// the missed-detection weight of a slot with flags f from its table row's
// sum (RBPHDFilter.hpp:686-706)
__device__ __forceinline__ float missed_weight(int f, float pd, float wv,
                                               float row, float birth_w) {
  float w_miss = (1.0f - pd) * wv;
  const float delta = pd * wv - row;
  if ((f & kClose) && wv > birth_w && delta > 0.f)
    w_miss = fminf(w_miss + delta, 1.0f);
  return (f & kAlive) ? w_miss : wv;
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
// Bit r of tabmask: slot lane + 32 r is in the table; the others' entries
// are zero and were not written this chunk.
// kTail: the column sum is given (cs_given, clutter included) and the
// picked slot numbers are offset by m_off.
template <int kMode>
__device__ void column(float* col, unsigned tabmask, int M, int T, int Zc,
                       int k, bool zm, float clutter, int lane, size_t p,
                       float* colsum_out, bool* unused_out, float* cand_w,
                       int64_t* cand_m, float cs_given, int m_off) {
  float c;
  if constexpr (kMode == kTail) {
    c = cs_given;
  } else {
    float s = 0.f;
    for (int j = lane, r = 0; j < M; j += 32, ++r)
      if ((tabmask >> r) & 1u) s += col[j];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    c = clutter + s;
  }
  bool any = false;
  for (int j = lane, r = 0; j < M; j += 32, ++r) {
    const float v = (tabmask >> r) & 1u ? col[j] : 0.f;
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
  for (int t = 0; t < T; ++t) {
    unsigned best = kPadKey;
    int bi = M;
    for (int j = lane, r = 0; j < M; j += 32, ++r) {
      const unsigned kj = (taken >> r) & 1u ? kZeroKey : order_key(col[j]);
      if (kj > best) { best = kj; bi = j; }
    }
    unsigned g, idx;
    warp_first_argmax(best, bi, g, idx);
    if (lane == 0) {
      const size_t o = p * T * Zc + static_cast<size_t>(t) * Zc + k;
      cand_w[o] = key_value(g);
      cand_m[o] = min(static_cast<int>(idx), M - 1) + m_off;
    }
    if (idx < static_cast<unsigned>(M) && lane == static_cast<int>(idx & 31))
      taken |= 1u << (idx >> 5);
  }
}

// Phase 3 for one column over the table's slots only: the entry of the
// table's slot number q = lane + 32 c (slot index sm[c], increasing with
// q; -1 past the last) is held by lane q % 32; every other slot's entry is
// zero.  Same results as column() but on ceil(ntab / 32) entries a lane.
// Returns false, having written nothing, when an entry is negative or NaN:
// then the T rounds may pick zeros outside the table, and column() runs.
template <int CR, int kMode>
__device__ bool column_compact(float* col, const int* sm, unsigned tabmask,
                               int M, int T, int Zc, int k, bool zm,
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
      if ((tabmask >> r) & 1u) s += col[j];
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
    if (!((tabmask >> r) & 1u)) col[j] = xz;
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
template <int kMode>
__global__ void __launch_bounds__(kMaxThreads, 2) map_update2d_kernel(
    Params prm, int M, int Zc, int T, int ZB, int m_off,
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
  // [ZB, M] (the wrapper's launch_plan sizes it the same way)
  extern __shared__ float smem[];
  float* s_z = smem;
  int* s_zm = reinterpret_cast<int*>(s_z + 2 * Zc);
  float* s_r = reinterpret_cast<float*>(s_zm + Zc);
  float* s_b = s_r + M;
  float* s_i00 = s_b + M;
  float* s_i01 = s_i00 + M;
  float* s_i11 = s_i01 + M;
  float* s_norm = s_i11 + M;
  float* s_pd = s_norm + M;
  float* s_w = s_pd + M;
  float* s_row = s_w + M;      // row sums of the normalised table
  int* s_flag = reinterpret_cast<int*>(s_row + M);
  unsigned* s_tabw = reinterpret_cast<unsigned*>(s_flag + M);  // [W]
  float* tab = reinterpret_cast<float*>(s_tabw + (M + 31) / 32);

  // output planes, each [P, M], then col_sum [P, Zc] and cand_w [P, T*Zc];
  // kHead writes the planes but w and the column sums without clutter,
  // kTail w [P, M] then cand_w
  const int P = gridDim.x;
  const size_t PM = static_cast<size_t>(P) * M;
  float* w_out = out;
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
      const float wv = w[pm];
      const bool alv = alive[pm];
      const SlotEkf e = slot_ekf(prm, px, py, pth, mx[pm], my[pm], c00[pm],
                                 c01[pm], c11[pm], alv);
      if constexpr (kMode != kTail)
        write_planes(out, PM, pm, e, alv ? wv : w_prev[pm]);

      s_r[m] = e.s.r;
      s_b[m] = e.b;
      s_i00[m] = e.i00;
      s_i01[m] = e.i01;
      s_i11[m] = e.i11;
      s_norm[m] = e.norm;
      s_pd[m] = e.s.pd;
      s_w[m] = wv;
      s_row[m] = 0.f;
      // a cell of this slot can be nonzero only if it is alive, detectable
      // and in range (the likelihood is zeroed out of range)
      in_table = alv && e.s.pd > 0.f && e.s.mvalid;
      s_flag[m] = (alv ? kAlive : 0) | (e.s.close ? kClose : 0);
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
    tabmask |= ((word >> lane) & 1u) << r;
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
        const float v = cell_weight(prm, s_z[2 * k], s_z[2 * k + 1],
                                    s_zm[k] != 0, r, b, i00, i01, i11, norm,
                                    pd, wv);
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
          if ((tabmask >> r) & 1u) s += col[j];
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(kFull, s, off);
        if (lane == 0) colsum_out[p * Zc + k] = s;
      } else {
        const bool zm = s_zm[k] != 0;
        const float cs_given = kMode == kTail ? colsum_in[p * Zc + k] : 0.f;
        const bool done =
            ntab <= 32
                ? column_compact<1, kMode>(col, sm, tabmask, M, T, Zc, k, zm,
                                           prm.clutter, lane, p, colsum_out,
                                           unused_out, cand_w, cand_m,
                                           cs_given, m_off)
            : ntab <= 64
                ? column_compact<2, kMode>(col, sm, tabmask, M, T, Zc, k, zm,
                                           prm.clutter, lane, p, colsum_out,
                                           unused_out, cand_w, cand_m,
                                           cs_given, m_off)
                : false;
        if (!done)
          column<kMode>(col, tabmask, M, T, Zc, k, zm, prm.clutter, lane, p,
                        colsum_out, unused_out, cand_w, cand_m, cs_given,
                        m_off);
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
    w_out[pm] = missed_weight(s_flag[m], s_pd[m], s_w[m], s_row[m],
                              prm.birth_w);
  }
}


// Phase 3 of the large form for one column (a warp) over the list of the
// table's slots: this lane's entries col[32 i + lane], i < cnt (slot[]
// ascending with i), ntab in all.  Every other
// slot's entry is xz = 0 / col_sum (written to xz_out[k] for the row
// sums).  The picks are the small form's T rounds of first-argmax with a
// picked entry keyed as +0: first the entries keyed above +0 (the slots
// outside the table among them where xz is a positive NaN), largest first
// and lowest slot first among equals, each round the next after the last
// pick; then, every round, the lowest slot keyed +0 (a picked one
// included); or, where none is and nothing was picked, the first round's
// largest entry below +0, then that slot as +0.  first_nt: the lowest slot
// outside the table (M if none).
template <int kMode>
__device__ void column_tab(float* col, const int* slot, const unsigned* tabw,
                           int cnt, int ntab, int first_nt, int M,
                           int T, int Zc, int k, bool zm, float clutter,
                           int lane, size_t p, float* colsum_out,
                           bool* unused_out, float* cand_w, int64_t* cand_m,
                           float cs_given, int m_off, float* xz_out) {
  float c;
  if constexpr (kMode == kTail) {
    c = cs_given;
  } else {
    // the small form's order: lane partials over the lane's slots
    // lane + 32 r in the table, ascending, then the butterfly
    float s = 0.f;
    for (int e = lane; e < 32 * cnt; e += 32) s += col[e];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    c = clutter + s;
  }
  const float xz = zm ? div_nz(0.f, c) : 0.f;
  bool any = false;
  int npos = 0, zl = M;  // entries keyed above +0; the first keyed +0
  for (int e = lane; e < 32 * cnt; e += 32) {
    const float x = zm ? div_nz(col[e], c) : 0.f;
    col[e] = x;
    any |= x > 0.f;
    const unsigned key = order_key(x);
    npos += key > kZeroKey;
    if (key == kZeroKey && zl == M) zl = slot[e];
  }
  any = __any_sync(kFull, any);
  if (lane == 0) {
    if constexpr (kMode == kWhole) colsum_out[p * Zc + k] = c;
    unused_out[p * Zc + k] = zm && !any;
    xz_out[k] = xz;
  }
  const int n_out = M - ntab;  // slots outside the table, all keyed kx
  const unsigned kx = order_key(xz);
  npos = __reduce_add_sync(kFull, npos) + (kx > kZeroKey ? n_out : 0);

  const size_t o = p * T * Zc + k;
  unsigned gk = 0xffffffffu;  // the last pick, above every key at first
  int gi = -1, minpick = M, t = 0;
  for (; t < T && t < npos; ++t) {
    unsigned best = kPadKey;
    int bi = M;
    for (int e = lane; e < 32 * cnt; e += 32) {
      const unsigned key = order_key(col[e]);
      if (key > kZeroKey && key <= gk && key > best) {
        const int m = slot[e];
        if (key < gk || m > gi) {
          best = key;
          bi = m;
        }
      }
    }
    unsigned g, idx;
    warp_first_argmax(best, bi, g, idx);
    if (kx > kZeroKey && n_out > 0) {
      const int nxt = kx < gk    ? first_nt
                      : kx == gk ? next_unset(tabw, gi + 1, M)
                                 : M;
      if (nxt < M && (kx > g || (kx == g && static_cast<unsigned>(nxt) < idx))) {
        g = kx;
        idx = nxt;
      }
    }
    if (lane == 0) {
      cand_w[o + static_cast<size_t>(t) * Zc] = key_value(g);
      cand_m[o + static_cast<size_t>(t) * Zc] = idx + m_off;
    }
    gk = g;
    gi = static_cast<int>(idx);
    minpick = min(minpick, gi);
  }
  if (t == T) return;
  int zidx = static_cast<int>(
      __reduce_min_sync(kFull, static_cast<unsigned>(zl)));
  if (kx == kZeroKey) zidx = min(zidx, first_nt);
  zidx = min(zidx, minpick);
  unsigned fk = kZeroKey;
  int fi = zidx;
  if (zidx >= M) {
    // nothing picked and no entry keyed +0: every entry is below it
    unsigned best = kPadKey;
    int bi = M;
    for (int e = lane; e < 32 * cnt; e += 32) {
      const unsigned key = order_key(col[e]);
      if (key > best) {
        best = key;
        bi = slot[e];
      }
    }
    if (lane == 0 && first_nt < M &&
        (kx > best || (kx == best && best != kPadKey && first_nt < bi))) {
      best = kx;
      bi = first_nt;
    }
    unsigned g, idx;
    warp_first_argmax(best, bi, g, idx);
    if (lane == 0) {
      cand_w[o + static_cast<size_t>(t) * Zc] = key_value(g);
      cand_m[o + static_cast<size_t>(t) * Zc] =
          min(static_cast<int>(idx), M - 1) + m_off;
    }
    ++t;
    if (idx < static_cast<unsigned>(M)) {
      fi = static_cast<int>(idx);
    } else {  // a lone NaN key below all: nothing taken, the same each round
      fk = g;
      fi = M - 1;
    }
  }
  for (int tt = t + lane; tt < T; tt += 32) {
    cand_w[o + static_cast<size_t>(tt) * Zc] = key_value(fk);
    cand_m[o + static_cast<size_t>(tt) * Zc] = fi + m_off;
  }
}

// The large form (M > 1024): see the file's head.  smem_words: the dynamic
// shared memory in words; stash_ws: the workspace ([P, 11 M32] floats,
// M32 = 32 ceil(M / 32)) or null; stats (or null): [0] the largest ntab, [1] the CTAs whose stash went
// to the workspace, [2] the most table chunks of a CTA.
template <int kMode>
__global__ void __launch_bounds__(kMaxThreads, 2) map_update2d_large(
    Params prm, int M, int Zc, int T, int smem_words, int m_off,
    float* __restrict__ stash_ws, int* __restrict__ stats,
    const float* __restrict__ colsum_in,
    const float* __restrict__ pose, const float* __restrict__ mx,
    const float* __restrict__ my, const float* __restrict__ c00,
    const float* __restrict__ c01, const float* __restrict__ c11,
    const float* __restrict__ w, const float* __restrict__ w_prev,
    const bool* __restrict__ alive, const float* __restrict__ z,
    const bool* __restrict__ zmask, float* __restrict__ out,
    bool* __restrict__ unused_out, int64_t* __restrict__ cand_m) {
  const size_t p = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nthr >> 5;
  const int W = (M + 31) / 32;

  // shared memory: z [Zc, 2], z mask [Zc], each column's entry outside the
  // table [Zc], the table bits [W], the bits of the alive, close slots
  // outside the table [W], table slots by warp and lane [warps, 32]; then
  // the stash (11 planes [n_ent], unless in the workspace) and the table
  // chunk [zb, n_ent] (the wrapper's launch_plan sizes them for n_ent =
  // 32 W)
  extern __shared__ float smem[];
  float* s_z = smem;
  int* s_zm = reinterpret_cast<int*>(s_z + 2 * Zc);
  float* s_xz = reinterpret_cast<float*>(s_zm + Zc);
  unsigned* s_tabw = reinterpret_cast<unsigned*>(s_xz + Zc);
  unsigned* s_cwo = s_tabw + W;
  int* s_part = reinterpret_cast<int*>(s_cwo + W);
  float* dyn = reinterpret_cast<float*>(s_part + 32 * n_warps);
  const int avail = smem_words - (4 * Zc + 2 * W + 32 * n_warps);

  // outputs as the small form's
  const int P = gridDim.x;
  const size_t PM = static_cast<size_t>(P) * M;
  float* w_out = out;
  float* colsum_out = out + 12 * PM;
  float* cand_w = kMode == kTail ? out + PM
                                 : colsum_out + static_cast<size_t>(P) * Zc;
  const float px = pose[3 * p], py = pose[3 * p + 1], pth = pose[3 * p + 2];

  for (int k = tid; k < Zc; k += nthr) {
    s_z[2 * k] = z[2 * k];
    s_z[2 * k + 1] = z[2 * k + 1];
    s_zm[k] = zmask[k] ? 1 : 0;
  }
  // ---- 1a. the table's slots: a warp takes the words [r0, r1)
  const int per_warp = (W + n_warps - 1) / n_warps;
  const int r0 = min(W, warp * per_warp), r1 = min(W, r0 + per_warp);
  int cnt = 0;
  for (int r = r0; r < r1; ++r) {
    const int m = 32 * r + lane;
    bool tab = false, cwo = false;
    if (m < M) {
      const size_t pm = p * M + m;
      const bool alv = alive[pm];
      const SlotRange sr = slot_range(prm, px, py, mx[pm], my[pm], alv);
      tab = alv && sr.pd > 0.f && sr.mvalid;
      cwo = sr.close && !tab;  // close implies alive
    }
    const unsigned tb = __ballot_sync(kFull, tab);
    const unsigned cb = __ballot_sync(kFull, cwo);
    if (lane == 0) {
      s_tabw[r] = tb;
      s_cwo[r] = cb;
    }
    cnt += tab;
  }
  s_part[warp * 32 + lane] = cnt;
  __syncthreads();
  // this lane's slots in the table (tot), and those of the warps before
  // (pre: this warp's first entry is 32 pre + lane); the list's entries
  int tot = 0, pre = 0;
  for (int v = 0; v < n_warps; ++v) {
    const int c = s_part[v * 32 + lane];
    tot += c;
    pre += v < warp ? c : 0;
  }
  const int ntab = __reduce_add_sync(kFull, tot);
  const int n_ent = 32 * __reduce_max_sync(kFull, static_cast<unsigned>(tot));

  // the stash in shared memory when the whole table fits beside it (or no
  // workspace was given: then the plan leaves room for a column), else in
  // this particle's part of the workspace
  const bool st_global =
      stash_ws != nullptr && (11 + Zc) * static_cast<long>(n_ent) > avail;
  const int zb = max(1, min(Zc, n_ent == 0 ? Zc
                                           : (avail - (st_global ? 0 : 11 * n_ent)) /
                                                 n_ent));
  float* st = st_global ? stash_ws + p * static_cast<size_t>(11 * 32 * W)
                        : dyn;
  float* s_r = st;
  float* s_b = st + n_ent;
  float* s_i00 = s_b + n_ent;
  float* s_i01 = s_i00 + n_ent;
  float* s_i11 = s_i01 + n_ent;
  float* s_norm = s_i11 + n_ent;
  float* s_pd = s_norm + n_ent;
  float* s_w = s_pd + n_ent;
  float* s_row = s_w + n_ent;  // row sums of the normalised table
  int* s_flag = reinterpret_cast<int*>(s_row + n_ent);
  int* s_slot = s_flag + n_ent;  // -1: a hole
  float* tab = st_global ? dyn : dyn + 11 * n_ent;
  if (stats != nullptr && tid == 0) {
    atomicMax(&stats[0], ntab);
    atomicAdd(&stats[1], st_global ? 1 : 0);
    atomicMax(&stats[2], (Zc + zb - 1) / zb);
  }

  // ---- 1b. per slot, the same words: the plane outputs, the table's
  // slots' stash at their place in the list, the other slots' weight
  if (warp == 0)
    for (int i = tot; i < n_ent / 32; ++i) s_slot[32 * i + lane] = -1;
  int e = 32 * pre + lane;
  for (int r = r0; r < r1; ++r) {
    const int m = 32 * r + lane;
    if (m >= M) break;
    const size_t pm = p * M + m;
    const float wv = w[pm];
    const bool alv = alive[pm];
    const SlotEkf x = slot_ekf(prm, px, py, pth, mx[pm], my[pm], c00[pm],
                               c01[pm], c11[pm], alv);
    if constexpr (kMode != kTail)
      write_planes(out, PM, pm, x, alv ? wv : w_prev[pm]);
    const int f = (alv ? kAlive : 0) | (x.s.close ? kClose : 0);
    if ((s_tabw[r] >> lane) & 1u) {
      s_r[e] = x.s.r;
      s_b[e] = x.b;
      s_i00[e] = x.i00;
      s_i01[e] = x.i01;
      s_i11[e] = x.i11;
      s_norm[e] = x.norm;
      s_pd[e] = x.s.pd;
      s_w[e] = wv;
      s_row[e] = 0.f;
      s_flag[e] = f;
      s_slot[e] = m;
      e += 32;
    } else if constexpr (kMode != kHead) {
      // the row sum outside the table folds zeros (the NaN case below)
      w_out[pm] = missed_weight(f, x.s.pd, wv, 0.f, prm.birth_w);
    }
  }
  const int first_nt = ntab < M ? next_unset(s_tabw, 0, M) : M;
  __syncthreads();

  for (int k0 = 0; k0 < Zc; k0 += zb) {
    const int nk = min(zb, Zc - k0);

    // ---- 2. the table chunk [nk, n_ent]: thread u = e + n_ent g takes
    // list entry e, its fields in registers, and the columns g, g + groups,
    // ... (a hole's cells are never read)
    const int groups = max(1, nthr / max(n_ent, 1));
    for (int u = tid; u < n_ent * groups; u += nthr) {
      const int q = u % n_ent;
      if (s_slot[q] < 0) continue;
      const float r = s_r[q], b = s_b[q], i00 = s_i00[q], i01 = s_i01[q],
                  i11 = s_i11[q], norm = s_norm[q], pd = s_pd[q],
                  wv = s_w[q];
      for (int kk = u / n_ent; kk < nk; kk += groups) {
        const int k = k0 + kk;
        tab[kk * n_ent + q] = cell_weight(prm, s_z[2 * k], s_z[2 * k + 1],
                                         s_zm[k] != 0, r, b, i00, i01, i11,
                                         norm, pd, wv);
      }
    }
    __syncthreads();

    // ---- 3. a warp per column
    for (int kk = warp; kk < nk; kk += n_warps) {
      const int k = k0 + kk;
      float* col = tab + kk * n_ent;
      if constexpr (kMode == kHead) {
        // the block's column sum, in the small form's order, no clutter
        float s = 0.f;
        for (int q = lane; q < 32 * tot; q += 32) s += col[q];
        for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
        if (lane == 0) colsum_out[p * Zc + k] = s;
      } else {
        column_tab<kMode>(col, s_slot, s_tabw, tot, ntab, first_nt, M,
                          T, Zc, k, s_zm[k] != 0, prm.clutter, lane, p,
                          colsum_out, unused_out, cand_w, cand_m,
                          kMode == kTail ? colsum_in[p * Zc + k] : 0.f,
                          m_off, s_xz);
      }
    }
    __syncthreads();

    // ---- 4a. row sums in column order
    if constexpr (kMode != kHead) {
      for (int q = tid; q < n_ent; q += nthr) {
        if (s_slot[q] < 0) continue;
        float row = s_row[q];
        for (int kk = 0; kk < nk; ++kk) row += tab[kk * n_ent + q];
        s_row[q] = row;
      }
    }
    if (k0 + zb < Zc) __syncthreads();  // the next chunk overwrites tab
  }
  if constexpr (kMode == kHead) return;

  // ---- 4b. the table's slots' missed-detection weights; each thread
  // reads the row sums it wrote
  for (int q = tid; q < n_ent; q += nthr)
    if (s_slot[q] >= 0)
      w_out[p * M + s_slot[q]] = missed_weight(s_flag[q], s_pd[q], s_w[q],
                                               s_row[q], prm.birth_w);
  // outside the table the row sum is the fold of the columns' xz: a zero,
  // or NaN, which ends the compensation of the alive, close slots there
  float fold = 0.f;
  for (int k = 0; k < Zc; ++k) fold += s_xz[k];
  if (fold != fold) {
    for (int m = tid; m < M; m += nthr)
      if ((s_cwo[m >> 5] >> (m & 31)) & 1u)
        w_out[p * M + m] = missed_weight(kAlive | kClose, 1.0f,
                                         w[p * M + m], fold, prm.birth_w);
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

// fixed words of the large form's shared memory before the stash and the
// table, which the plan sizes for 32 ceil(M / 32) entries (the wrapper's
// launch_plan counts them the same way)
int large_fixed_words(int M, int Zc, int threads) {
  return 4 * Zc + 2 * ((M + 31) / 32) + threads;
}

// threads, smem and zb come from the wrapper's launch_plan; the form
// follows from M.  The small form (M <= 1024) takes no stash; the large
// form ignores zb (its chunk follows from the table's slots), and without a
// stash ([P, 11, M32] floats, M32 = 32 ceil(M / 32)) its shared memory must
// hold the stash of M32 entries and a column.
template <int kMode>
int launch(int P, int M, int Zc, int T, int threads, int smem, int zb,
           int m_off, void* stash, int* stats, const float* params,
           const void* colsum_in, const void* pose, const void* mx,
           const void* my, const void* c00, const void* c01, const void* c11,
           const void* w, const void* w_prev, const void* alive,
           const void* z, const void* zmask, void* out, void* unused_out,
           void* cand_m, void* stream) {
  const bool large = M > 32 * 32;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || M < 1 ||
      (!large && (zb < 1 || stash != nullptr)) ||
      (large && smem / 4 < large_fixed_words(M, Zc, threads) +
                               (stash != nullptr ? 1 : 12) * 32 *
                                   ((M + 31) / 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm = unpack_params(params);
  auto small_k = map_update2d_kernel<kMode>;
  auto large_k = map_update2d_large<kMode>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        large ? cudaFuncSetAttribute(
                    large_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
              : cudaFuncSetAttribute(
                    small_k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cs = static_cast<const float*>(colsum_in);
  const auto* ps = static_cast<const float*>(pose);
  const auto* x = static_cast<const float*>(mx);
  const auto* y = static_cast<const float*>(my);
  const auto* a = static_cast<const float*>(c00);
  const auto* b = static_cast<const float*>(c01);
  const auto* c = static_cast<const float*>(c11);
  const auto* wi = static_cast<const float*>(w);
  const auto* wp = static_cast<const float*>(w_prev);
  const auto* al = static_cast<const bool*>(alive);
  const auto* zz = static_cast<const float*>(z);
  const auto* zm = static_cast<const bool*>(zmask);
  auto* o = static_cast<float*>(out);
  auto* uo = static_cast<bool*>(unused_out);
  auto* cm = static_cast<int64_t*>(cand_m);
  if (large)
    large_k<<<P, threads, smem, st>>>(prm, M, Zc, T, smem / 4, m_off,
                                      static_cast<float*>(stash), stats, cs,
                                      ps, x, y, a, b, c, wi, wp, al, zz, zm,
                                      o, uo, cm);
  else
    small_k<<<P, threads, smem, st>>>(prm, M, Zc, T, zb, m_off, cs, ps, x, y,
                                      a, b, c, wi, wp, al, zz, zm, o, uo, cm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: one float buffer of 12 planes [P, M] (w, w_prev, pd, K00, K01, K10,
// K11, cov_upd 00/01/11, z_exp r/b), then col_sum [P, Zc], then cand_w
// [P, T * Zc].  stash: the large form's workspace (launch_plan) or null;
// stats: null, or three ints the large form updates (see
// map_update2d_large).
extern "C" int map_update2d_launch(
    int P, int M, int Zc, int T, int threads, int smem, int zb,
    const float* params, const void* pose, const void* mx, const void* my,
    const void* c00, const void* c01, const void* c11, const void* w,
    const void* w_prev, const void* alive, const void* z, const void* zmask,
    void* out, void* unused_out, void* cand_m, void* stash, int* stats,
    void* stream) {
  return launch<kWhole>(P, M, Zc, T, threads, smem, zb, 0, stash, stats,
                        params, nullptr, pose, mx, my, c00, c01, c11, w,
                        w_prev, alive, z, zmask, out, unused_out, cand_m,
                        stream);
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
  auto fn = tail ? launch<kTail> : launch<kHead>;
  return fn(P, M, Zc, T, threads, smem, zb, m_off, stash, nullptr, params,
            colsum_in, pose, mx, my, c00, c01, c11, w, w_prev, alive, z,
            zmask, out, unused_out, cand_m, stream);
}
