// Gaussian-mixture merge fixpoint for 3-D landmark maps (x, y, tree
// diameter), for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/merge3d.py
// (_merge_kernel, entry merge3d) and the absorber tiers of its ops/gm.py.
// The pass is merge2d.cu's, widened to D=3: the two-way Mahalanobis gate over
// the pairs i < j (both alive), the safe-absorber rule (a slot with a smaller
// gated partner does not absorb this pass), lowest-index claiming, and a
// moment-matched merge with covariance inflation (GaussianMixture.hpp:
// 394-475); absorbed slots die when the pair's weight sum is non-zero.
// Passes repeat until one merges nothing or max_passes have run; the first
// always runs.
//
// Arithmetic: the plain twin's (ops/gm.py:_merge_pass with planar.inv_sym
// and planar.quad_sym for D=3), term for term and in its order, with IEEE
// division and sqrt.  The library is built with -fmad=false
// (ops/kernels/build.py), so no product is fused into a sum: the gate's
// Mahalanobis distances round as the twin's do, and a pair on the gate's
// boundary is decided as the twin decides it.
//
// What bounds it on the card: the data is 11 f32 planes + alive x P x N
// (4.6 MB in and out at P=100, N=512); each pass is O(n_alive^2 / 2) gate
// tests of ~45 FLOP per particle, on one SM per particle.  On the Victoria
// Park path's maps (~300-400 alive slots from mid-stream on) one pass runs
// and nothing merges, and the gate rows are ~80% of the kernel: with
// 32 warps an SM's four schedulers issue them near their rate (two quads
// of 12 FMUL and 5 FADD a pair: -fmad=false).  The first port ran one
// thread per slot, and each thread scanned the slots below it one gate at
// a time for its lowest gated partner (up to hi dependent gate
// evaluations, the whole pass when no pair is gated), then again for its
// lowest safe partner, and every slot recomputed its inverse every pass.
//
// Design: merge2d.cu's.  One CTA per particle (100 CTAs on 132 SMs at Victoria
// Park's P=100: one wave), with 32 warps (one CTA an SM) and one thread per
// slot for the slot-wise phases (the small form, N <= 1024).  The slot fields
// live in shared memory for the whole fixpoint, the gate fields of a slot as
// two float4 and a float, and the pass loop runs inside the kernel with
// __syncthreads_or as the "any merged" test.  The pair search is the gate bit
// mask of merge_bitmask.cuh: a warp evaluates the 32 gates of a row word per
// ballot, two rows at a time, each gate once a pass, and a slot finds its
// absorber in ceil(j / 32) word tests.  The mask is N x ceil(N / 32) words
// (32 KB at N=512, 128 KB at N=1024).  S^-1 is computed once at entry and again
// only by an absorber, for its merged covariance.  A pass has three barriers:
// after the gate rows, after the claims, and the "any merged" test; each
// absorber reads its partner and writes its own fields in one phase
// (absorbers are safe, so unclaimed, and absorbed slots absorb nothing).  The
// i-axis of the pair search is bounded per CTA by one past its highest alive
// slot (exact: slots only die during the fixpoint), which replaces the TPU's
// static absorber tiers; the header bounds the j-axis the same way.
//
// Large form (N > 1024; merge3d_large): merge2d.cu's large form with this
// file's gate.  No mask: safe_sweep2 (two rows a warp, each down from j to
// its first gated partner), safe_words and claim_sweep (each unsafe row up
// the listed safe words, safe lanes only) of merge_bitmask.cuh, Gate3's
// arithmetic, so the same claims.  What the pass loop touches stays in
// shared memory: the gate fields (two float4 and a float, 36 B a slot),
// the claims (4 B), the alive bits, the safe bits and the list of safe
// words (82,704 B at N=2048 with the 16-byte header, ~40.4 B a slot: up
// to 5,756 slots).  The covariances, the weights and w_prev are touched
// only by absorbers: they are copied once into the output buffer and
// merged there in place, and S^-1 is computed at entry only for alive
// slots.  Past 5,756 slots the gate fields, and past 53,125 the rest too,
// move to a global workspace (merge_bitmask::large_tier, the wrapper's
// launch_plan) through the same code.  One CTA a particle, its 1024
// threads striding over the slots; the rules and the arithmetic are the
// small form's, so a map padded with dead slots merges to the same bits in
// either form.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_bitmask.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kCov = 6;  // packed c00 c01 c02 c11 c12 c22

// two-way gate for the pair k < j, both alive (GaussianMixture.hpp:430-441).
// A slot's gate fields are two float4, (x, y, d, S^-1_00) and (2 S^-1_01,
// 2 S^-1_02, S^-1_11, 2 S^-1_12), and S^-1_22: the factor 2 is exact, and
// 2 * a01 * v0 * v1 multiplies left to right, so each term and the sum in
// planar.quad_sym's order round as the twin's.
struct Gate3 {
  const float4* ga;
  const float4* gb;
  const float* i22;
  float t2;
  struct Fields {
    float4 a;
    float4 b;
    float c;
  };
  __device__ Fields fields(int s) const { return {ga[s], gb[s], i22[s]}; }
  // v^T S^-1 v: m00 v0 v0, 2 m01 v0 v1, 2 m02 v0 v2, m11 v1 v1,
  // 2 m12 v1 v2, m22 v2 v2
  static __device__ float quad(const Fields& f, float v0, float v1,
                               float v2) {
    float q = f.a.w * v0 * v0;
    q = q + f.b.x * v0 * v1;
    q = q + f.b.y * v0 * v2;
    q = q + f.b.z * v1 * v1;
    q = q + f.b.w * v1 * v2;
    q = q + f.c * v2 * v2;
    return q;
  }
  __device__ bool test(const Fields& k, const Fields& j) const {
    const float v0 = j.a.x - k.a.x;
    const float v1 = j.a.y - k.a.y;
    const float v2 = j.a.z - k.a.z;
    // both quads, no branch between them: their chains interleave
    return (quad(k, v0, v1, v2) <= t2) | (quad(j, v0, v1, v2) <= t2);
  }
};

// S^-1 of the packed covariance by the adjugate (planar.det_sym / inv_sym
// for D=3) into the gate fields, as the twin rounds it
__device__ __forceinline__ void invert(const float* c, float4& ga, float4& gb,
                                       float& i22) {
  const float a = c[0], b = c[1], cc = c[2];
  const float d = c[3], e = c[4], f = c[5];
  const float det = a * (d * f - e * e) - b * (b * f - e * cc) +
                    cc * (b * e - d * cc);
  ga.w = (d * f - e * e) / det;
  gb.x = 2.0f * ((cc * e - b * f) / det);
  gb.y = 2.0f * ((b * e - cc * d) / det);
  gb.z = (a * f - cc * cc) / det;
  gb.w = 2.0f * ((cc * b - a * e) / det);
  i22 = (a * d - b * b) / det;
}

// inputs: mean [3, P, N], cov [6, P, N], w, w_prev [P, N]; out: one float
// buffer of 11 planes [P, N] (mean x/y/d, cov 00/01/02/11/12/22, w, w_prev).
// The small form: one thread a slot (blockDim >= N), its shared memory 19
// slot planes, the gate bit mask [N, W] and the safe-absorber words [W].
__global__ void __launch_bounds__(kMaxThreads) merge3d_kernel(
    float t2, float infl, int max_passes, int N,
    const float* __restrict__ mean, const float* __restrict__ cov,
    const float* __restrict__ w_in, const float* __restrict__ wp_in,
    const bool* __restrict__ alive_in, float* __restrict__ out,
    bool* __restrict__ alive_out) {
  // the layout (the wrapper's launch_plan sizes it the same way)
  const int W = merge_bitmask::words(N);
  extern __shared__ float4 smem[];
  // (x, y, d, S^-1_00), then (2 S^-1_01, 2 S^-1_02, S^-1_11, 2 S^-1_12)
  float4* s_ga = smem;
  float4* s_gb = s_ga + N;
  float* s_i22 = reinterpret_cast<float*>(s_gb + N);
  float* s_cov = s_i22 + N;           // kCov planes of N
  float* s_w = s_cov + kCov * N;
  float* s_wp = s_w + N;
  int* s_alive = reinterpret_cast<int*>(s_wp + N);
  int* s_jstar = s_alive + N;
  unsigned* s_gate = reinterpret_cast<unsigned*>(s_jstar + N);  // [N, W]
  unsigned* s_safe = s_gate + static_cast<size_t>(N) * W;       // [W]
  __shared__ int s_hi;

  const size_t PN = static_cast<size_t>(gridDim.x) * N;
  const size_t p0 = static_cast<size_t>(blockIdx.x) * N;
  using merge_bitmask::for_slots;

  // S^-1: once here, then again only where a merge changed S
  if (threadIdx.x == 0) s_hi = 0;
  for_slots(N, [&](int i) {
    const size_t pi = p0 + i;
    float c[kCov];
    #pragma unroll
    for (int t = 0; t < kCov; ++t) c[t] = s_cov[t * N + i] = cov[t * PN + pi];
    float4 ga, gb;
    ga.x = mean[pi];
    ga.y = mean[PN + pi];
    ga.z = mean[2 * PN + pi];
    invert(c, ga, gb, s_i22[i]);
    s_ga[i] = ga;
    s_gb[i] = gb;
    s_w[i] = w_in[pi];
    s_wp[i] = wp_in[pi];
    s_alive[i] = alive_in[pi] ? 1 : 0;
    s_jstar[i] = N;
  });
  merge_bitmask::clear_safe(s_safe, W);
  __syncthreads();
  for_slots(N, [&](int i) {
    if (s_alive[i]) atomicMax(&s_hi, i + 1);
  });
  __syncthreads();
  const int hi = s_hi;
  const Gate3 gate{s_ga, s_gb, s_i22, t2};

  for (int pass = 0; pass < max_passes; ++pass) {
    merge_bitmask::gate_rows(gate, s_alive, hi, W, s_gate, s_safe);
    __syncthreads();
    // a safe slot has no gated partner below it, so nothing to claim
    for_slots(hi, [&](int i) {
      if (!((s_safe[i >> 5] >> (i & 31)) & 1u))
        merge_bitmask::claim(i, s_alive, hi, W, s_gate, s_safe, s_jstar);
    });
    __syncthreads();

    // An absorber is safe, so no slot claims it, and an absorbed slot
    // absorbs nothing: each absorber alone reads its fields and its
    // partner's, and writes its own, so reads and writes need no barrier.
    bool any = false;
    for_slots(N, [&](int i) {
      const int js = s_jstar[i];
      if (js < N) {
        const float w1 = s_w[i], w2 = s_w[js];
        const float wm = w1 + w2;
        const bool ok = wm != 0.f;
        const float w1n = w1 / wm, w2n = w2 / wm;
        const float4 a1 = s_ga[i], a2 = s_ga[js];
        const float x1[3] = {a1.x, a1.y, a1.z};
        const float x2[3] = {a2.x, a2.y, a2.z};
        float nm[3], d1[3], d2[3];
        #pragma unroll
        for (int t = 0; t < 3; ++t) {
          nm[t] = x1[t] * w1n + x2[t] * w2n;
          d1[t] = nm[t] - x1[t];
          d2[t] = nm[t] - x2[t];
        }
        // packed (r, c) pairs in tri_index order
        const int pr[kCov] = {0, 0, 0, 1, 1, 2};
        const int pc[kCov] = {0, 1, 2, 1, 2, 2};
        float nc[kCov];
        #pragma unroll
        for (int t = 0; t < kCov; ++t) {
          const float* cp = s_cov + t * N;
          nc[t] = w1n * (cp[i] + infl * d1[pr[t]] * d1[pc[t]]) +
                  w2n * (cp[js] + infl * d2[pr[t]] * d2[pc[t]]);
        }
        if (ok) {
          float4 ga, gb;
          ga.x = nm[0];
          ga.y = nm[1];
          ga.z = nm[2];
          #pragma unroll
          for (int t = 0; t < kCov; ++t) s_cov[t * N + i] = nc[t];
          invert(nc, ga, gb, s_i22[i]);
          s_ga[i] = ga;
          s_gb[i] = gb;
          s_w[i] = wm;
          s_wp[i] = 0.f;
          s_alive[js] = 0;
        }
        any |= ok;
      }
      s_jstar[i] = N;
    });
    merge_bitmask::clear_safe(s_safe, W);
    if (!__syncthreads_or(any)) break;
  }

  for_slots(N, [&](int i) {
    const size_t pi = p0 + i;
    out[pi] = s_ga[i].x;
    out[PN + pi] = s_ga[i].y;
    out[2 * PN + pi] = s_ga[i].z;
    #pragma unroll
    for (int t = 0; t < kCov; ++t) out[(3 + t) * PN + pi] = s_cov[t * N + i];
    out[9 * PN + pi] = s_w[i];
    out[10 * PN + pi] = s_wp[i];
    alive_out[pi] = s_alive[i] != 0;
  });
}

using merge_bitmask::kAllShared;
using merge_bitmask::kFieldsGlobal;
using merge_bitmask::kAllGlobal;
// bytes of a slot's gate fields: two float4 and a float
constexpr size_t kFieldBytes = 36;

// The large form (N > 1024): see the file's head.  Shared memory (or, by
// kTier, this particle's part of ws, stride float4s): hi and the count of
// listed safe words, then the gate fields ga, gb [N] float4 and i22 [N]
// float, the claims (link) [N], the alive bit words, the safe bit words
// and the safe words' list [W each].  out's cov, w and w_prev planes hold
// the fields that only absorbers touch.
template <int kTier>
__global__ void __launch_bounds__(kMaxThreads) merge3d_large(
    float t2, float infl, int max_passes, int N,
    const float* __restrict__ mean, const float* __restrict__ cov,
    const float* __restrict__ w_in, const float* __restrict__ wp_in,
    const bool* __restrict__ alive_in, float* __restrict__ out,
    bool* __restrict__ alive_out, float4* __restrict__ ws, size_t stride) {
  using merge_bitmask::bit;
  const int W = merge_bitmask::words(N);
  extern __shared__ float4 smem[];
  int* s_hi = reinterpret_cast<int*>(smem);
  int* s_count = s_hi + 1;
  float4* ga = kTier == kAllShared ? smem + 1 : ws + blockIdx.x * stride;
  float4* gb = ga + N;
  float* i22 = reinterpret_cast<float*>(gb + N);
  int* link = kTier == kFieldsGlobal ? reinterpret_cast<int*>(smem + 1)
                                     : reinterpret_cast<int*>(i22 + N);
  unsigned* alive = reinterpret_cast<unsigned*>(link + N);
  unsigned* safe = alive + W;
  int* safe_list = reinterpret_cast<int*>(safe + W);

  const size_t PN = static_cast<size_t>(gridDim.x) * N;
  const size_t p0 = static_cast<size_t>(blockIdx.x) * N;
  float* o_cov = out + 3 * PN + p0;  // kCov planes, PN apart
  float* o_w = out + 9 * PN + p0;
  float* o_wp = out + 10 * PN + p0;

  if (threadIdx.x == 0) *s_hi = 0;
  __syncthreads();
  // the covariances and weights into out, the gate fields with S^-1 (once
  // here, then again only where a merge changed S), the alive bits by
  // ballot (a warp's lanes take 32 consecutive slots)
  for (int i = threadIdx.x; i < 32 * W; i += blockDim.x) {
    bool a = false;
    if (i < N) {
      const size_t pi = p0 + i;
      float c[kCov];
      #pragma unroll
      for (int t = 0; t < kCov; ++t)
        c[t] = o_cov[t * PN + i] = cov[t * PN + pi];
      o_w[i] = w_in[pi];
      o_wp[i] = wp_in[pi];
      float4 ai = {mean[pi], mean[PN + pi], mean[2 * PN + pi], 0.f};
      float4 bi = {0.f, 0.f, 0.f, 0.f};
      float ci = 0.f;
      a = alive_in[pi];
      if (a) invert(c, ai, bi, ci);  // a dead slot's is never read
      ga[i] = ai;
      gb[i] = bi;
      i22[i] = ci;
      link[i] = N;
    }
    const unsigned b = __ballot_sync(merge_bitmask::kFull, a);
    if ((i & 31) == 0) {
      alive[i >> 5] = b;
      safe[i >> 5] = 0;
      if (b) atomicMax(s_hi, (i & ~31) + 32 - __clz(b));
    }
  }
  __syncthreads();
  const int hi = *s_hi;
  const Gate3 gate{ga, gb, i22, t2};

  const int W_hi = merge_bitmask::words(hi);
  for (int pass = 0; pass < max_passes; ++pass) {
    merge_bitmask::safe_sweep2(gate, alive, hi, safe);
    __syncthreads();
    merge_bitmask::safe_words(safe, W_hi, safe_list, s_count);
    __syncthreads();
    merge_bitmask::claim_sweep(gate, alive, safe, safe_list, *s_count, hi,
                               link);
    __syncthreads();

    // An absorber is safe, so no slot claims it, and an absorbed slot
    // absorbs nothing: each absorber alone reads its fields and its
    // partner's, and writes its own, so reads and writes need no barrier.
    // The safe bits are read no more this pass: they are cleared here.
    bool any = false;
    for (int i = threadIdx.x; i < hi; i += blockDim.x) {
      if (i < W_hi) safe[i] = 0;
      const int js = link[i];
      if (js == N) continue;
      link[i] = N;
      const float w1 = o_w[i], w2 = o_w[js];
      const float wm = w1 + w2;
      const bool ok = wm != 0.f;
      const float w1n = w1 / wm, w2n = w2 / wm;
      const float4 a1 = ga[i], a2 = ga[js];
      const float x1[3] = {a1.x, a1.y, a1.z};
      const float x2[3] = {a2.x, a2.y, a2.z};
      float nm[3], d1[3], d2[3];
      #pragma unroll
      for (int t = 0; t < 3; ++t) {
        nm[t] = x1[t] * w1n + x2[t] * w2n;
        d1[t] = nm[t] - x1[t];
        d2[t] = nm[t] - x2[t];
      }
      // packed (r, c) pairs in tri_index order
      const int pr[kCov] = {0, 0, 0, 1, 1, 2};
      const int pc[kCov] = {0, 1, 2, 1, 2, 2};
      float nc[kCov];
      #pragma unroll
      for (int t = 0; t < kCov; ++t) {
        const float* cp = o_cov + t * PN;
        nc[t] = w1n * (cp[i] + infl * d1[pr[t]] * d1[pc[t]]) +
                w2n * (cp[js] + infl * d2[pr[t]] * d2[pc[t]]);
      }
      if (ok) {
        float4 ai = {nm[0], nm[1], nm[2], 0.f};
        float4 bi;
        #pragma unroll
        for (int t = 0; t < kCov; ++t) o_cov[t * PN + i] = nc[t];
        invert(nc, ai, bi, i22[i]);
        ga[i] = ai;
        gb[i] = bi;
        o_w[i] = wm;
        o_wp[i] = 0.f;
        atomicAnd(&alive[js >> 5], ~(1u << (js & 31)));
      }
      any |= ok;
    }
    if (!__syncthreads_or(any)) break;
  }

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const size_t pi = p0 + i;
    const float4 a = ga[i];
    out[pi] = a.x;
    out[PN + pi] = a.y;
    out[2 * PN + pi] = a.z;
    alive_out[pi] = bit(alive, i);
  }
}

}  // namespace

// threads (a multiple of 32; at least N in the small form), smem and the
// workspace come from the wrapper's launch_plan.  The form follows from
// N: the small form (N <= 1024) keeps fields and masks in smem bytes of
// shared memory; the large form in smem and, past 5,756 slots, in ws
// (ws_bytes), as merge_bitmask::large_layout checks.
extern "C" int merge3d_launch(int P, int N, int threads, int smem, float t2,
                              float infl, int max_passes, const void* mean,
                              const void* cov, const void* w, const void* wp,
                              const void* alive, void* out, void* alive_out,
                              void* ws, size_t ws_bytes, void* stream) {
  if (threads > kMaxThreads || threads % 32 != 0 || threads < 32 || N < 1 ||
      smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mean);
  const auto* c = static_cast<const float*>(cov);
  const auto* wi = static_cast<const float*>(w);
  const auto* wpi = static_cast<const float*>(wp);
  const auto* ai = static_cast<const bool*>(alive);
  auto* o = static_cast<float*>(out);
  auto* ao = static_cast<bool*>(alive_out);
  if (N <= kMaxThreads) {
    if (threads < N) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          merge3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    merge3d_kernel<<<P, threads, smem, st>>>(t2, infl, max_passes, N, m, c,
                                             wi, wpi, ai, o, ao);
    return static_cast<int>(cudaGetLastError());
  }
  const auto lay =
      merge_bitmask::large_layout(kFieldBytes * N, P, N, smem, ws, ws_bytes);
  if (!lay.ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lay.tier == kAllShared      ? merge3d_large<kAllShared>
                : lay.tier == kFieldsGlobal ? merge3d_large<kFieldsGlobal>
                                            : merge3d_large<kAllGlobal>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<P, threads, smem, st>>>(t2, infl, max_passes, N, m, c, wi, wpi,
                                   ai, o, ao, static_cast<float4*>(ws),
                                   lay.stride);
  return static_cast<int>(cudaGetLastError());
}
