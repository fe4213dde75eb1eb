// Gaussian-mixture merge fixpoint for 2-D landmark maps, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/merge2d.py
// (_merge_kernel, entry merge2d) and its absorber-tier dispatch in
// its ops/gm.py.  Each pass applies the two-way Mahalanobis gate
// over the pairs i < j (both alive), the safe-absorber rule (a slot with a
// smaller gated partner does not absorb this pass), lowest-index claiming,
// and a moment-matched merge with covariance inflation
// (GaussianMixture.hpp:394-475), then kills the absorbed slots.  Passes
// repeat until one merges nothing or max_passes have run; the first always
// runs.  The arithmetic follows the plain twin, ops/gm.py:_merge_pass, term
// for term, and the kernel is built with -fmad=false (ops/kernels/build.py)
// so that no product is fused into a sum: the gate decides boundary pairs
// as the twin decides them.
//
// What bounds it on the card: the data is 8 planes x P x N x 4 B (0.8 MB at
// P=200, N=128) and each pass is O(n_alive^2) gate tests per particle, a
// few MFLOP in all.  Latency bounds it: a few barriers per pass and, inside
// each phase, the dependent instruction chain of the busiest warp.  The
// first port ran one thread per slot, and each thread scanned the slots
// below it one gate at a time for its lowest partner (up to hi dependent
// gate evaluations), then a second time for its lowest safe partner.
//
// Design: one CTA per particle with 16 warps (32 at N > 512), one thread per
// slot for the slot-wise phases (the small form, N <= 1024).  The slot fields
// live in shared memory for the whole fixpoint, the gate fields of a slot as
// one float4 and a float, and the pass loop runs inside the kernel with
// __syncthreads_or as the "any merged" test, so there is no host sync per
// pass.  The pair search is the gate bit mask of merge_bitmask.cuh: a warp
// evaluates the 32 gates of a row word per ballot, two rows at a time, each
// gate once a pass, and a slot finds its absorber in ceil(j / 32) word
// tests.  The mask is N x ceil(N / 32) words (2 KB at N=128, 128 KB at
// N=1024).  A pass has three barriers: after the gate rows, after the claims,
// and the "any merged" test; each absorber reads its partner and writes its
// own fields and its new S^-1 in one phase (absorbers are safe, so unclaimed,
// and absorbed slots absorb nothing).  The i-axis of the pair search is
// bounded per CTA by one past its highest alive slot: slots only die during
// the fixpoint, so the bound holds for every pass, and after compact it
// equals the alive count.  This replaces the TPU's static absorber tiers and
// their host-side choice.  Running each particle to its own fixpoint equals
// the JAX loop over all particles: a pass that merges nothing changes
// nothing.
//
// Large form (N > 1024; merge2d_large): a block has at most 1024 threads
// and shared memory cannot hold the N x ceil(N / 32) mask (8 MiB a particle
// at N=8192).  The mask is not needed: the safe-absorber rule asks of each
// row only whether it has a gated partner below it, and the claims ask
// for the lowest safe gated partner.  The first is a search down from j
// that stops at the first hit (a partner is most often near); the second
// a search up each unsafe row over the words holding a safe slot, testing
// the safe lanes only (merge_bitmask's safe_sweep, safe_words and
// claim_sweep; the same gate arithmetic, so the same claims).  What the
// pass loop touches stays in shared memory: the gate fields (a float4 and
// a float, 20 B a slot), the claims (4 B), the alive bits, the safe bits
// and the list of safe words (199,696 B at N=8192 with the header, ~24.4
// B a slot: up to 9,535 slots).  The covariances, the weights and w_prev
// are touched only by absorbers: they are copied once into the output
// buffer and merged there in place.  Past 9,535 slots the gate fields,
// and past 53,125 the rest too, move to a global workspace (large_tier,
// the wrapper's launch_plan) through the same code.  One CTA a particle.
// The 1024 threads stride over the slots; the rules, the pass loop in the
// kernel and the arithmetic are the small form's statements, so a map
// padded with dead slots merges to the same bits in either form.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_bitmask.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// two-way gate for the pair k < j, both alive (GaussianMixture.hpp:430-441).
// A slot's gate fields are one float4 (x, y, S^-1_00, 2 S^-1_01) and
// S^-1_11: 2 S^-1_01 is exact, and 2 * a01 * dx * dy multiplies left to
// right, so the sums round as the twin's quad_sym.
struct Gate2 {
  const float4* g;
  const float* i11;
  float t2;
  struct Fields {
    float4 g;
    float a11;
  };
  __device__ Fields fields(int s) const { return {g[s], i11[s]}; }
  __device__ bool test(const Fields& k, const Fields& j) const {
    const float dx = j.g.x - k.g.x;
    const float dy = j.g.y - k.g.y;
    const float d2_kj = k.g.z * dx * dx + k.g.w * dx * dy + k.a11 * dy * dy;
    const float d2_jk = j.g.z * dx * dx + j.g.w * dx * dy + j.a11 * dy * dy;
    return d2_kj <= t2 || d2_jk <= t2;
  }
};

// S^-1 of the packed covariance (c00, c01, c11) into the gate fields, as
// the twin's inv_sym rounds it
__device__ __forceinline__ void invert(float c00, float c01, float c11,
                                       float4& g, float& i11) {
  const float det = c00 * c11 - c01 * c01;
  g.z = c11 / det;
  g.w = 2.0f * (-c01 / det);
  i11 = c00 / det;
}

// inputs: mean [2, P, N], cov [3, P, N], w, w_prev [P, N]; out: one float
// buffer of 7 planes [P, N] (mean x/y, cov 00/01/11, w, w_prev).  The
// small form: one thread a slot (blockDim >= N), its shared memory 12 slot
// planes, the gate bit mask [N, W] and the safe-absorber words [W].
__global__ void __launch_bounds__(kMaxThreads) merge2d_kernel(
    float t2, float infl, int max_passes, int N,
    const float* __restrict__ mean, const float* __restrict__ cov,
    const float* __restrict__ w_in, const float* __restrict__ wp_in,
    const bool* __restrict__ alive_in, float* __restrict__ out,
    bool* __restrict__ alive_out) {
  // the layout (the wrapper's launch_plan sizes it the same way)
  const int W = merge_bitmask::words(N);
  extern __shared__ float4 smem[];
  float4* s_g = smem;  // gate fields
  float* s_i11 = reinterpret_cast<float*>(s_g + N);
  float* s_p00 = s_i11 + N;
  float* s_p01 = s_p00 + N;
  float* s_p11 = s_p01 + N;
  float* s_w = s_p11 + N;
  float* s_wp = s_w + N;
  int* s_alive = reinterpret_cast<int*>(s_wp + N);
  int* s_jstar = s_alive + N;
  unsigned* s_gate = reinterpret_cast<unsigned*>(s_jstar + N);  // [N, W]
  unsigned* s_safe = s_gate + static_cast<size_t>(N) * W;       // [W]
  __shared__ int s_hi;

  const size_t PN = static_cast<size_t>(gridDim.x) * N;
  const size_t p0 = static_cast<size_t>(blockIdx.x) * N;
  using merge_bitmask::for_slots;

  if (threadIdx.x == 0) s_hi = 0;
  for_slots(N, [&](int i) {
    const size_t pi = p0 + i;
    s_g[i].x = mean[pi];
    s_g[i].y = mean[PN + pi];
    s_p00[i] = cov[pi];
    s_p01[i] = cov[PN + pi];
    s_p11[i] = cov[2 * PN + pi];
    s_w[i] = w_in[pi];
    s_wp[i] = wp_in[pi];
    s_alive[i] = alive_in[pi] ? 1 : 0;
  });
  __syncthreads();
  for_slots(N, [&](int i) {
    if (s_alive[i]) atomicMax(&s_hi, i + 1);
  });
  __syncthreads();
  const int hi = s_hi;
  const Gate2 gate{s_g, s_i11, t2};

  // S^-1: once here, then again only where a merge changed S
  for_slots(N, [&](int i) {
    invert(s_p00[i], s_p01[i], s_p11[i], s_g[i], s_i11[i]);
    s_jstar[i] = N;
  });
  merge_bitmask::clear_safe(s_safe, W);
  __syncthreads();

  for (int pass = 0; pass < max_passes; ++pass) {
    merge_bitmask::gate_rows(gate, s_alive, hi, W, s_gate, s_safe);
    __syncthreads();
    for_slots(hi, [&](int i) {
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
        const float x1 = s_g[i].x, y1 = s_g[i].y;
        const float x2 = s_g[js].x, y2 = s_g[js].y;
        const float nmx = x1 * w1n + x2 * w2n;
        const float nmy = y1 * w1n + y2 * w2n;
        const float d1x = nmx - x1, d1y = nmy - y1;
        const float d2x = nmx - x2, d2y = nmy - y2;
        const float n00 = w1n * (s_p00[i] + infl * d1x * d1x) +
                          w2n * (s_p00[js] + infl * d2x * d2x);
        const float n01 = w1n * (s_p01[i] + infl * d1x * d1y) +
                          w2n * (s_p01[js] + infl * d2x * d2y);
        const float n11 = w1n * (s_p11[i] + infl * d1y * d1y) +
                          w2n * (s_p11[js] + infl * d2y * d2y);
        if (ok) {
          s_g[i].x = nmx;
          s_g[i].y = nmy;
          s_p00[i] = n00;
          s_p01[i] = n01;
          s_p11[i] = n11;
          s_w[i] = wm;
          s_wp[i] = 0.f;
          s_alive[js] = 0;
          invert(n00, n01, n11, s_g[i], s_i11[i]);
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
    out[pi] = s_g[i].x;
    out[PN + pi] = s_g[i].y;
    out[2 * PN + pi] = s_p00[i];
    out[3 * PN + pi] = s_p01[i];
    out[4 * PN + pi] = s_p11[i];
    out[5 * PN + pi] = s_w[i];
    out[6 * PN + pi] = s_wp[i];
    alive_out[pi] = s_alive[i] != 0;
  });
}

using merge_bitmask::kAllShared;
using merge_bitmask::kFieldsGlobal;
using merge_bitmask::kAllGlobal;
// bytes of a slot's gate fields: a float4 and a float
constexpr size_t kFieldBytes = 20;

// The large form (N > 1024): see the file's head.  Shared memory (or, by
// kTier, this particle's part of ws, stride float4s): hi and the count of
// listed safe words, then the gate fields [N] float4 and [N] float, the
// claims (link) [N], the alive bit words, the safe bit words and the safe
// words' list [W each].  out's cov, w and w_prev planes hold the fields
// that only absorbers touch.
template <int kTier>
__global__ void __launch_bounds__(kMaxThreads) merge2d_large(
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
  float4* g = kTier == kAllShared ? smem + 1 : ws + blockIdx.x * stride;
  float* i11 = reinterpret_cast<float*>(g + N);
  int* link = kTier == kFieldsGlobal ? reinterpret_cast<int*>(smem + 1)
                                     : reinterpret_cast<int*>(i11 + N);
  unsigned* alive = reinterpret_cast<unsigned*>(link + N);
  unsigned* safe = alive + W;
  int* safe_list = reinterpret_cast<int*>(safe + W);

  const size_t PN = static_cast<size_t>(gridDim.x) * N;
  const size_t p0 = static_cast<size_t>(blockIdx.x) * N;
  float* o_p00 = out + 2 * PN + p0;
  float* o_p01 = out + 3 * PN + p0;
  float* o_p11 = out + 4 * PN + p0;
  float* o_w = out + 5 * PN + p0;
  float* o_wp = out + 6 * PN + p0;

  if (threadIdx.x == 0) *s_hi = 0;
  __syncthreads();
  // the covariances and weights into out, the gate fields with S^-1 (once
  // here, then again only where a merge changed S), the alive bits by
  // ballot (a warp's lanes take 32 consecutive slots)
  for (int i = threadIdx.x; i < 32 * W; i += blockDim.x) {
    bool a = false;
    if (i < N) {
      const size_t pi = p0 + i;
      const float c00 = cov[pi], c01 = cov[PN + pi], c11 = cov[2 * PN + pi];
      o_p00[i] = c00;
      o_p01[i] = c01;
      o_p11[i] = c11;
      o_w[i] = w_in[pi];
      o_wp[i] = wp_in[pi];
      float4 gi = {mean[pi], mean[PN + pi], 0.f, 0.f};
      float a11 = 0.f;
      a = alive_in[pi];
      if (a) invert(c00, c01, c11, gi, a11);  // a dead slot's is never read
      g[i] = gi;
      i11[i] = a11;
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
  const Gate2 gate{g, i11, t2};

  const int W_hi = merge_bitmask::words(hi);
  for (int pass = 0; pass < max_passes; ++pass) {
    merge_bitmask::safe_sweep(gate, alive, hi, safe);
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
      const float x1 = g[i].x, y1 = g[i].y;
      const float x2 = g[js].x, y2 = g[js].y;
      const float nmx = x1 * w1n + x2 * w2n;
      const float nmy = y1 * w1n + y2 * w2n;
      const float d1x = nmx - x1, d1y = nmy - y1;
      const float d2x = nmx - x2, d2y = nmy - y2;
      const float n00 = w1n * (o_p00[i] + infl * d1x * d1x) +
                        w2n * (o_p00[js] + infl * d2x * d2x);
      const float n01 = w1n * (o_p01[i] + infl * d1x * d1y) +
                        w2n * (o_p01[js] + infl * d2x * d2y);
      const float n11 = w1n * (o_p11[i] + infl * d1y * d1y) +
                        w2n * (o_p11[js] + infl * d2y * d2y);
      if (ok) {
        float4 gi = {nmx, nmy, 0.f, 0.f};
        invert(n00, n01, n11, gi, i11[i]);
        g[i] = gi;
        o_p00[i] = n00;
        o_p01[i] = n01;
        o_p11[i] = n11;
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
    out[pi] = g[i].x;
    out[PN + pi] = g[i].y;
    alive_out[pi] = bit(alive, i);
  }
}

}  // namespace

// threads (a multiple of 32; at least N in the small form), smem and the
// workspace come from the wrapper's launch_plan.  The form follows from
// N: the small form (N <= 1024) keeps fields and masks in smem bytes of
// shared memory; the large form in smem and, past 9,535 slots, in ws
// (ws_bytes), as merge_bitmask::large_layout checks.
extern "C" int merge2d_launch(int P, int N, int threads, int smem, float t2,
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
          merge2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    merge2d_kernel<<<P, threads, smem, st>>>(t2, infl, max_passes, N, m, c,
                                             wi, wpi, ai, o, ao);
    return static_cast<int>(cudaGetLastError());
  }
  const auto lay =
      merge_bitmask::large_layout(kFieldBytes * N, P, N, smem, ws, ws_bytes);
  if (!lay.ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lay.tier == kAllShared      ? merge2d_large<kAllShared>
                : lay.tier == kFieldsGlobal ? merge2d_large<kFieldsGlobal>
                                            : merge2d_large<kAllGlobal>;
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
