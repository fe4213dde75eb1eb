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
// Large form (N > 1024): shared memory cannot hold the mask (622,848 B of
// fields and mask at N=2048 against the 232,448 an SM gives a block), and
// a block has at most 1024 threads.  The same kernel (kLarge) keeps the
// fields, the claims and the mask in the particle's part of a global
// workspace, laid out as the small form's shared memory (8 MiB a particle
// at N=8192, nearly all mask), and its 1024 threads stride over the slots
// in every slot-wise phase.  The rules, the pass loop in the kernel and
// the arithmetic are the small form's statements, so a map padded with
// dead slots merges to the same bits in either form.

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

// The words of one particle's fields, claims and masks: 12 slot planes,
// the gate bit mask [N, W] and the safe-absorber words [W].  The small
// form's shared memory; the large form's workspace stride, rounded up to
// whole float4s so that every particle's float4 plane is aligned.
__host__ __device__ constexpr size_t particle_words(int N, int W) {
  return 12 * static_cast<size_t>(N) + static_cast<size_t>(N) * W + W;
}

// inputs: mean [2, P, N], cov [3, P, N], w, w_prev [P, N]; out: one float
// buffer of 7 planes [P, N] (mean x/y, cov 00/01/11, w, w_prev).
// kLarge: the fields and masks live in this particle's part of the global
// workspace ws (stride float4s a particle) instead of shared memory, and
// the slot-wise phases stride over the slots (for_slots); the small form
// takes one slot a thread.
template <bool kLarge>
__global__ void __launch_bounds__(kMaxThreads) merge2d_kernel(
    float t2, float infl, int max_passes, int N,
    const float* __restrict__ mean, const float* __restrict__ cov,
    const float* __restrict__ w_in, const float* __restrict__ wp_in,
    const bool* __restrict__ alive_in, float* __restrict__ out,
    bool* __restrict__ alive_out, float4* __restrict__ ws, size_t stride) {
  // the layout (the wrapper's launch_plan sizes it the same way)
  const int W = merge_bitmask::words(N);
  extern __shared__ float4 smem[];
  float4* s_g = kLarge ? ws + blockIdx.x * stride : smem;  // gate fields
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
  for_slots<kLarge>(N, [&](int i) {
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
  for_slots<kLarge>(N, [&](int i) {
    if (s_alive[i]) atomicMax(&s_hi, i + 1);
  });
  __syncthreads();
  const int hi = s_hi;
  const Gate2 gate{s_g, s_i11, t2};

  // S^-1: once here, then again only where a merge changed S
  for_slots<kLarge>(N, [&](int i) {
    invert(s_p00[i], s_p01[i], s_p11[i], s_g[i], s_i11[i]);
    s_jstar[i] = N;
  });
  merge_bitmask::clear_safe(s_safe, W);
  __syncthreads();

  for (int pass = 0; pass < max_passes; ++pass) {
    merge_bitmask::gate_rows(gate, s_alive, hi, W, s_gate, s_safe);
    __syncthreads();
    for_slots<kLarge>(hi, [&](int i) {
      merge_bitmask::claim(i, s_alive, hi, W, s_gate, s_safe, s_jstar);
    });
    __syncthreads();

    // An absorber is safe, so no slot claims it, and an absorbed slot
    // absorbs nothing: each absorber alone reads its fields and its
    // partner's, and writes its own, so reads and writes need no barrier.
    bool any = false;
    for_slots<kLarge>(N, [&](int i) {
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

  for_slots<kLarge>(N, [&](int i) {
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

}  // namespace

// threads (a multiple of 32; at least N in the small form), smem and the
// workspace come from the wrapper's launch_plan.  The form follows from N:
// the small form (N <= 1024) keeps fields and masks in smem bytes of shared
// memory, the large form in ws (ws_bytes, at least
// P * 16 * ceil(particle_words / 4)).
extern "C" int merge2d_launch(int P, int N, int threads, int smem, float t2,
                              float infl, int max_passes, const void* mean,
                              const void* cov, const void* w, const void* wp,
                              const void* alive, void* out, void* alive_out,
                              void* ws, size_t ws_bytes, void* stream) {
  const int W = merge_bitmask::words(N);
  const size_t stride = (particle_words(N, W) + 3) / 4;  // float4s
  const bool large = N > kMaxThreads;
  if (threads > kMaxThreads || threads % 32 != 0 || threads < 32 || N < 1 ||
      (large ? (ws == nullptr || ws_bytes < P * stride * sizeof(float4) ||
                static_cast<size_t>(N) * W >= (1u << 31))
             : threads < N))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = large ? merge2d_kernel<true> : merge2d_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      t2, infl, max_passes, N, static_cast<const float*>(mean),
      static_cast<const float*>(cov), static_cast<const float*>(w),
      static_cast<const float*>(wp), static_cast<const bool*>(alive),
      static_cast<float*>(out), static_cast<bool*>(alive_out),
      static_cast<float4*>(ws), stride);
  return static_cast<int>(cudaGetLastError());
}
