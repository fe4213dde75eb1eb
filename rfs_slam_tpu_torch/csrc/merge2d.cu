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
// runs.  The arithmetic follows the plain twin, ops/gm.py:_merge_pass.
//
// What bounds it on the card: the data is 8 planes x P x N x 4 B (0.8 MB at
// P=200, N=128) and each pass is O(n_alive x N) gate tests per particle, a
// few MFLOP in all.  The kernel is latency-bound: a handful of barriers
// per pass, and the serial scan for each slot's lowest gated partner.
//
// Design: one CTA per particle, one thread per slot.  The slot fields live
// in shared memory (8 planes x N x 4 B = 4 KB at N=128) for the whole
// fixpoint, and the pass loop runs inside the kernel with
// __syncthreads_or as the "any merged" test, so there is no host sync per
// pass.  A slot's partner is gathered by an indexed shared-memory load (the
// TPU kernel used a selection-matrix matmul).  The i-axis of the pair
// search is bounded per CTA by one past its highest alive slot: slots only
// die during the fixpoint, so every alive slot stays below that bound for
// every pass, and the bound is exact (after compact it equals the alive
// count).  This replaces the TPU's static absorber tiers and their
// host-side choice.  Running each particle to its own fixpoint equals the
// JAX loop over all particles: a pass that merges nothing changes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void merge2d_kernel(
    float t2, float infl, int max_passes, int N,
    const float* __restrict__ mx_in, const float* __restrict__ my_in,
    const float* __restrict__ p00_in, const float* __restrict__ p01_in,
    const float* __restrict__ p11_in, const float* __restrict__ w_in,
    const float* __restrict__ wp_in, const bool* __restrict__ alive_in,
    float* __restrict__ mx_out, float* __restrict__ my_out,
    float* __restrict__ p00_out, float* __restrict__ p01_out,
    float* __restrict__ p11_out, float* __restrict__ w_out,
    float* __restrict__ wp_out, bool* __restrict__ alive_out) {
  extern __shared__ float smem[];
  float* s_mx = smem;
  float* s_my = s_mx + N;
  float* s_p00 = s_my + N;
  float* s_p01 = s_p00 + N;
  float* s_p11 = s_p01 + N;
  float* s_w = s_p11 + N;
  float* s_wp = s_w + N;
  float* s_i00 = s_wp + N;
  float* s_i01 = s_i00 + N;
  float* s_i11 = s_i01 + N;
  int* s_alive = reinterpret_cast<int*>(s_i11 + N);
  int* s_first_any = s_alive + N;
  int* s_jstar = s_first_any + N;
  __shared__ int s_hi;

  const int i = threadIdx.x;
  const bool act = i < N;
  const size_t base = static_cast<size_t>(blockIdx.x) * N;

  if (i == 0) s_hi = 0;
  if (act) {
    s_mx[i] = mx_in[base + i];
    s_my[i] = my_in[base + i];
    s_p00[i] = p00_in[base + i];
    s_p01[i] = p01_in[base + i];
    s_p11[i] = p11_in[base + i];
    s_w[i] = w_in[base + i];
    s_wp[i] = wp_in[base + i];
    s_alive[i] = alive_in[base + i] ? 1 : 0;
  }
  __syncthreads();
  if (act && s_alive[i]) atomicMax(&s_hi, i + 1);
  __syncthreads();
  const int hi = s_hi;

  // two-way gate for the pair k < j, both alive (GaussianMixture.hpp:430-441)
  auto gate = [&](int k, int j) {
    if (!s_alive[k]) return false;
    const float dx = s_mx[j] - s_mx[k];
    const float dy = s_my[j] - s_my[k];
    const float d2_kj = s_i00[k] * dx * dx + 2.0f * s_i01[k] * dx * dy +
                        s_i11[k] * dy * dy;
    const float d2_jk = s_i00[j] * dx * dx + 2.0f * s_i01[j] * dx * dy +
                        s_i11[j] * dy * dy;
    return d2_kj <= t2 || d2_jk <= t2;
  };

  for (int pass = 0; pass < max_passes; ++pass) {
    if (act) {
      const float det = s_p00[i] * s_p11[i] - s_p01[i] * s_p01[i];
      s_i00[i] = s_p11[i] / det;
      s_i01[i] = -s_p01[i] / det;
      s_i11[i] = s_p00[i] / det;
      s_jstar[i] = N;
    }
    __syncthreads();

    // lowest gated partner below this slot: a slot that has one cannot
    // absorb this pass (safe-absorber rule)
    const bool alive_i = act && s_alive[i];
    const int k_end = min(i, hi);
    int first_any = N;
    if (alive_i) {
      for (int k = 0; k < k_end; ++k) {
        if (gate(k, i)) { first_any = k; break; }
      }
    }
    if (act) s_first_any[i] = first_any;
    __syncthreads();

    // the lowest safe absorber claims this slot; each absorber keeps its
    // lowest claimed slot
    if (first_any < N) {
      for (int k = first_any; k < k_end; ++k) {
        if (s_first_any[k] == N && gate(k, i)) {
          atomicMin(&s_jstar[k], i);
          break;
        }
      }
    }
    __syncthreads();

    const int js = act ? s_jstar[i] : N;
    bool ok = false;
    float nmx = 0.f, nmy = 0.f, n00 = 0.f, n01 = 0.f, n11 = 0.f, nw = 0.f;
    if (js < N) {
      const float w1 = s_w[i], w2 = s_w[js];
      const float wm = w1 + w2;
      ok = wm != 0.f;
      const float w1n = w1 / wm, w2n = w2 / wm;
      const float x1 = s_mx[i], y1 = s_my[i];
      const float x2 = s_mx[js], y2 = s_my[js];
      nmx = x1 * w1n + x2 * w2n;
      nmy = y1 * w1n + y2 * w2n;
      const float d1x = nmx - x1, d1y = nmy - y1;
      const float d2x = nmx - x2, d2y = nmy - y2;
      n00 = w1n * (s_p00[i] + infl * d1x * d1x) +
            w2n * (s_p00[js] + infl * d2x * d2x);
      n01 = w1n * (s_p01[i] + infl * d1x * d1y) +
            w2n * (s_p01[js] + infl * d2x * d2y);
      n11 = w1n * (s_p11[i] + infl * d1y * d1y) +
            w2n * (s_p11[js] + infl * d2y * d2y);
      nw = wm;
    }
    __syncthreads();  // every partner read is done before any write
    if (ok) {
      s_mx[i] = nmx;
      s_my[i] = nmy;
      s_p00[i] = n00;
      s_p01[i] = n01;
      s_p11[i] = n11;
      s_w[i] = nw;
      s_wp[i] = 0.f;
      s_alive[js] = 0;
    }
    if (!__syncthreads_or(ok)) break;
  }

  if (act) {
    mx_out[base + i] = s_mx[i];
    my_out[base + i] = s_my[i];
    p00_out[base + i] = s_p00[i];
    p01_out[base + i] = s_p01[i];
    p11_out[base + i] = s_p11[i];
    w_out[base + i] = s_w[i];
    wp_out[base + i] = s_wp[i];
    alive_out[base + i] = s_alive[i] != 0;
  }
}

}  // namespace

extern "C" int merge2d_launch(int P, int N, float t2, float infl,
                              int max_passes, const void* mx, const void* my,
                              const void* p00, const void* p01,
                              const void* p11, const void* w, const void* wp,
                              const void* alive, void* mx_out, void* my_out,
                              void* p00_out, void* p01_out, void* p11_out,
                              void* w_out, void* wp_out, void* alive_out,
                              void* stream) {
  const int threads = (N + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(N) * (10 * sizeof(float) +
                                                3 * sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        merge2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  merge2d_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      t2, infl, max_passes, N, static_cast<const float*>(mx),
      static_cast<const float*>(my), static_cast<const float*>(p00),
      static_cast<const float*>(p01), static_cast<const float*>(p11),
      static_cast<const float*>(w), static_cast<const float*>(wp),
      static_cast<const bool*>(alive), static_cast<float*>(mx_out),
      static_cast<float*>(my_out), static_cast<float*>(p00_out),
      static_cast<float*>(p01_out), static_cast<float*>(p11_out),
      static_cast<float*>(w_out), static_cast<float*>(wp_out),
      static_cast<bool*>(alive_out));
  return static_cast<int>(cudaGetLastError());
}
