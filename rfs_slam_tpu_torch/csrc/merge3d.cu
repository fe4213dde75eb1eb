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
// tests of ~45 FLOP per particle.  Both are far below the card's rates: the
// kernel is latency-bound, by a handful of barriers per pass and the serial
// scan for each slot's lowest gated partner.
//
// Design: one CTA per particle, one thread per slot (100 CTAs on 132 SMs at
// Victoria Park's P=100: under one wave).  The 11 slot planes, the 6
// inverse planes, alive, first_any and j_star live in shared memory for the
// whole fixpoint (20 x N x 4 B = 40 KB at N=512; above 48 KB the launch
// raises the dynamic shared-memory limit).  The pass loop runs in the
// kernel with __syncthreads_or as the "any merged" test.  Partners are
// gathered by an indexed shared-memory load (the TPU kernel used a
// selection-matrix matmul).  The pair search's i-axis is bounded per CTA by
// one past its highest alive slot (exact: slots only die during the
// fixpoint), which replaces the TPU's static absorber tiers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 11;  // mx my md | c00 c01 c02 c11 c12 c22 | w wp

// plane pointers, passed by value in the kernel's parameters
struct Planes {
  float* p[kPlanes];
};

__global__ void merge3d_kernel(float t2, float infl, int max_passes, int N,
                               const Planes in,
                               const bool* __restrict__ alive_in,
                               const Planes out,
                               bool* __restrict__ alive_out) {
  extern __shared__ float smem[];
  float* s[kPlanes];
  #pragma unroll
  for (int k = 0; k < kPlanes; ++k) s[k] = smem + k * N;
  float* s_inv = smem + kPlanes * N;  // 6 planes
  int* s_alive = reinterpret_cast<int*>(s_inv + 6 * N);
  int* s_first_any = s_alive + N;
  int* s_jstar = s_first_any + N;
  __shared__ int s_hi;

  float* const mx = s[0];
  float* const my = s[1];
  float* const md = s[2];
  float* const c00 = s[3];
  float* const c01 = s[4];
  float* const c02 = s[5];
  float* const c11 = s[6];
  float* const c12 = s[7];
  float* const c22 = s[8];
  float* const w = s[9];
  float* const wp = s[10];
  float* const i00 = s_inv;
  float* const i01 = s_inv + N;
  float* const i02 = s_inv + 2 * N;
  float* const i11 = s_inv + 3 * N;
  float* const i12 = s_inv + 4 * N;
  float* const i22 = s_inv + 5 * N;

  const int i = threadIdx.x;
  const bool act = i < N;
  const size_t base = static_cast<size_t>(blockIdx.x) * N;

  if (i == 0) s_hi = 0;
  if (act) {
    #pragma unroll
    for (int k = 0; k < kPlanes; ++k) s[k][i] = in.p[k][base + i];
    s_alive[i] = alive_in[base + i] ? 1 : 0;
  }
  __syncthreads();
  if (act && s_alive[i]) atomicMax(&s_hi, i + 1);
  __syncthreads();
  const int hi = s_hi;

  // v^T S^-1 v in planar.quad_sym's order: diagonal term of row 0, then
  // 2 m01 v0 v1, 2 m02 v0 v2, m11 v1 v1, 2 m12 v1 v2, m22 v2 v2
  auto quad = [&](int k, float v0, float v1, float v2) {
    float q = i00[k] * v0 * v0;
    q = q + 2.0f * i01[k] * v0 * v1;
    q = q + 2.0f * i02[k] * v0 * v2;
    q = q + i11[k] * v1 * v1;
    q = q + 2.0f * i12[k] * v1 * v2;
    q = q + i22[k] * v2 * v2;
    return q;
  };
  // two-way gate for the pair k < j, both alive (GaussianMixture.hpp:430-441)
  auto gate = [&](int k, int j) {
    if (!s_alive[k]) return false;
    const float v0 = mx[j] - mx[k];
    const float v1 = my[j] - my[k];
    const float v2 = md[j] - md[k];
    return quad(k, v0, v1, v2) <= t2 || quad(j, v0, v1, v2) <= t2;
  };

  for (int pass = 0; pass < max_passes; ++pass) {
    if (act) {
      // inverse by the adjugate, planar.det_sym / inv_sym for D=3
      const float a = c00[i], b = c01[i], c = c02[i];
      const float d = c11[i], e = c12[i], f = c22[i];
      const float det = a * (d * f - e * e) - b * (b * f - e * c) +
                        c * (b * e - d * c);
      i00[i] = (d * f - e * e) / det;
      i01[i] = (c * e - b * f) / det;
      i02[i] = (b * e - c * d) / det;
      i11[i] = (a * f - c * c) / det;
      i12[i] = (c * b - a * e) / det;
      i22[i] = (a * d - b * b) / det;
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
    float nm[3] = {0.f, 0.f, 0.f};
    float nc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float nw = 0.f;
    if (js < N) {
      const float w1 = w[i], w2 = w[js];
      const float wm = w1 + w2;
      ok = wm != 0.f;
      const float w1n = w1 / wm, w2n = w2 / wm;
      const float x1[3] = {mx[i], my[i], md[i]};
      const float x2[3] = {mx[js], my[js], md[js]};
      float d1[3], d2[3];
      #pragma unroll
      for (int t = 0; t < 3; ++t) {
        nm[t] = x1[t] * w1n + x2[t] * w2n;
        d1[t] = nm[t] - x1[t];
        d2[t] = nm[t] - x2[t];
      }
      // packed (r, c) pairs in tri_index order
      const int pr[6] = {0, 0, 0, 1, 1, 2};
      const int pc[6] = {0, 1, 2, 1, 2, 2};
      #pragma unroll
      for (int t = 0; t < 6; ++t) {
        const float* cp = s[3 + t];
        nc[t] = w1n * (cp[i] + infl * d1[pr[t]] * d1[pc[t]]) +
                w2n * (cp[js] + infl * d2[pr[t]] * d2[pc[t]]);
      }
      nw = wm;
    }
    __syncthreads();  // every partner read is done before any write
    if (ok) {
      mx[i] = nm[0];
      my[i] = nm[1];
      md[i] = nm[2];
      #pragma unroll
      for (int t = 0; t < 6; ++t) s[3 + t][i] = nc[t];
      w[i] = nw;
      wp[i] = 0.f;
      s_alive[js] = 0;
    }
    if (!__syncthreads_or(ok)) break;
  }

  if (act) {
    #pragma unroll
    for (int k = 0; k < kPlanes; ++k) out.p[k][base + i] = s[k][i];
    alive_out[base + i] = s_alive[i] != 0;
  }
}

}  // namespace

// planes_in / planes_out: host arrays of the 11 device plane pointers
// (mean x, y, d; cov 00 01 02 11 12 22; w; w_prev), each [P, N] f32.
extern "C" int merge3d_launch(int P, int N, float t2, float infl,
                              int max_passes, void* const* planes_in,
                              const void* alive, void* const* planes_out,
                              void* alive_out, void* stream) {
  Planes in, out;
  for (int k = 0; k < kPlanes; ++k) {
    in.p[k] = static_cast<float*>(planes_in[k]);
    out.p[k] = static_cast<float*>(planes_out[k]);
  }
  const int threads = (N + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(N) * ((kPlanes + 6) * sizeof(float) +
                                                3 * sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        merge3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  merge3d_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      t2, infl, max_passes, N, in, static_cast<const bool*>(alive), out,
      static_cast<bool*>(alive_out));
  return static_cast<int>(cudaGetLastError());
}
