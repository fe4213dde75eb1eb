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
// the inputs and outputs are ~1.6 MB, under a microsecond of HBM time; the
// work is ~1M table cells of expf + division, also tiny.  The kernel is
// bound by latency: launch, the block-wide barriers between phases, and the
// serial iterated argmax (T rounds of a warp reduction per column).
//
// Design: one CTA per particle and one thread per landmark slot, so the
// per-slot EKF algebra stays in registers.  The [Zc, M] table (20 KB at
// bench shape) lives in shared memory and never reaches HBM, as the TPU
// kernel kept it in VMEM.  Column sums and the per-column argmax run one
// warp per measurement column with shuffles; row sums are a per-thread loop
// over Zc.  atan2f replaces the TPU kernel's polynomial atan2 (Mosaic has
// none), and wrap_angle rounds half to even (rintf) as jnp.round does.

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

__device__ __forceinline__ float wrap_angle(float a) {
  return a - kTwoPi * rintf(a / kTwoPi);
}

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.0f;
}

__global__ void map_update2d_kernel(
    Params prm, int M, int Zc, int T, const float* __restrict__ pose,
    const float* __restrict__ mx, const float* __restrict__ my,
    const float* __restrict__ c00, const float* __restrict__ c01,
    const float* __restrict__ c11, const float* __restrict__ w,
    const float* __restrict__ w_prev, const bool* __restrict__ alive,
    const float* __restrict__ z, const bool* __restrict__ zmask,
    float* __restrict__ w_out, float* __restrict__ wp_out,
    float* __restrict__ pd_out, float* __restrict__ colsum_out,
    bool* __restrict__ unused_out, float* __restrict__ cand_w,
    int64_t* __restrict__ cand_m, float* __restrict__ k00_out,
    float* __restrict__ k01_out, float* __restrict__ k10_out,
    float* __restrict__ k11_out, float* __restrict__ cu00_out,
    float* __restrict__ cu01_out, float* __restrict__ cu11_out,
    float* __restrict__ zer_out, float* __restrict__ zeb_out) {
  extern __shared__ float smem[];
  float* tab = smem;           // [Zc, M] weight table
  float* col = tab + Zc * M;   // [Zc] clutter + column sums

  const int p = blockIdx.x;
  const int m = threadIdx.x;
  const int lane = m & 31;
  const int warp = m >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool act = m < M;
  const size_t pm = static_cast<size_t>(p) * M + m;

  const float px = pose[3 * p], py = pose[3 * p + 1], pth = pose[3 * p + 2];

  float r = 0.f, b = 0.f, i00 = 0.f, i01 = 0.f, i11 = 0.f, norm = 1.f;
  float pd = 0.f, wv = 0.f;
  bool alv = false, mvalid = false, close = false;
  if (act) {
    const float vx = mx[pm], vy = my[pm];
    const float s00c = c00[pm], s01c = c01[pm], s11c = c11[pm];
    wv = w[pm];
    alv = alive[pm];

    // expected measurement + Jacobian (RangeBearing.measure_p)
    const float dx = vx - px, dy = vy - py;
    const float r2 = dx * dx + dy * dy;
    r = sqrtf(r2);
    b = wrap_angle(atan2f(dy, dx) - pth);
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
    i00 = s11 / det;
    i01 = -s01 / det;
    i11 = s00 / det;
    norm = sqrtf(kTwoPiSq * det);

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
    mvalid = (r <= prm.r_max) && (r >= prm.r_min);
    const bool near_inner =
        mvalid && ((r >= prm.r_max - prm.r_buf) || (r <= prm.r_min + prm.r_buf));
    const bool near_outer =
        !mvalid && (r <= prm.r_max + prm.r_buf) && (r >= prm.r_min - prm.r_buf);
    close = (near_inner || near_outer) && alv;
    pd = close ? 1.0f : ((mvalid && alv) ? prm.pd_const : 0.0f);

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

    // gated weight table, one row per measurement (RBPHDFilter.hpp:620-659)
    for (int k = 0; k < Zc; ++k) {
      const float ir = z[2 * k] - r;
      const float ib = wrap_angle(z[2 * k + 1] - b);
      const bool gate_ok = (prm.t_r <= 0.f || fabsf(ir) <= prm.t_r) &&
                           (prm.t_b <= 0.f || fabsf(ib) <= prm.t_b);
      const float md2 = i00 * ir * ir + 2.0f * i01 * ir * ib + i11 * ib * ib;
      float lik = finite_or_zero(expf(-0.5f * md2) / norm);
      if (!(gate_ok && mvalid)) lik = 0.f;
      const bool cell = alv && pd > 0.f && zmask[k] && md2 <= prm.md_t2 &&
                        lik > 0.f;
      tab[k * M + m] = cell ? pd * wv * lik : 0.f;
    }
  }
  __syncthreads();

  // column sums: one warp per measurement column
  for (int k = warp; k < Zc; k += n_warps) {
    float s = 0.f;
    for (int j = lane; j < M; j += 32) s += tab[k * M + j];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) col[k] = prm.clutter + s;
  }
  __syncthreads();

  // column normalization, row sums, missed-detection weights (hpp:686-706)
  if (act) {
    float row = 0.f;
    for (int k = 0; k < Zc; ++k) {
      const float v = zmask[k] ? tab[k * M + m] / col[k] : 0.f;
      tab[k * M + m] = v;
      row += v;
    }
    float w_miss = (1.0f - pd) * wv;
    const float delta = pd * wv - row;
    if (close && wv > prm.birth_w && delta > 0.f)
      w_miss = fminf(w_miss + delta, 1.0f);
    w_out[pm] = alv ? w_miss : wv;
    wp_out[pm] = alv ? wv : w_prev[pm];
  }
  __syncthreads();

  // per column: used flag, then T rounds of first-argmax (lowest index on
  // ties), zeroing each pick (hpp:709-720 and the hierarchical selection)
  for (int k = warp; k < Zc; k += n_warps) {
    float* cp = tab + k * M;
    bool any = false;
    for (int j = lane; j < M; j += 32) any |= cp[j] > 0.f;
    any = __any_sync(kFull, any);
    if (lane == 0) {
      const size_t pk = static_cast<size_t>(p) * Zc + k;
      unused_out[pk] = zmask[k] && !any;
      colsum_out[pk] = col[k];
    }
    for (int t = 0; t < T; ++t) {
      float bv = -INFINITY;
      int bi = M;
      for (int j = lane; j < M; j += 32) {
        const float v = cp[j];
        if (v > bv) { bv = v; bi = j; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      bi = min(bi, M - 1);
      if (lane == 0) {
        const size_t o = static_cast<size_t>(p) * T * Zc + t * Zc + k;
        cand_w[o] = bv;
        cand_m[o] = bi;
      }
      if (lane == (bi & 31)) cp[bi] = 0.f;
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int map_update2d_launch(
    int P, int M, int Zc, int T, const float* params, const void* pose,
    const void* mx, const void* my, const void* c00, const void* c01,
    const void* c11, const void* w, const void* w_prev, const void* alive,
    const void* z, const void* zmask, void* w_out, void* wp_out,
    void* pd_out, void* colsum_out, void* unused_out, void* cand_w,
    void* cand_m, void* k00, void* k01, void* k10, void* k11, void* cu00,
    void* cu01, void* cu11, void* zer, void* zeb, void* stream) {
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
  const int threads = (M + 31) / 32 * 32;
  const size_t smem = (static_cast<size_t>(Zc) * M + Zc) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        map_update2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  map_update2d_kernel<<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      prm, M, Zc, T, static_cast<const float*>(pose),
      static_cast<const float*>(mx), static_cast<const float*>(my),
      static_cast<const float*>(c00), static_cast<const float*>(c01),
      static_cast<const float*>(c11), static_cast<const float*>(w),
      static_cast<const float*>(w_prev), static_cast<const bool*>(alive),
      static_cast<const float*>(z), static_cast<const bool*>(zmask),
      static_cast<float*>(w_out), static_cast<float*>(wp_out),
      static_cast<float*>(pd_out), static_cast<float*>(colsum_out),
      static_cast<bool*>(unused_out), static_cast<float*>(cand_w),
      static_cast<int64_t*>(cand_m), static_cast<float*>(k00),
      static_cast<float*>(k01), static_cast<float*>(k10),
      static_cast<float*>(k11), static_cast<float*>(cu00),
      static_cast<float*>(cu01), static_cast<float*>(cu11),
      static_cast<float*>(zer), static_cast<float*>(zeb));
  return static_cast<int>(cudaGetLastError());
}
