// Batched Hungarian (shortest augmenting path with dual potentials) for
// Hopper (sm_90a): one max-sum assignment problem per CTA of one warp.
//
// The JAX package has no Pallas kernel here: its _hungarian_uv
// (ops/assignment.py) is a fori_loop over the rows, each a while_loop search
// whose trip count differs per lane, under vmap.  This kernel is the port's
// counterpart of that function; its plain twin is
// ops/assignment.py:hungarian_uv_plain.
//
// Algorithm, in the twin's (and JAX's) arithmetic order: minimize a = -cost
// with 1-indexed potentials u (rows), v (columns) and the virtual column 0.
// For each row i, p[0] = i + 1 and, from j0 = 0, the search repeats while
// p[j0] != 0 and at most n + 2 times:
//   used[j0] = 1; i0 = p[j0];
//   for every column j: cur = (a[i0-1][j-1] - u[i0]) - v[j] (INF at j = 0);
//     an unused column with cur < minv[j] takes minv[j] = cur, way[j] = j0;
//   (delta, j1) = the minimum of minv over the unused columns, INF over the
//     used ones, the LOWER index on ties (jnp.argmin);
//   u[r] += delta * (number of used columns j with p[j] = r), every r;
//   v[j] -= delta on used columns, minv[j] -= delta on the others;
//   j0 = j1.
// Then the augmenting chain is walked, p[j0] = p[way[j0]], while j0 != 0 and
// at most n + 2 steps: the caps are the twin's exits, so a chain that f32
// drift breaks degrades the row instead of hanging the warp.  The row ->
// column map is the max over columns c with p[c+1] = r + 1 (0 where none),
// and total sums cost[r][row_to_col[r]] row by row from 0.  INF is
// FLT_MAX / 8, exact.  Built with -fmad=false (ops/kernels/build.py): no
// product may fuse into a sum the twin rounds twice.
//
// What bounds it: not bytes (the matrix is read once) but the latency of
// one search trip, since every trip depends on the one before and the
// floor-padded DA tables tie about 13 trips a row (491 in the slowest
// matrix of a FastSLAM step).  The design shortens the trip:
//
// * The cost matrix is copied into shared memory once (cp.async), so a
//   trip reads its row there, lane l on columns l + 32k: conflict-free.
//   The load's address is one multiply-add of i0 with a per-lane base
//   kept in registers.  Where n * n floats do not fit a block's shared
//   memory (n > 240), the same kernel reads the row from global memory
//   (the SMEM = false instantiations): a rule of shape, not a fallback.
// * The column state is in registers: lane l owns columns 1 + l + 32k and
//   rows 1 + l + 32k for k < K = ceil(n / 32) (a template parameter), with
//   minv, v, way, p, u and the row counts as K-register arrays and used as
//   a bit mask.  The virtual column 0 is uniform across the warp: every
//   lane carries v[0], u[0] and p[0] (i + 1 during row i's search), and
//   column 0 is used from the first trip on.
// * The row counts need no atomics.  During one row's search p does not
//   change, and a used column j was marked in exactly one trip, the one
//   with j0 = j and i0 = p[j].  So the twin's count for row r (the used
//   columns with p[j] = r) is the number of trips so far whose i0 was r,
//   counting only trips that marked a new column.  A trip marks no new
//   column only when j0 = 0 after the first trip: j1 is a used column only
//   when every unused minv is >= INF, and then column 0 (INF, the lowest
//   index) wins the tie.  The owner of row i0 adds one to its count; every
//   lane then adds delta * (float)count to its u registers, the twin's
//   product and sum, so the bits are the twin's even when a chain broken
//   by f32 drift repeats a row (count 2).
// * The argmin is a warp reduction.  Each lane takes the minimum of its
//   unused columns over k ascending (the first wins under <; NaN where it
//   has none), maps it to an order-preserving 32-bit key with -0.0 folded
//   onto +0.0 by adding +0.0 (so floats equal under < tie; NaN's key is the
//   largest), and __reduce_min_sync finds the least key.  Ties go to the
//   lowest column: the lowest k among the lanes at the minimum (a second
//   reduction, K > 1 only), then the lowest lane (one more reduction, which
//   measured faster than a ballot and __ffs).  delta is the winner's own
//   value, shuffled with its p, so no arithmetic touches it.  A least key
//   >= INF's means column 0 wins: delta = INF, j1 = 0, as the twin's
//   argmin gives; every lane then offers INF and p[0] to the shuffles.
// * Broadcasts are shuffles (u[i0] from the owner of row i0, the winner's
//   value and p), so a trip has no __syncwarp, and its body has no branch
//   (selects only).  The augment walk shuffles through the way and p
//   registers, capped at n + 2.
// * The epilogue (row_to_col by shared-memory atomicMax, total by
//   shuffles, u and v) runs once a matrix.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// register k of a K-register array, k warp-uniform (selects, no local
// memory); an out-of-range k gives a[0]
template <int K, typename T>
__device__ __forceinline__ T pick(const T (&a)[K], int k) {
  T x = a[0];
#pragma unroll
  for (int q = 1; q < K; ++q)
    if (q == k) x = a[q];
  return x;
}

// the order-preserving key of f, with -0.0 folded onto +0.0 (-0 + +0 = +0)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f + 0.0f);
  const unsigned sign = static_cast<unsigned>(static_cast<int>(b) >> 31);
  return b ^ (sign | 0x80000000u);
}

template <int K, bool SMEM>
__global__ void __launch_bounds__(32)
    hungarian_kernel(int n, const float* __restrict__ cost,
                     int* __restrict__ row_to_col, float* __restrict__ total,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);
  int* r2c = reinterpret_cast<int*>(smem + (SMEM ? 4 * n * n : 0));

  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* A = cost + b * n * n;
  const float INF = FLT_MAX / 8.0f;

  if (SMEM) {  // the matrix into shared memory, 16 B a copy where aligned
    const unsigned base =
        static_cast<unsigned>(__cvta_generic_to_shared(sA));
    const int nn = n * n;
    if ((nn & 3) == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0) {
      for (int e = 4 * lane; e < nn; e += 128)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         base + 4 * e),
                     "l"(A + e));
    } else {
      for (int e = lane; e < nn; e += 32)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         base + 4 * e),
                     "l"(A + e));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  float u[K], v[K], minv[K];
  int way[K], p[K], cnt[K];
  unsigned valid = 0;  // bit k: column (and row) 1 + lane + 32k exists
#pragma unroll
  for (int k = 0; k < K; ++k) {
    u[k] = 0.f;
    v[k] = 0.f;
    p[k] = 0;
    if (1 + lane + 32 * k <= n) valid |= 1u << k;
  }
  float u0 = 0.f, v0 = 0.f;
  const unsigned inf_key = order_key(INF);

  if (SMEM) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
  }
  const float* M = SMEM ? sA : A;
  // the shared address of a lane's column k in row i0 is i0 * 4n + s_col[k]
  // (columns past n clamped into the matrix; they are never open)
  unsigned s_col[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    s_col[k] = static_cast<unsigned>(__cvta_generic_to_shared(sA)) +
               4u * min(lane + 32 * k, n - 1) - 4u * n;

  for (int i = 0; i < n; ++i) {
    unsigned used = 0;  // bit k: column 1 + lane + 32k used in this search
#pragma unroll
    for (int k = 0; k < K; ++k) {
      minv[k] = INF;
      way[k] = 0;
      cnt[k] = 0;
    }
    const int p0 = i + 1;  // p[0] during this row's search
    int j0 = 0, i0 = p0;
    for (int it = 0; i0 != 0 && it <= n + 1; ++it) {
      const int jc = j0 - 1, ic = i0 - 1;
      const bool fresh = it == 0 || j0 != 0;
      used |= (j0 != 0 && lane == (jc & 31)) ? (1u << (jc >> 5)) : 0u;
#pragma unroll
      for (int k = 0; k < K; ++k)
        cnt[k] += (fresh && lane == (ic & 31) && k == (ic >> 5)) ? 1 : 0;
      const float ui0 = __shfl_sync(kFull, pick(u, ic >> 5), ic & 31);
      const unsigned open = valid & ~used;
      float best = __int_as_float(0x7fffffff);  // NaN: no open column
      int bk = K;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool o = (open >> k) & 1u;
        float x;
        if (SMEM) {
          const unsigned a = static_cast<unsigned>(i0) * (4u * n) + s_col[k];
          asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(a));
        } else {
          x = M[static_cast<size_t>(ic) * n + min(lane + 32 * k, n - 1)];
        }
        const float cur = ((-x) - ui0) - v[k];
        const bool better = o && cur < minv[k];
        minv[k] = better ? cur : minv[k];
        way[k] = better ? j0 : way[k];
        const bool take = o && (bk == K || minv[k] < best);
        best = take ? minv[k] : best;
        bk = take ? k : bk;
      }
      const unsigned key = order_key(best);  // NaN's key: 0xffffffff
      const unsigned kmin = __reduce_min_sync(kFull, key);
      const int wk = K == 1 ? 0
                            : static_cast<int>(__reduce_min_sync(
                                  kFull, key == kmin ? unsigned(bk) : 255u));
      const bool col0 = kmin >= inf_key;  // column 0 (INF) is the least
      const float s_best = col0 ? INF : best;
      const int s_p = col0 ? p0 : pick(p, bk);
      const int wl = static_cast<int>(__reduce_min_sync(
          kFull, key == kmin && bk == wk ? unsigned(lane) : 32u));
      const float delta = __shfl_sync(kFull, s_best, wl);
      const int wp = __shfl_sync(kFull, s_p, wl);
      const int j1 = col0 ? 0 : 1 + wl + 32 * wk;

      u0 = u0 + delta * 0.f;  // the twin's u[0] (no used column has p = 0)
#pragma unroll
      for (int k = 0; k < K; ++k)
        u[k] = u[k] + delta * static_cast<float>(cnt[k]);
      v0 = v0 - delta;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if ((used >> k) & 1u)
          v[k] = v[k] - delta;
        else
          minv[k] = minv[k] - delta;
      }
      j0 = j1;
      i0 = wp;
    }

    // augment along the parent links (capped like the search)
    for (int it = 0; j0 != 0 && it <= n + 1; ++it) {
      const int jc = j0 - 1;
      const int j1 = __shfl_sync(kFull, pick(way, jc >> 5), jc & 31);
      const int pj =
          __shfl_sync(kFull, pick(p, (j1 - 1) >> 5), (j1 - 1) & 31);
      const int pj1 = j1 == 0 ? p0 : pj;
      if (lane == (jc & 31)) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k == (jc >> 5)) p[k] = pj1;
      }
      j0 = j1;
    }
  }

  // row -> column: the max column of each row (a broken chain can repeat
  // a row, and max keeps its column in range), 0 where none
  for (int r = lane; r < n; r += 32) r2c[r] = 0;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (((valid >> k) & 1u) && p[k] != 0)
      atomicMax(&r2c[p[k] - 1], lane + 32 * k);
  __syncwarp();
  for (int r = lane; r < n; r += 32) row_to_col[b * n + r] = r2c[r];
  const size_t o = b * (n + 1);
  if (lane == 0) {
    u_out[o] = u0;
    v_out[o] = v0;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if ((valid >> k) & 1u) {
      u_out[o + 1 + lane + 32 * k] = u[k];
      v_out[o + 1 + lane + 32 * k] = v[k];
    }
  }
  // total, row by row from 0: lane l loads row l + 32c's pick, the sum
  // takes them in order by shuffle
  float t = 0.f;
  for (int c = 0; c < n; c += 32) {
    const int r = c + lane;
    const float x = r < n ? M[static_cast<size_t>(r) * n + r2c[r]] : 0.f;
    const int m = min(32, n - c);
    for (int q = 0; q < m; ++q) t = t + __shfl_sync(kFull, x, q);
  }
  if (lane == 0) total[b] = t;
}

template <int K, bool SMEM>
int launch(int B, int n, int smem, const void* cost, void* row_to_col,
           void* total, void* u, void* v, cudaStream_t stream) {
  auto kern = hungarian_kernel<K, SMEM>;
  if (smem > 48 * 1024) {  // above 48 KB a kernel must opt in, once
    static const cudaError_t opt_in = [] {
      int dev = 0, most = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(hungarian_kernel<K, SMEM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
      return e;
    }();
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  kern<<<B, 32, smem, stream>>>(
      n, static_cast<const float*>(cost), static_cast<int*>(row_to_col),
      static_cast<float*>(total), static_cast<float*>(u),
      static_cast<float*>(v));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the launch plan (threads: one warp, smem, k: the columns a lane owns,
// in_smem: the matrix in shared memory) is the wrapper's launch_plan; this
// entry only picks the instantiation and refuses a plan that has none
extern "C" int hungarian_launch(int B, int n, int threads, int smem, int k,
                                int in_smem, const void* cost,
                                void* row_to_col, void* total, void* u,
                                void* v, void* stream) {
  if (B < 1 || n < 1 || threads != 32 || 32 * k < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int (*go)(int, int, int, const void*, void*, void*, void*, void*,
            cudaStream_t) = nullptr;
  if (in_smem) {
    switch (k) {
      case 1: go = launch<1, true>; break;
      case 2: go = launch<2, true>; break;
      case 4: go = launch<4, true>; break;
      case 8: go = launch<8, true>; break;
    }
  } else {
    switch (k) {
      case 8: go = launch<8, false>; break;
      case 16: go = launch<16, false>; break;
      case 32: go = launch<32, false>; break;
    }
  }
  if (go == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return go(B, n, smem, cost, row_to_col, total, u, v, s);
}
