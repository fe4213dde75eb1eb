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
//   (delta, j1) = the minimum of minv over the unused columns, the LOWER
//     index on ties (jnp.argmin);
//   u[r] += delta * (number of used columns j with p[j] = r), every r;
//   v[j] -= delta on used columns, minv[j] -= delta on the others;
//   j0 = j1.
// Then one lane walks the augmenting chain, p[j0] = p[way[j0]], while
// j0 != 0 and at most n + 2 steps: the caps are the twin's exits, so a chain
// that f32 drift breaks degrades the row instead of hanging the warp.  The
// row -> column map is the max over columns c with p[c+1] = r + 1 (0 where
// none), and total sums cost[r][row_to_col[r]] row by row from 0, in one lane.
// INF is FLT_MAX / 8, exact.  Built with -fmad=false (ops/kernels/build.py):
// u's delta * count is exact for counts 0 and 1 either way, but nothing may
// fuse into a sum the twin rounds twice.
//
// Layout: the n + 1 columns strided over the 32 lanes; u, v, minv, way, p,
// the per-row counts and used live in shared memory (25 (n + 1) + 4 n bytes,
// 849 B at n = 32); the matrix stays in global memory and a search trip
// reads one row of it.  A trip is one strided pass over the columns, a
// 5-step (value, index) shuffle reduction, one pass of shared-memory
// atomics for the row counts, and one pass each over the rows and columns.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32)
    hungarian_kernel(int n, const float* __restrict__ cost,
                     int* __restrict__ row_to_col, float* __restrict__ total,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N1 = n + 1;
  float* u = reinterpret_cast<float*>(smem);
  float* v = u + N1;
  float* minv = v + N1;
  int* way = reinterpret_cast<int*>(minv + N1);
  int* p = way + N1;
  int* cnt = p + N1;
  int* r2c = cnt + N1;
  unsigned char* used = reinterpret_cast<unsigned char*>(r2c + n);

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const float* A = cost + static_cast<size_t>(b) * n * n;
  const float INF = FLT_MAX / 8.0f;

  for (int j = lane; j < N1; j += 32) {
    u[j] = 0.f;
    v[j] = 0.f;
    p[j] = 0;
    cnt[j] = 0;
  }
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    for (int j = lane; j < N1; j += 32) {
      minv[j] = INF;
      used[j] = 0;
      way[j] = 0;
    }
    if (lane == 0) p[0] = i + 1;
    __syncwarp();

    int j0 = 0;
    for (int it = 0; p[j0] != 0 && it <= n + 1; ++it) {
      if (lane == 0) used[j0] = 1;
      __syncwarp();
      const int i0 = p[j0];
      const float ui0 = u[i0];
      const float* arow = A + static_cast<size_t>(i0 - 1) * n;
      float bv = INFINITY;
      int bj = N1;
      for (int j = lane; j < N1; j += 32) {
        const bool uj = used[j] != 0;
        float mj = minv[j];
        if (!uj) {
          const float cur = (j == 0) ? INF : ((-arow[j - 1] - ui0) - v[j]);
          if (cur < mj) {
            mj = cur;
            minv[j] = cur;
            way[j] = j0;
          }
        }
        const float dc = uj ? INF : mj;
        if (dc < bv) {  // a lane's columns ascend: the first index wins
          bv = dc;
          bj = j;
        }
      }
      #pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (ov < bv || (ov == bv && oj < bj)) {
          bv = ov;
          bj = oj;
        }
      }
      const float delta = bv;
      for (int j = lane; j < N1; j += 32)
        if (used[j]) atomicAdd(&cnt[p[j]], 1);
      __syncwarp();
      for (int r = lane; r < N1; r += 32) {
        u[r] = u[r] + delta * static_cast<float>(cnt[r]);
        cnt[r] = 0;
      }
      for (int j = lane; j < N1; j += 32) {
        if (used[j])
          v[j] = v[j] - delta;
        else
          minv[j] = minv[j] - delta;
      }
      __syncwarp();
      j0 = bj;
    }

    // augment along the parent links (capped like the search)
    if (lane == 0) {
      for (int it = 0; j0 != 0 && it <= n + 1; ++it) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
      p[0] = 0;
    }
    __syncwarp();
  }

  for (int r = lane; r < n; r += 32) r2c[r] = 0;
  __syncwarp();
  for (int c = lane; c < n; c += 32) {
    const int r = p[c + 1] - 1;
    if (r >= 0) atomicMax(&r2c[r], c);
  }
  __syncwarp();
  const size_t o = static_cast<size_t>(b);
  for (int r = lane; r < n; r += 32) row_to_col[o * n + r] = r2c[r];
  for (int j = lane; j < N1; j += 32) {
    u_out[o * N1 + j] = u[j];
    v_out[o * N1 + j] = v[j];
  }
  if (lane == 0) {
    float t = 0.f;
    for (int r = 0; r < n; ++r) t = t + A[static_cast<size_t>(r) * n + r2c[r]];
    total[b] = t;
  }
}

}  // namespace

// threads (one warp) and smem come from the wrapper's launch_plan
extern "C" int hungarian_launch(int B, int n, int threads, int smem,
                                const void* cost, void* row_to_col,
                                void* total, void* u, void* v, void* stream) {
  if (B < 1 || n < 1 || threads != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  hungarian_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(cost), static_cast<int*>(row_to_col),
      static_cast<float*>(total), static_cast<float*>(u),
      static_cast<float*>(v));
  return static_cast<int>(cudaGetLastError());
}
