// K3: the three nearest known points of every query point.
//
// Replaces jmodt_tpu/ops/pallas/three_nn.py::three_nn_pallas.  Distances
// are direct (dx*dx + dy*dy) + dz*dz, each operation rounded on its own;
// the result is the three smallest (distance, index) pairs in that
// lexicographic order, so among equal distances the lower index comes
// first; the output is (sqrt(d), idx).
//
// What bounds it on an H100: operations.  Every query meets every known
// point (16384 x 4096 pairs at the finest FP level, about nine float
// operations a pair); the bytes moved are a few hundred KB.
//
// Design: each query's known set is split over L lanes of a warp (lane j
// of a group takes the known points k with k % L == j), and each thread
// holds Q queries in registers, so a known point read from shared memory
// serves Q queries and the L lanes scan M / L points each.  A lane keeps
// the top 3 of its slice by a strict `<` insertion in ascending index
// order, which orders its slice by (distance, index); the L lanes then
// merge their sorted triples by XOR shuffles, comparing (distance, index),
// so the result is the sequential scan's.  The known set streams through
// two shared-memory tiles of 1024 points filled by cp.async, the next in
// flight while one is scanned; a group's lanes read consecutive points
// (stride 3 words: distinct banks) and the warp's groups the same ones
// (broadcasts).  The wrapper's plan (jmodt_torch/ops/interpolate.py::
// three_nn_launch_plan) picks L, Q and the block size per (B, N, M) so
// the grid fills the 132 SMs at every FP level.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kTile = 1024;              // known points a shared tile
constexpr int kTileFloats = 3 * kTile;

// (da, ia) before (db, ib) in (distance, index) order
__device__ __forceinline__ bool less_di(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// `floats` floats from src into dst as one cp.async group: 16 bytes a copy
// where kVec (src 16-byte aligned), a short last piece zero-filled; else 4.
template <bool kVec>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int floats, int tid, int threads) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kVec) {
    for (int e = tid * 4; e < floats; e += threads * 4) {
      const int bytes = min(16, 4 * (floats - e));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       d + 4 * e),
                   "l"(src + e), "r"(bytes));
    }
  } else {
    for (int e = tid; e < floats; e += threads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + 4 * e),
                   "l"(src + e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Q, bool kVec>
__global__ void __launch_bounds__(256)
    three_nn_kernel(const float* __restrict__ unknown,
                    const float* __restrict__ known, int n, int m, int lanes,
                    float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ __align__(16) float tile[2][kTileFloats];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = lane & (lanes - 1);          // the lane's slice
  // the group's first query: groups of `lanes` lanes, Q queries each
  const int group = (blockIdx.x * blockDim.x + tid) / lanes;
  const int q0 = group * Q;
  const float* u = unknown + static_cast<size_t>(b) * n * 3;
  const float* k = known + static_cast<size_t>(b) * m * 3;

  float ux[Q], uy[Q], uz[Q], d1[Q], d2[Q], d3[Q];
  int i1[Q], i2[Q], i3[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int qi = q0 + q;
    const bool ok = qi < n;
    ux[q] = ok ? u[3 * qi] : 0.0f;
    uy[q] = ok ? u[3 * qi + 1] : 0.0f;
    uz[q] = ok ? u[3 * qi + 2] : 0.0f;
    d1[q] = d2[q] = d3[q] = INFINITY;
    i1[q] = i2[q] = i3[q] = INT_MAX;   // loses every (distance, index) tie
  }

  const int tiles = (m + kTile - 1) / kTile;
  copy_tile<kVec>(tile[0], k, 3 * min(kTile, m), tid, blockDim.x);
  for (int t = 0; t < tiles; ++t) {
    const int base = t * kTile;
    if (t + 1 < tiles)
      copy_tile<kVec>(tile[(t + 1) & 1], k + 3 * (base + kTile),
                      3 * min(kTile, m - base - kTile), tid, blockDim.x);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // tile t has landed for every thread
    const float* s = tile[t & 1];
    const int cnt = min(kTile, m - base);
    for (int p = j; p < cnt; p += lanes) {
      const float kx = s[3 * p], ky = s[3 * p + 1], kz = s[3 * p + 2];
      const int jj = base + p;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float d = sq_dist(kx - ux[q], ky - uy[q], kz - uz[q]);
        if (d < d3[q]) {
          if (d < d2[q]) {
            d3[q] = d2[q];
            i3[q] = i2[q];
            if (d < d1[q]) {
              d2[q] = d1[q];
              i2[q] = i1[q];
              d1[q] = d;
              i1[q] = jj;
            } else {
              d2[q] = d;
              i2[q] = jj;
            }
          } else {
            d3[q] = d;
            i3[q] = jj;
          }
        }
      }
    }
    __syncthreads();  // every thread is done with the tile before reuse
  }

  // merge the group's sorted triples, (distance, index) order
  for (int off = 1; off < lanes; off <<= 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float y1 = __shfl_xor_sync(0xffffffffu, d1[q], off);
      float y2 = __shfl_xor_sync(0xffffffffu, d2[q], off);
      const float y3 = __shfl_xor_sync(0xffffffffu, d3[q], off);
      int j1 = __shfl_xor_sync(0xffffffffu, i1[q], off);
      int j2 = __shfl_xor_sync(0xffffffffu, i2[q], off);
      const int j3 = __shfl_xor_sync(0xffffffffu, i3[q], off);
      float x1 = d1[q], x2 = d2[q], x3 = d3[q];
      int k1 = i1[q], k2 = i2[q], k3 = i3[q];
      if (less_di(y1, j1, x1, k1)) {
        d1[q] = y1;
        i1[q] = j1;
        y1 = y2;
        j1 = j2;
        y2 = y3;
        j2 = j3;
      } else {
        d1[q] = x1;
        i1[q] = k1;
        x1 = x2;
        k1 = k2;
        x2 = x3;
        k2 = k3;
      }
      if (less_di(y1, j1, x1, k1)) {
        d2[q] = y1;
        i2[q] = j1;
        y1 = y2;
        j1 = j2;
      } else {
        d2[q] = x1;
        i2[q] = k1;
        x1 = x2;
        k1 = k2;
      }
      const bool take_y = less_di(y1, j1, x1, k1);
      d3[q] = take_y ? y1 : x1;
      i3[q] = take_y ? j1 : k1;
    }
  }

  if (j == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int qi = q0 + q;
      if (qi >= n) continue;
      const size_t o = (static_cast<size_t>(b) * n + qi) * 3;
      dist[o] = sqrtf(d1[q]);
      dist[o + 1] = sqrtf(d2[q]);
      dist[o + 2] = sqrtf(d3[q]);
      idx[o] = i1[q];
      idx[o + 1] = i2[q];
      idx[o + 2] = i3[q];
    }
  }
}

template <int Q>
cudaError_t launch_q(const float* unknown, const float* known, int batch,
                     int n, int m, int lanes, int threads, bool vec,
                     float* dist, int* idx, cudaStream_t stream) {
  const long per_block = static_cast<long>(threads) / lanes * Q;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  batch);
  if (vec)
    three_nn_kernel<Q, true><<<grid, threads, 0, stream>>>(
        unknown, known, n, m, lanes, dist, idx);
  else
    three_nn_kernel<Q, false><<<grid, threads, 0, stream>>>(
        unknown, known, n, m, lanes, dist, idx);
  return cudaGetLastError();
}

}  // namespace

// unknown (batch, n, 3), known (batch, m, 3) float32 contiguous, m >= 3 ->
// dist (batch, n, 3) float32, idx (batch, n, 3) int32.  `lanes` (1..32, a
// power of two) lanes share a query, each thread holds `queries` (1, 2 or
// 4) queries, `threads` (64, 128 or 256) a block, as the wrapper's plan
// chose (jmodt_torch/ops/interpolate.py::three_nn_launch_plan).
JMODT_API int jmodt_three_nn(const float* unknown, const float* known,
                             int batch, int n, int m, int lanes, int queries,
                             int threads, float* dist, int* idx,
                             cudaStream_t stream) {
  if (batch < 1 || n < 1 || m < 3 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || threads < 32 || threads > 256 ||
      threads % 32 != 0)
    return cudaErrorInvalidValue;
  // 16-byte copies when every cloud's known set starts on 16 bytes
  const bool vec = reinterpret_cast<size_t>(known) % 16 == 0 && m % 4 == 0;
  switch (queries) {
    case 1:
      return launch_q<1>(unknown, known, batch, n, m, lanes, threads, vec,
                         dist, idx, stream);
    case 2:
      return launch_q<2>(unknown, known, batch, n, m, lanes, threads, vec,
                         dist, idx, stream);
    case 4:
      return launch_q<4>(unknown, known, batch, n, m, lanes, threads, vec,
                         dist, idx, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
