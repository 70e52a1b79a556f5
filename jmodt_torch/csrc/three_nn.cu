// K3: the three nearest known points of every query point.
//
// Replaces jmodt_tpu/ops/pallas/three_nn.py::three_nn_pallas.  Distances
// are direct (dx*dx + dy*dy) + dz*dz, each operation rounded on its own;
// the result is sorted by (distance, index), so among equal distances the
// lower index comes first; the output is (sqrt(d), idx).
//
// What bounds it on an H100: operations.  Every query meets every known
// point (16384 x 4096 pairs at the finest FP level, about nine float
// operations a pair); the bytes moved are a few hundred KB.
//
// Design: one thread per query, which keeps its top-3 in registers and
// scans the known points in index order with strict `<` insertion; the
// known set streams through shared memory in tiles of 1024 points that
// every thread of the block reads as broadcasts.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
    three_nn_kernel(const float* __restrict__ unknown,
                    const float* __restrict__ known, int n, int m,
                    float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float kx[kTile], ky[kTile], kz[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const float* u = unknown + static_cast<size_t>(b) * n * 3;
  const float* k = known + static_cast<size_t>(b) * m * 3;
  float ux = 0.0f, uy = 0.0f, uz = 0.0f;
  if (q < n) {
    ux = u[3 * q];
    uy = u[3 * q + 1];
    uz = u[3 * q + 2];
  }
  float d1 = INFINITY, d2 = INFINITY, d3 = INFINITY;
  int i1 = 0, i2 = 0, i3 = 0;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      kx[j] = k[3 * (base + j)];
      ky[j] = k[3 * (base + j) + 1];
      kz[j] = k[3 * (base + j) + 2];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float d = sq_dist(kx[j] - ux, ky[j] - uy, kz[j] - uz);
      if (d < d3) {
        const int jj = base + j;
        if (d < d2) {
          d3 = d2;
          i3 = i2;
          if (d < d1) {
            d2 = d1;
            i2 = i1;
            d1 = d;
            i1 = jj;
          } else {
            d2 = d;
            i2 = jj;
          }
        } else {
          d3 = d;
          i3 = jj;
        }
      }
    }
  }
  if (q < n) {
    const size_t o = (static_cast<size_t>(b) * n + q) * 3;
    dist[o] = sqrtf(d1);
    dist[o + 1] = sqrtf(d2);
    dist[o + 2] = sqrtf(d3);
    idx[o] = i1;
    idx[o + 1] = i2;
    idx[o + 2] = i3;
  }
}

}  // namespace

// unknown (batch, n, 3), known (batch, m, 3) float32 contiguous, m >= 3 ->
// dist (batch, n, 3) float32, idx (batch, n, 3) int32.
JMODT_API int jmodt_three_nn(const float* unknown, const float* known,
                             int batch, int n, int m, float* dist, int* idx,
                             cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  three_nn_kernel<<<grid, kThreads, 0, stream>>>(unknown, known, n, m, dist,
                                                 idx);
  return cudaGetLastError();
}
