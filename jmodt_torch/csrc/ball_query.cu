// The ball query on the card: jmodt_torch/ops/grouping.py::
// ball_query_multi, every scale of a call in one pass.  It replaces no TPU
// kernel: the JAX package computes the query in plain XLA
// (jmodt_tpu/ops/grouping.py::ball_query_multi), and the port's plain
// version writes each chunk's (centres x N) float64 d2 and int32 ranks to
// device memory and reads them back.
//
// For each centre and scale (r^2, nsample S): the first S points in index
// order with d2 < r^2, misses padded with the first hit, an empty ball all
// point 0; d2 bit-equal to the plain version's (ball_query.cuh).
//
// What bounds it on an H100: the exact d2.  A pair takes two double fmas
// and four float <-> double conversions, and an SM converts 16 values a
// cycle.  RPN level 0 (4096 centres over 16384 points; most balls never
// fill, so most centres scan the whole cloud) is about 67M pairs, some
// 0.07 ms at that rate; measured 0.10 ms.  The bytes are the cloud, read
// once a block from L2.
//
// Design: one warp a centre, `warps` warps a block on consecutive centres
// of one cloud.  The cloud passes through shared memory in tiles of
// `tile` points, as columns: y and z in double, converted once a point,
// x and |p|^2 in float, |p|^2 computed once a point as it is staged.
// Every warp of the block scans each tile.  While they scan tile t, each
// thread holds kStage points of tile t + 1 in registers, loaded before the
// scan and stored into the other buffer after it: one barrier a tile,
// which also asks whether any warp still scans.  A warp scans in index
// order, kScanBlocks x 32 points at once, ranks each scale's hits by
// ballot and popcount (K5's scan), skipping the ranking where no point is
// within the largest radius, and stops once every scale holds S hits;
// the block stops at the first tile boundary where all its warps have.
// The wrapper's plan (grouping.py::ball_query_plan) stages the whole cloud
// as one tile where it fits in the shared memory of two tiles, else tiles
// of kStage x 32 x warps points, as many as the cloud needs.
#include <climits>

#include "ball_query.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 16;  // 512 threads, two blocks an SM
constexpr int kStage = 4;      // points of the next tile a thread holds
constexpr int kPointBytes = 2 * sizeof(double) + 2 * sizeof(float);

// A staged tile of `tile` points at `base`: y and z (double), then x and
// |p|^2 (float).
struct Tile {
  double* y;
  double* z;
  float* x;
  float* pp;
  __device__ Tile(unsigned char* base, int tile)
      : y(reinterpret_cast<double*>(base)),
        z(y + tile),
        x(reinterpret_cast<float*>(z + tile)),
        pp(x + tile) {}
  __device__ void put(int j, float px, float py, float pz) const {
    x[j] = px;
    y[j] = py;
    z[j] = pz;
    pp[j] = sq_norm(px, py, pz);
  }
};

__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ new_xyz, int n, int m,
                      int nscales, BallScales sc, int tile,
                      int blocks_per_cloud) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / blocks_per_cloud;
  const int mm = (blockIdx.x % blocks_per_cloud) * (threads >> 5) +
                 (threadIdx.x >> 5);
  const size_t centre = static_cast<size_t>(b) * m + mm;
  const float* __restrict__ cloud = xyz + static_cast<size_t>(b) * n * 3;
  const size_t tile_bytes = static_cast<size_t>(tile) * kPointBytes;
  const int tiles = (n + tile - 1) / tile;

  float r2max = sc.r2[0];  // no scale hits a point at d2 >= r2max
#pragma unroll
  for (int s = 1; s < kMaxScales; ++s)
    if (s < nscales) r2max = fmaxf(r2max, sc.r2[s]);
  float qx = 0.0f, sqq = 0.0f;
  double qy = 0.0, qz = 0.0;
  BallScan st = ball_scan_start(mm < m ? nscales : 0);  // warp-uniform
  if (mm < m) {
    const float* q = new_xyz + centre * 3;
    qx = q[0];
    sqq = sq_norm(q[0], q[1], q[2]);
    qy = q[1];
    qz = q[2];
  }

  const Tile first(smem, tile);
  for (int j = threadIdx.x; j < min(tile, n); j += threads)
    first.put(j, cloud[3 * j], cloud[3 * j + 1], cloud[3 * j + 2]);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int start = t * tile;
    const int end = min(start + tile, n);
    const bool more = t + 1 < tiles;  // then tile == kStage * threads
    float next[kStage][3] = {};
    if (more) {
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = end + threadIdx.x + k * threads;
        if (i < n) {
          const float* p = cloud + static_cast<size_t>(i) * 3;
          next[k][0] = p[0];
          next[k][1] = p[1];
          next[k][2] = p[2];
        }
      }
    }
    if (st.open > 0) {
      const Tile cur(smem + (t & 1) * tile_bytes, tile);
      const int last = end - start - 1;
      for (int base = start; base < end && st.open > 0;
           base += 32 * kScanBlocks) {
        // kScanBlocks independent d2 chains, then their hits in index order
        float d2[kScanBlocks];
        bool near = false;
#pragma unroll
        for (int u = 0; u < kScanBlocks; ++u) {
          const int j = min(base - start + 32 * u + lane, last);
          d2[u] = ball_d2(qx, qy, qz, sqq, cur.x[j], cur.y[j], cur.z[j],
                          cur.pp[j]);
          near |= d2[u] < r2max;
        }
        // in a sparse cloud most blocks hold no hit: skip their ranking
        if (__any_sync(0xffffffffu, near))
          ball_rank(d2, base, end, nscales, sc, centre, st);
      }
    }
    if (more) {
      const Tile nxt(smem + ((t + 1) & 1) * tile_bytes, tile);
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int j = threadIdx.x + k * threads;
        if (end + j < n) nxt.put(j, next[k][0], next[k][1], next[k][2]);
      }
    }
    // the next tile is staged and this one read; stop when no warp scans
    if (!__syncthreads_or(st.open > 0)) break;
  }
  if (mm < m) ball_pad(st, nscales, sc, centre);
}

}  // namespace

// The ball query of `batch` clouds: xyz (batch, n, 3) and new_xyz (batch,
// m, 3), float32 contiguous.  Per scale s < nscales (host arrays):
// radii2[s] (float32 r^2), nsamples[s] >= 1 and the output nbrs[s]
// (batch, m, nsamples[s]) int32.  `warps` (1..kMaxWarps) centres a block;
// tiles of `tile` points: the whole cloud (tile >= n) or kStage x 32 x
// warps points.
JMODT_API int jmodt_ball_query(const float* xyz, const float* new_xyz,
                               int batch, int n, int m, int nscales,
                               const float* radii2, const int* nsamples,
                               int warps, int tile, int* const* nbrs,
                               cudaStream_t stream) {
  if (batch < 1 || n < 1 || m < 1 || nscales < 1 || nscales > kMaxScales ||
      warps < 1 || warps > kMaxWarps || tile < 1)
    return cudaErrorInvalidValue;
  const int tiles = (n + tile - 1) / tile;
  if (tiles > 1 && tile != kStage * 32 * warps) return cudaErrorInvalidValue;
  BallScales sc = {};
  for (int s = 0; s < nscales; ++s) {
    if (nsamples[s] < 1) return cudaErrorInvalidValue;
    sc.r2[s] = radii2[s];
    sc.ns[s] = nsamples[s];
    sc.nbr[s] = nbrs[s];
  }
  const int per_cloud = (m + warps - 1) / warps;
  if (static_cast<long long>(batch) * per_cloud > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(tiles > 1 ? 2 : 1) * tile * kPointBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ball_query_kernel<<<batch * per_cloud, warps * 32, smem, stream>>>(
      xyz, new_xyz, n, m, nscales, sc, tile, per_cloud);
  return cudaGetLastError();
}
