// K5: one whole PointNet++ set-abstraction level (multi-scale grouping,
// use_xyz, eval weights with BatchNorm folded into each Dense).
//
// Replaces jmodt_tpu/ops/pallas/sa_level.py::sa_level_fused (the Pallas
// program `_sa_level_kernel`).  For every cloud b:
//
//   idx      = FPS(xyz, M)                       (K1's semantics, fps.cuh)
//   new_xyz  = xyz[idx]
//   per scale s (radius r, nsample S, folded layers (W1, b1) .. (WL, bL)):
//     table  = catf @ W1, catf = [xyz | feats]   (N x C1, before the gather)
//     cxw    = new_xyz @ W1[:3]                  (M x C1, centre correction)
//     nbr    = the first S points with d2 < r^2 in index order, misses
//              padded with the first hit, an empty ball all point 0
//     pooled[:, cols of s] = max_S relu(... relu(table[nbr] + b1 - cxw)
//                                         W2 + b2 ... WL + bL)
//
// d2 = (|q|^2 + |p|^2) - 2 q.p with each dot product and squared norm an
// fma chain whose steps are computed in double and rounded once to float:
// the bits of jmodt_torch/ops/grouping.py::pairwise_d2, so the kernel
// picks the same neighbours as the plain version even at r^2.
//
// What bounds it on an H100: at the main path's three levels the work is
// small (about 1 GFLOP of MLP a level, a few MB of tables); the FPS phase
// is sequential, M steps of one cluster's latency each.
//
// Design: the TPU ran one program per cloud with everything in VMEM.  Here
// one C entry launches four phases in stream order, so that all but FPS
// spread over the card:
//   1. FPS, one thread-block cluster per cloud: K1's kernel (fps.cuh), laid
//      out by the wrapper's plan (fps_cluster, fps_threads, fps_ppt).
//   2. The layer-1 tables of all scales, a register-tiled float32 product
//      (64 x 64 outputs a block, 4 x 4 a thread) reading catf straight
//      from xyz and feats.  The tables stay in global scratch, where L2
//      holds them (1 MB a scale at level 1).
//   3. The query, one warp per centre: it writes new_xyz and the cxw rows,
//      then scans the points in index order 32 at a time; a ballot and a
//      popcount rank the hits of each scale, and the scan stops once every
//      scale holds S hits.  The TPU's triangular-matmul rank, one-hot
//      gather and bf16 hi/lo tables are not needed.
//   4. Per scale, K4's grouped MLP (grouped_mlp.cuh): gather of the table
//      rows, layers 2..L on the tensor cores at float32 accuracy (3xTF32)
//      and the max, into the scale's columns of pooled.
// Phases 1-3 and the inputs of phase 4 are float32 FMA or exact float32.
#include <cmath>

#include "common.cuh"
#include "fps.cuh"
#include "grouped_mlp.cuh"

namespace {

constexpr int kMaxScales = 4;
constexpr int kSaThreads = 256;
constexpr int kTabTile = 64;   // table rows and columns per block
constexpr int kTabK = 32;      // reduction depth of one staged tile

struct Scales {
  float r2[kMaxScales];
  int ns[kMaxScales];
  int c1[kMaxScales];
  const float* w1[kMaxScales];  // (3 + C, C1)
  float* table[kMaxScales];     // (B, N, C1)
  float* cxw[kMaxScales];       // (B, M, C1)
  int* nbr[kMaxScales];         // (B, M, S)
};

// float32 a * b + c with one rounding of the exact product sum to double
// and one to float: the plain version's `_fma`
__device__ __forceinline__ float fma_d(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return fma_d(z, z, fma_d(y, y, __fmul_rn(x, x)));
}

// Phase 2: table[s][r, c] = sum_k catf[r, k] W1_s[k, c] over the B * N rows.
__global__ void __launch_bounds__(kSaThreads)
    table_kernel(const float* __restrict__ xyz,
                 const float* __restrict__ feats, int rows, int c,
                 Scales sc) {
  const int s = blockIdx.z;
  const int c1 = sc.c1[s];
  const int n0 = blockIdx.y * kTabTile;
  if (n0 >= c1) return;  // uniform per block
  const int row0 = blockIdx.x * kTabTile;
  const int cin = 3 + c;
  const float* __restrict__ w = sc.w1[s];
  __shared__ __align__(16) float at[kTabK][kTabTile + 4];
  __shared__ __align__(16) float wt[kTabK][kTabTile];
  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 4;
  const int cc0 = (tid % 16) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < cin; k0 += kTabK) {
    __syncthreads();  // the previous tiles are consumed
    for (int e = tid; e < kTabK * kTabTile; e += kSaThreads) {
      // catf: consecutive threads read consecutive channels of a row
      const int kk = e % kTabK, r = e / kTabK;
      const int k = k0 + kk, row = row0 + r;
      float v = 0.0f;
      if (row < rows && k < cin)
        v = k < 3 ? xyz[static_cast<size_t>(row) * 3 + k]
                  : feats[static_cast<size_t>(row) * c + (k - 3)];
      at[kk][r] = v;
      const int wk = k0 + e / kTabTile, col = n0 + e % kTabTile;
      wt[e / kTabTile][e % kTabTile] =
          (wk < cin && col < c1) ? w[static_cast<size_t>(wk) * c1 + col]
                                 : 0.0f;
    }
    __syncthreads();
    const int kmax = min(kTabK, cin - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&at[kk][r0]);
      const float4 wv = *reinterpret_cast<const float4*>(&wt[kk][cc0]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wa[j], acc[i][j]);
    }
  }
  float* __restrict__ out = sc.table[s];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + r0 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + cc0 + j;
      if (col < c1) out[static_cast<size_t>(row) * c1 + col] = acc[i][j];
    }
  }
}

// Phase 3: one warp per centre (b, m): new_xyz, the cxw rows and the
// neighbour lists of every scale.
__global__ void __launch_bounds__(kSaThreads)
    query_kernel(const float* __restrict__ xyz, const int* __restrict__ idx,
                 int batch, int n, int m, int nscales, Scales sc,
                 float* __restrict__ new_xyz) {
  const int centre = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (centre >= batch * m) return;  // uniform per warp
  const float* __restrict__ p =
      xyz + static_cast<size_t>(centre / m) * n * 3;
  const int j0 = idx[centre];
  const float qx = p[3 * j0], qy = p[3 * j0 + 1], qz = p[3 * j0 + 2];
  if (lane < 3)
    new_xyz[static_cast<size_t>(centre) * 3 + lane] =
        lane == 0 ? qx : (lane == 1 ? qy : qz);
  for (int s = 0; s < nscales; ++s) {
    const int c1 = sc.c1[s];
    const float* __restrict__ w = sc.w1[s];
    float* __restrict__ cxw = sc.cxw[s] + static_cast<size_t>(centre) * c1;
    for (int c = lane; c < c1; c += 32)
      cxw[c] = fmaf(qz, w[2 * c1 + c], fmaf(qy, w[c1 + c], qx * w[c]));
  }

  const float sqq = sq_norm(qx, qy, qz);
  const unsigned below = (1u << lane) - 1u;
  int cnt[kMaxScales], first[kMaxScales];
  int open = nscales;  // scales still short of S hits (warp-uniform)
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) cnt[s] = first[s] = 0;
  for (int base = 0; base < n && open > 0; base += 32) {
    const int i = base + lane;
    float d2 = 0.0f;
    if (i < n) {
      const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
      const float dot = fma_d(qz, pz, fma_d(qy, py, __fmul_rn(qx, px)));
      d2 = __fsub_rn(__fadd_rn(sqq, sq_norm(px, py, pz)),
                     __fmul_rn(2.0f, dot));
    }
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      const int ns = sc.ns[s];
      if (s >= nscales || cnt[s] >= ns) continue;  // warp-uniform
      const bool hit = i < n && d2 < sc.r2[s];
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (ballot == 0u) continue;
      if (cnt[s] == 0) first[s] = base + __ffs(ballot) - 1;
      const int rank = cnt[s] + __popc(ballot & below);
      if (hit && rank < ns)
        sc.nbr[s][static_cast<size_t>(centre) * ns + rank] = i;
      cnt[s] += __popc(ballot);
      if (cnt[s] >= ns) --open;
    }
  }
  for (int s = 0; s < nscales; ++s) {
    const int ns = sc.ns[s];
    const int have = min(cnt[s], ns);
    const int fill = have > 0 ? first[s] : 0;
    for (int slot = have + lane; slot < ns; slot += 32)
      sc.nbr[s][static_cast<size_t>(centre) * ns + slot] = fill;
  }
}

}  // namespace

// One SA level.  xyz (batch, n, 3), feats (batch, n, c) or null (c = 0),
// all float32 contiguous; the FPS phase runs clusters of fps_cluster blocks
// of fps_threads threads, fps_ppt points a thread.  Per scale s < nscales
// (host arrays):
// radii2[s] (float32 r^2), nsamples[s] (a multiple of 4 dividing 64),
// n_layers[s] in 2..kMaxLayers + 1, dims[s * (kMaxLayers + 2) + l] the
// widths [3 + c, C1, .., CL], weights / biases[s * (kMaxLayers + 1) + l]
// the folded (Cin, Cout) / (Cout,) layers, smem_bytes[s] and col_splits[s]
// the MLP phase's dynamic shared memory and column split (the wrapper's
// plan), and device scratch
// tables[s] (batch, n, C1), cxws[s] (batch, npoint, C1), nbrs[s]
// (batch, npoint, S) int32.  Outputs idx (batch, npoint) int32, new_xyz
// (batch, npoint, 3) and pooled (batch, npoint, sum CL), scale s in its
// columns, in order.
JMODT_API int jmodt_sa_level(
    const float* xyz, const float* feats, int batch, int n, int c,
    int npoint, int fps_cluster, int fps_threads, int fps_ppt, int nscales,
    const float* radii2, const int* nsamples, const int* n_layers,
    const int* dims, const float* const* weights, const float* const* biases,
    const int* smem_bytes, const int* col_splits, float* const* tables,
    float* const* cxws, int* const* nbrs, int* idx, float* new_xyz,
    float* pooled, cudaStream_t stream) {
  if (nscales < 1 || nscales > kMaxScales || npoint < 1 || npoint > n)
    return cudaErrorInvalidValue;
  Scales sc = {};
  int width = 0, max_c1 = 0;
  for (int s = 0; s < nscales; ++s) {
    const int* d = dims + s * (kMaxLayers + 2);
    const int ns = nsamples[s];
    if (n_layers[s] < 2 || n_layers[s] > kMaxLayers + 1 || d[0] != 3 + c ||
        ns < 4 || kRows % ns != 0)
      return cudaErrorInvalidValue;
    const int passes = (d[n_layers[s]] + kPassN - 1) / kPassN;
    if (col_splits[s] < 1 || col_splits[s] > passes)
      return cudaErrorInvalidValue;
    for (int l = 2; l <= n_layers[s]; ++l)  // K4's MLP: 16-byte cp.async
      if (d[l] % 4 != 0 ||
          reinterpret_cast<size_t>(weights[s * (kMaxLayers + 1) + l - 1]) %
                  16 != 0)
        return cudaErrorInvalidValue;
    sc.r2[s] = radii2[s];
    sc.ns[s] = ns;
    sc.c1[s] = d[1];
    sc.w1[s] = weights[s * (kMaxLayers + 1)];
    sc.table[s] = tables[s];
    sc.cxw[s] = cxws[s];
    sc.nbr[s] = nbrs[s];
    width += d[n_layers[s]];
    max_c1 = max(max_c1, d[1]);
  }

  cudaError_t err = fps_blocks(xyz, batch, n, npoint, fps_cluster,
                               fps_threads, fps_ppt, idx, stream);
  if (err != cudaSuccess) return err;

  const int rows = batch * n;
  const dim3 tab_grid((rows + kTabTile - 1) / kTabTile,
                      (max_c1 + kTabTile - 1) / kTabTile, nscales);
  table_kernel<<<tab_grid, kSaThreads, 0, stream>>>(xyz, feats, rows, c, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int warps = batch * npoint;
  const int per_block = kSaThreads / 32;
  query_kernel<<<(warps + per_block - 1) / per_block, kSaThreads, 0,
                 stream>>>(xyz, idx, batch, n, npoint, nscales, sc,
                           new_xyz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int col = 0;
  for (int s = 0; s < nscales; ++s) {
    const int* d = dims + s * (kMaxLayers + 2);
    const int n_rest = n_layers[s] - 1;
    Layers L = {};
    for (int l = 0; l < n_rest; ++l) {
      L.w[l] = weights[s * (kMaxLayers + 1) + l + 1];
      L.b[l] = biases[s * (kMaxLayers + 1) + l + 1];
    }
    for (int l = 0; l <= n_rest; ++l) L.dim[l] = d[l + 1];
    err = cudaFuncSetAttribute(grouped_gather_mlp_max_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes[s]);
    if (err != cudaSuccess) return err;
    const int tm = kRows / sc.ns[s];
    const dim3 grid((npoint + tm - 1) / tm, batch, col_splits[s]);
    grouped_gather_mlp_max_kernel<<<grid, kThreads, smem_bytes[s], stream>>>(
        sc.table[s], sc.nbr[s], sc.cxw[s], biases[s * (kMaxLayers + 1)], n,
        npoint, sc.ns[s], n_rest, L, pooled + col, width);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    col += d[n_layers[s]];
  }
  return cudaSuccess;
}
