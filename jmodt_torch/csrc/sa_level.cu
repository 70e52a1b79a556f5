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
// small (about 1 GFLOP of MLP a level, a few MB of tables); the FPS is
// sequential, M steps of one cluster's latency each, on 1-4 SMs a cloud.
// With everything else behind the FPS, what is left after its last centre
// is that centre's query and one MLP block of the last chunk (PERF.md).
//
// Design: two grids on the stream.  The first is K1's FPS, one thread-
// block cluster a cloud (fps.cuh, laid out by the wrapper's plan), which
// stores each chosen centre with a strong GPU-scope store into idx, filled
// with -1 by the wrapper, and lets the next grid launch while it runs
// (griddepcontrol.launch_dependents).  The second, launched with
// programmatic stream serialization, is one consumer block an SM on the
// SMs FPS leaves free, or two where their shared memory fits twice; each
// block takes work tickets from a counter, in this order:
//   1. the layer-1 tables of all scales, 32 x 32 register-tiled float32
//      tiles reading catf straight from xyz and feats (they need no
//      centre, so they run beside the FPS);
//   2. per chunk of centres, cloud by cloud: the query units, which stage
//      the cloud in shared memory and then run one warp a centre (new_xyz,
//      the cxw rows, and a scan of the points in index order, 4 x 32
//      distances measured at once, then per 32 a ballot and a popcount
//      ranking each scale's hits, stopping once every scale holds S
//      hits), then the MLP units of every scale: K4's grouped MLP
//      (grouped_mlp.cuh) on 64 rows, layers 2..L on the tensor cores at
//      float32 accuracy (3xTF32), the max into the scale's columns of
//      pooled.
// A query warp polls its centre's idx (ld.relaxed.gpu) until FPS has
// written it: the index is its own flag, so the FPS needs no fence and no
// counter.  An MLP unit waits for every table tile and its chunk's query
// units, counted in device memory by atomics after a fence and read with
// ld.acquire.gpu.  A block only waits for the FPS, whose blocks are all
// resident before the consumer grid starts, or for tickets handed out
// earlier, which running blocks hold: no wait can deadlock.  When the last
// centre is chosen, only the last chunk's units are left.  The consumer
// blocks of an SM take all its shared memory between them, so none lands
// on an SM that runs FPS, and each ends with griddepcontrol.wait, so the
// grid completes after the FPS and the next kernel on the stream sees
// every output.  The wrapper's plan (jmodt_torch/ops/sa_level.py::
// k5_launch_plan) sets the chunk, the consumer blocks and each scale's
// column split of the MLP units.
// Everything but the MLP products is float32 FMA or exact float32.
#include <cmath>

#include "common.cuh"
#include "fps.cuh"
#include "grouped_mlp.cuh"

namespace {

constexpr int kMaxScales = 4;
constexpr int kSaThreads = kThreads;  // 256: K4's block, 8 query warps
constexpr int kSaWarps = kSaThreads / 32;
constexpr int kTabTile = 32;   // table rows and columns per tile
constexpr int kTabK = 32;      // reduction depth of one staged tile
constexpr int kTabSmem = 4 * kTabK * (2 * kTabTile + 4);
constexpr int kScanBlocks = 4;  // 32-point blocks measured at once

struct Scales {
  float r2[kMaxScales];
  int ns[kMaxScales];
  int c1[kMaxScales];
  const float* w1[kMaxScales];  // (3 + C, C1)
  const float* b1[kMaxScales];  // (C1,)
  float* table[kMaxScales];     // (B, N, C1)
  float* cxw[kMaxScales];       // (B, M, C1)
  int* nbr[kMaxScales];         // (B, M, S)
  Layers mlp[kMaxScales];       // layers 2..L, dims from C1
  int n_rest[kMaxScales];       // layers in mlp
  int col[kMaxScales];          // first column in pooled
  int split[kMaxScales];        // blocks sharing the last layer's columns
};

// The consumer grid's tickets: [0, tab_end) table tiles, scale s from
// tab_start[s]; then groups of `group` tickets, chunk by chunk and cloud by
// cloud: `qunits` query units, then scale s's MLP units from
// unit_start[s].
struct Tickets {
  int row_tiles;
  int tab_start[kMaxScales + 1];
  int chunk, nchunks, qunits;
  int unit_start[kMaxScales + 1];
  int group, total;
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

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The block waits until *p >= v; what was written before the matching
// release is then visible to every thread of the block.
__device__ __forceinline__ void wait_count(const int* p, int v) {
  if (threadIdx.x == 0)
    while (load_acquire(p) < v) __nanosleep(128);
  __syncthreads();
}

// Every thread's writes so far, then one count on *p.
__device__ __forceinline__ void signal_count(int* p) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p, 1);
}

// Table tile `tile` of scale s: table[s][rows, cols] = catf W1_s over 32
// rows and 32 columns (2 x 2 a thread), catf staged kTabK deep in shared
// memory.
__device__ __forceinline__ void table_tile(const float* __restrict__ xyz,
                                           const float* __restrict__ feats,
                                           int rows, int c, const Scales& sc,
                                           int s, int tile, int row_tiles,
                                           float* smem) {
  const int c1 = sc.c1[s];
  const int row0 = (tile % row_tiles) * kTabTile;
  const int n0 = (tile / row_tiles) * kTabTile;
  const int cin = 3 + c;
  const float* __restrict__ w = sc.w1[s];
  float(*at)[kTabTile + 4] = reinterpret_cast<float(*)[kTabTile + 4]>(smem);
  float(*wt)[kTabTile] =
      reinterpret_cast<float(*)[kTabTile]>(smem + kTabK * (kTabTile + 4));
  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 2;
  const int cc0 = (tid % 16) * 2;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

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
      const float2 a = *reinterpret_cast<const float2*>(&at[kk][r0]);
      const float2 wv = *reinterpret_cast<const float2*>(&wt[kk][cc0]);
      acc[0][0] = fmaf(a.x, wv.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, wv.y, acc[0][1]);
      acc[1][0] = fmaf(a.y, wv.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, wv.y, acc[1][1]);
    }
  }
  float* __restrict__ out = sc.table[s];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + cc0 + j;
      if (col < c1) out[static_cast<size_t>(row) * c1 + col] = acc[i][j];
    }
  }
}

// The warp waits until the FPS grid has written idx[centre] (>= 0).
__device__ __forceinline__ int wait_centre(const int* idx, int centre) {
  int v = -1;
  if ((threadIdx.x & 31) == 0)
    for (;;) {
      asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
                   : "=r"(v)
                   : "l"(idx + centre)
                   : "memory");
      if (v >= 0) break;
      __nanosleep(128);
    }
  return __shfl_sync(0xffffffffu, v, 0);
}

// One warp: centre `centre` (= b * m + mm) of the cloud p (n x 3, in
// shared memory), at FPS index j0.  Writes new_xyz, the cxw rows and the
// neighbour lists of every scale.
__device__ __forceinline__ void query_centre(const float* p, int j0, int n,
                                             int nscales, const Scales& sc,
                                             int centre,
                                             float* __restrict__ new_xyz) {
  const int lane = threadIdx.x & 31;
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
  for (int base = 0; base < n && open > 0; base += 32 * kScanBlocks) {
    // kScanBlocks independent d2 chains, then their hits in index order
    float d2[kScanBlocks];
#pragma unroll
    for (int u = 0; u < kScanBlocks; ++u) {
      const int i = min(base + 32 * u + lane, n - 1);
      const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
      const float dot = fma_d(qz, pz, fma_d(qy, py, __fmul_rn(qx, px)));
      d2[u] = __fsub_rn(__fadd_rn(sqq, sq_norm(px, py, pz)),
                        __fmul_rn(2.0f, dot));
    }
#pragma unroll
    for (int u = 0; u < kScanBlocks; ++u) {
      const int i = base + 32 * u + lane;
#pragma unroll
      for (int s = 0; s < kMaxScales; ++s) {
        const int ns = sc.ns[s];
        if (s >= nscales || cnt[s] >= ns) continue;  // warp-uniform
        const bool hit = i < n && d2[u] < sc.r2[s];
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (ballot == 0u) continue;
        if (cnt[s] == 0) first[s] = base + 32 * u + __ffs(ballot) - 1;
        const int rank = cnt[s] + __popc(ballot & below);
        if (hit && rank < ns)
          sc.nbr[s][static_cast<size_t>(centre) * ns + rank] = i;
        cnt[s] += __popc(ballot);
        if (cnt[s] >= ns) --open;
      }
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

// The consumer grid.  counters: [0] the next ticket, [1] table tiles done,
// then per (cloud, chunk) the query units done; all zero at launch.
__global__ void __launch_bounds__(kSaThreads, 2)
    sa_consumer_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ feats, const int* idx,
                       int batch, int n, int c, int m, int nscales, Scales sc,
                       Tickets tk, int width, int* counters,
                       float* __restrict__ new_xyz,
                       float* __restrict__ pooled) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ticket;
  int* const next = counters;
  int* const tables_done = counters + 1;
  int* const queries_done = counters + 2;
  const int tab_end = tk.tab_start[nscales];
  for (;;) {
    __syncthreads();  // the last unit is done with smem and `ticket`
    if (threadIdx.x == 0) ticket = atomicAdd(next, 1);
    __syncthreads();
    const int t = ticket;
    if (t >= tk.total) break;
    if (t < tab_end) {
      int s = 0;
      while (t >= tk.tab_start[s + 1]) ++s;
      table_tile(xyz, feats, batch * n, c, sc, s, t - tk.tab_start[s],
                 tk.row_tiles, smem);
      signal_count(tables_done);
      continue;
    }
    const int g = (t - tab_end) / tk.group, r = (t - tab_end) % tk.group;
    const int k = g / batch, b = g % batch;
    const int c0 = k * tk.chunk;
    const int c_end = min(c0 + tk.chunk, m);
    if (r < tk.qunits) {
      // the cloud into shared memory, then one warp a centre as it comes
      const float* __restrict__ src = xyz + static_cast<size_t>(b) * n * 3;
      for (int e = threadIdx.x; e < 3 * n; e += kSaThreads) smem[e] = src[e];
      __syncthreads();
      const int mm = c0 + r * kSaWarps + (threadIdx.x >> 5);
      if (mm < c_end)  // warp-uniform
        query_centre(smem, wait_centre(idx, b * m + mm), n, nscales, sc,
                     b * m + mm, new_xyz);
      signal_count(queries_done + b * tk.nchunks + k);
      continue;
    }
    int s = 0;
    while (r >= tk.unit_start[s + 1]) ++s;
    const int u = r - tk.unit_start[s];
    const int tm = kRows / sc.ns[s];
    const int mblk = c0 / tm + u / sc.split[s];
    if (mblk * tm >= c_end) continue;  // past the last centre
    wait_count(tables_done, tab_end);
    wait_count(queries_done + b * tk.nchunks + k, tk.qunits);
    grouped_mlp_block<true>(smem, sc.table[s], sc.nbr[s], sc.cxw[s],
                            sc.b1[s], n, m, sc.ns[s], sc.n_rest[s],
                            sc.mlp[s], pooled + sc.col[s], width, mblk, b,
                            u % sc.split[s], sc.split[s]);
  }
  // the grid ends after the FPS grid, whose idx the next kernel may read
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

}  // namespace

// One SA level.  xyz (batch, n, 3), feats (batch, n, c) or null (c = 0),
// all float32 contiguous; the FPS runs clusters of fps_cluster blocks of
// fps_threads threads, fps_ppt points a thread; `consumers` blocks, per_sm
// (1 or 2) an SM, run the rest, `chunk` centres (a multiple of 16) at a
// time.
// Per scale s < nscales (host arrays): radii2[s] (float32 r^2),
// nsamples[s] (a multiple of 4 dividing 64), n_layers[s] in
// 2..kMaxLayers + 1, dims[s * (kMaxLayers + 2) + l] the widths [3 + c, C1,
// .., CL], weights / biases[s * (kMaxLayers + 1) + l] the folded (Cin,
// Cout) / (Cout,) layers, smem_bytes[s] the MLP's shared memory and
// col_splits[s] the blocks that share its last layer (the wrapper's plan),
// and device scratch tables[s] (batch, n, C1), cxws[s] (batch, npoint,
// C1), nbrs[s] (batch, npoint, S) int32.  counters: 2 + batch *
// ceil(npoint / chunk) int32, zeroed.  Outputs idx (batch, npoint) int32,
// filled with -1 by the caller, new_xyz (batch, npoint, 3) and pooled
// (batch, npoint, sum CL), scale s in its columns, in order.
JMODT_API int jmodt_sa_level(
    const float* xyz, const float* feats, int batch, int n, int c,
    int npoint, int fps_cluster, int fps_threads, int fps_ppt, int chunk,
    int consumers, int per_sm, int nscales, const float* radii2,
    const int* nsamples, const int* n_layers, const int* dims,
    const float* const* weights,
    const float* const* biases, const int* smem_bytes, const int* col_splits,
    float* const* tables, float* const* cxws, int* const* nbrs,
    int* counters, int* idx, float* new_xyz, float* pooled,
    cudaStream_t stream) {
  if (nscales < 1 || nscales > kMaxScales || npoint < 1 || npoint > n ||
      chunk < 16 || chunk % 16 != 0 || consumers < 1 || per_sm < 1 ||
      per_sm > 2)
    return cudaErrorInvalidValue;
  Scales sc = {};
  Tickets tk = {};
  tk.row_tiles = (batch * n + kTabTile - 1) / kTabTile;
  tk.chunk = chunk;
  tk.nchunks = (npoint + chunk - 1) / chunk;
  tk.qunits = chunk / kSaWarps;
  tk.unit_start[0] = tk.qunits;
  int width = 0, smem_need = max(kTabSmem, 12 * n);  // tiles, the cloud
  for (int s = 0; s < nscales; ++s) {
    const int* d = dims + s * (kMaxLayers + 2);
    const int ns = nsamples[s];
    const int n_rest = n_layers[s] - 1;
    if (n_rest < 1 || n_rest > kMaxLayers || d[0] != 3 + c || ns < 4 ||
        kRows % ns != 0)
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
    sc.b1[s] = biases[s * (kMaxLayers + 1)];
    sc.table[s] = tables[s];
    sc.cxw[s] = cxws[s];
    sc.nbr[s] = nbrs[s];
    sc.n_rest[s] = n_rest;
    for (int l = 0; l < n_rest; ++l) {
      sc.mlp[s].w[l] = weights[s * (kMaxLayers + 1) + l + 1];
      sc.mlp[s].b[l] = biases[s * (kMaxLayers + 1) + l + 1];
    }
    for (int l = 0; l <= n_rest; ++l) sc.mlp[s].dim[l] = d[l + 1];
    sc.col[s] = width;
    sc.split[s] = col_splits[s];
    width += d[n_layers[s]];
    smem_need = max(smem_need, smem_bytes[s]);
    tk.tab_start[s + 1] =
        tk.tab_start[s] + tk.row_tiles * ((d[1] + kTabTile - 1) / kTabTile);
    tk.unit_start[s + 1] =
        tk.unit_start[s] + chunk / (kRows / ns) * col_splits[s];
  }
  tk.group = tk.unit_start[nscales];
  tk.total = tk.tab_start[nscales] + tk.group * tk.nchunks * batch;

  // the SM's shared memory split between per_sm consumer blocks, so none
  // shares an SM with an FPS block
  int dev = 0, optin = 0, per_sm_smem = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, sa_consumer_kernel);
  if (err != cudaSuccess) return err;
  const int dyn = min(optin, per_sm_smem / per_sm - reserved) -
                  static_cast<int>(fa.sharedSizeBytes);
  if (dyn < smem_need) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(sa_consumer_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn);
  if (err != cudaSuccess) return err;

  err = fps_blocks(xyz, batch, n, npoint, fps_cluster, fps_threads, fps_ppt,
                   idx, stream);
  if (err != cudaSuccess) return err;

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(consumers);
  cfg.blockDim = dim3(kSaThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sa_consumer_kernel, xyz, feats,
                           static_cast<const int*>(idx), batch, n, c, npoint,
                           nscales, sc, tk, width, counters, new_xyz, pooled);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
