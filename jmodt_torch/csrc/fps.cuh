// K1's farthest point sampling of whole clouds, one thread-block cluster a
// cloud: shared by fps.cu (K1) and sa_level.cu (K5's FPS phase), so both
// give the same indices.
//
// Replaces jmodt_tpu/ops/pallas/fps.py::farthest_point_sample_pallas.
// Semantics: idx[0] = 0, the running min-distance starts at 1e10, distances
// are (dx*dx + dy*dy) + dz*dz rounded after every operation (sq_dist), and
// each step takes the argmax of the min-distance with ties to the smaller
// index.
//
// What bounds it on an H100: step latency.  The npoint - 1 steps are
// sequential, each needing the argmax of the one before; the arithmetic (9
// operations a point a step) and the bytes (12 a point, read once) are
// thousands of times below what the card could do in that time.  A step is
// one pass over the cloud plus an argmax across every thread that holds a
// point, so its time is that of the reduction's chain of barriers and loads.
//
// Design: one cluster of C blocks per cloud (up to 16, chosen by the
// wrapper, fps_launch_plan), so the pass is spread over C SMs.  Block r owns
// the contiguous points [r * chunk, (r + 1) * chunk), chunk = threads * PPT,
// and each thread PPT consecutive points whose x, y, z and min-distance stay
// in registers: the update reads no memory.  A candidate is (value, index,
// x, y, z), so the winner's coordinates arrive with it and the next step
// needs no dependent load.  Lanes, warps and ranks own ascending index
// ranges, so within a warp and within a block the lowest lane holding the
// maximum holds the smallest index: a REDUX max on the value's bits (min-
// distances are >= 0, so the bits order as unsigned ints) and a ballot find
// it.  A step is:
//   1. the update and each thread's first maximum;
//   2. each warp's argmax into a slot in shared memory, one block barrier;
//   3. warp 0 reduces the block's slots and its lanes write the block's
//      candidate into slot `rank` of every peer's shared memory with
//      st.async (DSMEM), each completing 20 bytes on the peer's mbarrier;
//   4. the cluster barrier: every thread waits on its own block's mbarrier,
//      which completes once all C candidates have landed, then every warp
//      reduces the C candidates, comparing (value, index).
// The slots and mbarriers are double-buffered by step parity, so one block
// barrier and one cluster barrier a step are enough.  The mbarrier form of
// the cluster barrier waits only for the C writes it needs, where
// barrier.cluster waits for every thread of the cluster, and measured
// faster on the H100.  With C = 1 steps 3-4 are skipped and every warp
// reduces the block's slots itself.  Points past N (the last block's tail)
// hold min-distance 0 at an index above every real point, so they never
// win.
//
// For K5 the kernel also streams its centres: each index is stored as a
// strong (relaxed, GPU-scope) store, which another SM's strong load sees
// without a fence, and every thread issues griddepcontrol.launch_dependents
// once its points are loaded, so a grid launched after it with
// programmatic stream serialization starts while it runs and can poll
// idx, filled with -1 beforehand, centre by centre (sa_level.cu).  For K1
// the instruction is a no-op.
#pragma once

// Internal linkage (an anonymous namespace): every source that includes
// this header gets its own copy, and no kernel symbol is exported twice.

#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kFpsThreads = 1024;    // threads a block at most
constexpr int kFpsMaxCluster = 16;   // blocks a cluster (above 8: non-portable)
constexpr int kFpsMaxPpt = 8;        // points a thread

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `p`'s twin in the block of rank `peer`
__device__ __forceinline__ unsigned peer_u32(const void* p, int peer) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_u32(p)), "r"(peer));
  return out;
}

// (v, i) into slot (sv, si) of block `peer`, completing 20 bytes of the
// transaction on its mbarrier `bar`
__device__ __forceinline__ void send_candidate(float4 v, int i, float4* sv,
                                               int* si,
                                               unsigned long long* bar,
                                               int peer) {
  const unsigned b = peer_u32(bar, peer);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(peer_u32(sv, peer)),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(b)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];" ::"r"(peer_u32(si, peer)),
      "r"(i), "r"(b)
      : "memory");
}

// One arrival on the block's own mbarrier, expecting `bytes` of transaction
__device__ __forceinline__ void expect_bytes(unsigned long long* bar,
                                             unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Until the mbarrier's phase of this parity has completed
__device__ __forceinline__ void wait_phase(unsigned long long* bar,
                                           unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// The centre `v` into o[t], visible to strong loads of other SMs
__device__ __forceinline__ void emit_centre(int* o, int t, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(o + t), "r"(v)
               : "memory");
}

// Lane holding the largest v of the warp, ties to the lowest lane; every v
// is >= 0, so its bits order as unsigned ints.
__device__ __forceinline__ int warp_max_lane(float v) {
  const unsigned bits = __float_as_uint(v);
  const unsigned top = __reduce_max_sync(0xffffffffu, bits);
  return __ffs(__ballot_sync(0xffffffffu, bits == top)) - 1;
}

template <int PPT>
__global__ void __launch_bounds__(kFpsThreads)
    fps_cluster_kernel(const float* __restrict__ xyz, int n, int npoint,
                       int* __restrict__ out) {
  // each warp's candidate (value, x, y, z) and index, by step parity
  __shared__ float4 warp_v[2][32];
  __shared__ int warp_i[2][32];
  // each rank's candidate, written by that rank through DSMEM, and the
  // mbarriers that count them in
  __shared__ float4 rank_v[2][kFpsMaxCluster];
  __shared__ int rank_i[2][kFpsMaxCluster];
  __shared__ __align__(8) unsigned long long bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cloud = blockIdx.x / csize;
  const float* p = xyz + static_cast<size_t>(cloud) * n * 3;
  int* o = out + static_cast<size_t>(cloud) * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int first = (rank * static_cast<int>(blockDim.x) + tid) * PPT;

  float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = first + k;
    const bool ok = i < n;
    x[k] = ok ? p[3 * i] : 0.0f;
    y[k] = ok ? p[3 * i + 1] : 0.0f;
    z[k] = ok ? p[3 * i + 2] : 0.0f;
    md[k] = ok ? 1e10f : 0.0f;  // fminf keeps a missing point at 0
  }
  float px = p[0], py = p[1], pz = p[2];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (rank == 0 && tid == 0) emit_centre(o, 0, 0);
  if (csize > 1) {
    if (tid == 0) {  // one arrival a phase: warp 0's expect_bytes
      for (int k = 0; k < 2; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
            smem_u32(&bar[k])));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster.sync();  // every peer's mbarriers exist before the first send
  }

  for (int t = 1; t < npoint; ++t) {
    const int par = t & 1;
    float bv = -1.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    int bi = first;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      md[k] = fminf(md[k], sq_dist(x[k] - px, y[k] - py, z[k] - pz));
      if (md[k] > bv) {  // ascending k: the first maximum stays
        bv = md[k];
        bi = first + k;
        bx = x[k];
        by = y[k];
        bz = z[k];
      }
    }
    if (lane == warp_max_lane(bv)) {
      warp_v[par][warp] = make_float4(bv, bx, by, bz);
      warp_i[par][warp] = bi;
    }
    __syncthreads();

    if (csize == 1 || warp == 0) {
      // the block's candidate: the lowest warp holding the maximum
      float4 c = lane < nwarps ? warp_v[par][lane]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int ci = lane < nwarps ? warp_i[par][lane] : INT_MAX;
      const int src = warp_max_lane(c.x);
      c.x = __shfl_sync(0xffffffffu, c.x, src);
      c.y = __shfl_sync(0xffffffffu, c.y, src);
      c.z = __shfl_sync(0xffffffffu, c.z, src);
      c.w = __shfl_sync(0xffffffffu, c.w, src);
      ci = __shfl_sync(0xffffffffu, ci, src);
      if (csize == 1) {
        px = c.y;
        py = c.z;
        pz = c.w;
        if (tid == 0) emit_centre(o, t, ci);
        continue;
      }
      if (lane == 0) expect_bytes(&bar[par], 20 * csize);
      if (lane < csize)  // into slot `rank` of peer `lane`
        send_candidate(c, ci, &rank_v[par][rank], &rank_i[par][rank],
                       &bar[par], lane);
    }
    // bar[par]'s phases complete at steps par, par + 2, ...: this one is
    // its ((t - 1) / 2)-th
    wait_phase(&bar[par], ((t - 1) >> 1) & 1);

    // the cloud's winner: largest value, then smallest index
    const bool live = lane < csize;
    const float4 c = live ? rank_v[par][lane]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const unsigned ci = live ? static_cast<unsigned>(rank_i[par][lane])
                             : 0xffffffffu;
    const unsigned bits = __float_as_uint(c.x);
    const unsigned top = __reduce_max_sync(0xffffffffu, bits);
    const unsigned win =
        __reduce_min_sync(0xffffffffu, bits == top ? ci : 0xffffffffu);
    const int src = __ffs(__ballot_sync(0xffffffffu, ci == win)) - 1;
    px = __shfl_sync(0xffffffffu, c.y, src);
    py = __shfl_sync(0xffffffffu, c.z, src);
    pz = __shfl_sync(0xffffffffu, c.w, src);
    if (rank == 0 && tid == 0)
      emit_centre(o, t, static_cast<int>(win));
  }
  // no block leaves while a peer may still write into its shared memory
  if (csize > 1) cluster.sync();
}

// A launch of `blocks` blocks of `threads` threads in clusters of csize
// blocks; `attr` holds the cluster's shape and must outlive the config.
inline cudaLaunchConfig_t cluster_config(int blocks, int threads, int csize,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int PPT>
cudaError_t launch_fps_cluster(const float* xyz, int batch, int n,
                               int npoint, int csize, int threads, int* out,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel<PPT>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(batch * csize, threads, csize, &attr, stream);
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<PPT>, xyz, n, npoint,
                           out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The largest cluster of K1's widest kernel (1024 threads, kFpsMaxPpt
// points a thread) the card can place: 16, 8, 4, 2 or 1, into *out.
inline cudaError_t fps_max_cluster(int* out) {
  *out = 0;
  const cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel<kFpsMaxPpt>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  for (int c = kFpsMaxCluster; c >= 1; c /= 2) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(c, kFpsThreads, c, &attr, nullptr);
    int active = 0;
    const cudaError_t q = cudaOccupancyMaxActiveClusters(
        &active, fps_cluster_kernel<kFpsMaxPpt>, &cfg);
    if (q != cudaSuccess) return q;
    if (active > 0) {
      *out = c;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

// xyz (batch, n, 3) float32 contiguous -> out (batch, npoint) int32; one
// cluster of csize blocks of `threads` threads per cloud, ppt points a
// thread, as the wrapper's plan (jmodt_torch/ops/sampling.py::
// fps_launch_plan) chose: every block must hold at least one point.
inline cudaError_t fps_blocks(const float* xyz, int batch, int n, int npoint,
                              int csize, int threads, int ppt, int* out,
                              cudaStream_t stream) {
  const long chunk = static_cast<long>(threads) * ppt;
  if (batch < 1 || npoint < 1 || npoint > n || csize < 1 ||
      csize > kFpsMaxCluster || threads < 32 || threads > kFpsThreads ||
      threads % 32 != 0 || chunk * csize < n || chunk * (csize - 1) >= n)
    return cudaErrorInvalidValue;
  switch (ppt) {
    case 1:
      return launch_fps_cluster<1>(xyz, batch, n, npoint, csize, threads,
                                   out, stream);
    case 2:
      return launch_fps_cluster<2>(xyz, batch, n, npoint, csize, threads,
                                   out, stream);
    case 4:
      return launch_fps_cluster<4>(xyz, batch, n, npoint, csize, threads,
                                   out, stream);
    case 8:
      return launch_fps_cluster<8>(xyz, batch, n, npoint, csize, threads,
                                   out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
