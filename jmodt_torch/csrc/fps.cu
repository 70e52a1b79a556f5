// K1 and K2: farthest point sampling.
//
// Replaces jmodt_tpu/ops/pallas/fps.py::farthest_point_sample_pallas (K1,
// one cloud) and ::farthest_point_sample_batched_pallas (K2, many clouds).
// Semantics: idx[0] = 0, the running min-distance starts at 1e10, and each
// step takes the argmax of the min-distance with ties to the smaller index.
//
// What bounds it on an H100: step latency.  The npoint steps are
// sequential, each depending on the argmax of the one before, so the time
// is npoint times the latency of one step (a pass over the cloud plus an
// argmax across the threads that hold it), not bytes or FLOPs.
//
// K1 (fps.cuh, shared with K5's FPS phase) runs one thread-block cluster
// per cloud, up to 16 blocks that each hold a slice of the cloud in
// registers and exchange one candidate a step through distributed shared
// memory, so level 0 (16384 points) is spread over 16 SMs with one block
// barrier and one cluster barrier a step.
//
// K2 takes the RCNN's RoI clouds: 100 a stream, N <= 1024 points each
// (512 -> 128 at sa_0, 128 -> 32 at sa_1).  A cloud gets W warps (1, 2 or
// 4) and a block of 4 warps holds 4 / W clouds, so every warp of a block
// has an SM sub-partition of its own; the wrapper's plan
// (jmodt_torch/ops/sampling.py::fps_batched_launch_plan) picks W.  Thread
// q of a cloud's 32 W holds the points q + 32 W k, k < PPT, in registers
// (coordinates and min-distance), so a lane's points ascend with k and a
// warp's lanes interleave.  A step is:
//   1. the update of the lane's PPT min-distances, then the lane's first
//      maximum by a balanced tree over k (log2 PPT levels, the right half
//      taken only when strictly larger, so ties keep the smaller index);
//   2. the warp's argmax with two redux.sync: min-distances are >= 0, so
//      their float bits order as unsigned ints, __reduce_max_sync gives
//      the largest, and __reduce_min_sync over the indices of the lanes
//      holding it gives the smallest index that holds it;
//   3. with W > 1, each warp's (bits, index) into its slot in shared
//      memory, double-buffered by step parity, one named barrier for the
//      cloud's warps (bar.sync 1 + cloud, 32 W), and every thread reduces
//      the W slots by (bits descending, index ascending);
//   4. the winner's coordinates from the cloud, staged in shared memory as
//      float4 at the start: one broadcast 16-byte load, no global load on
//      the step's critical path.
// Points past N hold min-distance 0 at an index above every real point,
// so they never win.
#include "fps.cuh"

namespace {

constexpr int kK2Threads = 128;  // 4 warps a block

__device__ __forceinline__ void cloud_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int PPT, int W>
__global__ void __launch_bounds__(kK2Threads)
    fps_batched_kernel(const float* __restrict__ xyz, int batch, int n,
                       int npoint, int* __restrict__ out) {
  constexpr int T = 32 * W;          // threads a cloud
  constexpr int C = kK2Threads / T;  // clouds a block
  extern __shared__ float4 cloud_pts[];  // [C][n]
  // each warp's (bits, index) by cloud, step parity, warp
  __shared__ uint2 slot[C][2][W];

  const int local = threadIdx.x / T;
  const int q = threadIdx.x % T;
  const int lane = threadIdx.x & 31;
  const int warp = q >> 5;
  const int cloud = blockIdx.x * C + local;
  if (cloud >= batch) return;  // uniform over the cloud's warps
  const float* p = xyz + static_cast<size_t>(cloud) * n * 3;
  int* o = out + static_cast<size_t>(cloud) * npoint;
  float4* pts = cloud_pts + static_cast<size_t>(local) * n;

  for (int i = q; i < n; i += T)
    pts[i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 0.0f);
  if (W > 1)
    cloud_barrier(1 + local, T);
  else
    __syncwarp();

  float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = q + T * k;
    const bool ok = i < n;
    const float4 c = ok ? pts[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[k] = c.x;
    y[k] = c.y;
    z[k] = c.z;
    md[k] = ok ? 1e10f : 0.0f;  // fminf keeps a missing point at 0
  }
  if (q == 0) o[0] = 0;
  float4 c = pts[0];
  for (int t = 1; t < npoint; ++t) {
    float v[PPT];
    int kk[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      md[k] = fminf(md[k], sq_dist(x[k] - c.x, y[k] - c.y, z[k] - c.z));
      v[k] = md[k];
      kk[k] = k;
    }
#pragma unroll
    for (int s = 1; s < PPT; s *= 2) {
#pragma unroll
      for (int k = 0; k + s < PPT; k += 2 * s) {
        const bool take = v[k + s] > v[k];  // ties keep the smaller k
        v[k] = take ? v[k + s] : v[k];
        kk[k] = take ? kk[k + s] : kk[k];
      }
    }
    const unsigned bits = __float_as_uint(v[0]);
    const unsigned top = __reduce_max_sync(0xffffffffu, bits);
    unsigned win = __reduce_min_sync(
        0xffffffffu,
        bits == top ? static_cast<unsigned>(q + T * kk[0]) : 0xffffffffu);
    if (W > 1) {
      const int par = t & 1;
      if (lane == 0) slot[local][par][warp] = make_uint2(top, win);
      cloud_barrier(1 + local, T);
      uint2 best = slot[local][par][0];
#pragma unroll
      for (int w = 1; w < W; ++w) {
        const uint2 s = slot[local][par][w];
        if (s.x > best.x || (s.x == best.x && s.y < best.y)) best = s;
      }
      win = best.y;
    }
    c = pts[win];
    if (q == 0) o[t] = static_cast<int>(win);
  }
}

template <int PPT, int W>
cudaError_t launch_batched(const float* xyz, int batch, int n, int npoint,
                           int* out, cudaStream_t stream) {
  constexpr int C = kK2Threads / (32 * W);
  const size_t smem = sizeof(float4) * C * n;
  cudaError_t err = cudaFuncSetAttribute(
      fps_batched_kernel<PPT, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_batched_kernel<PPT, W><<<(batch + C - 1) / C, kK2Threads, smem,
                               stream>>>(xyz, batch, n, npoint, out);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_batched_w(const float* xyz, int batch, int n, int npoint,
                             int ppt, int* out, cudaStream_t stream) {
  switch (ppt) {
    case 1:
      return launch_batched<1, W>(xyz, batch, n, npoint, out, stream);
    case 2:
      return launch_batched<2, W>(xyz, batch, n, npoint, out, stream);
    case 4:
      return launch_batched<4, W>(xyz, batch, n, npoint, out, stream);
    case 8:
      return launch_batched<8, W>(xyz, batch, n, npoint, out, stream);
    case 16:
      return launch_batched<16, W>(xyz, batch, n, npoint, out, stream);
    case 32:
      return launch_batched<32, W>(xyz, batch, n, npoint, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

JMODT_API const char* jmodt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest K1 cluster the card can place, into *out (queried once by
// the wrapper).
JMODT_API int jmodt_fps_max_cluster(int* out) { return fps_max_cluster(out); }

// xyz (batch, n, 3) float32 contiguous -> out (batch, npoint) int32; one
// cluster of csize blocks per cloud, `threads` threads a block, ppt points
// a thread (jmodt_torch/ops/sampling.py::fps_launch_plan).
JMODT_API int jmodt_fps(const float* xyz, int batch, int n, int npoint,
                        int csize, int threads, int ppt, int* out,
                        cudaStream_t stream) {
  return fps_blocks(xyz, batch, n, npoint, csize, threads, ppt, out, stream);
}

// xyz (batch, n, 3) float32 contiguous -> out (batch, npoint) int32;
// `warps` warps a cloud (1, 2 or 4), 4 / warps clouds a block, ppt points
// a thread with 32 * warps * ppt >= n (jmodt_torch/ops/sampling.py::
// fps_batched_launch_plan).
JMODT_API int jmodt_fps_batched(const float* xyz, int batch, int n,
                                int npoint, int warps, int ppt, int* out,
                                cudaStream_t stream) {
  if (batch < 1 || npoint < 1 || npoint > n || 32 * warps * ppt < n)
    return cudaErrorInvalidValue;
  switch (warps) {
    case 1:
      return launch_batched_w<1>(xyz, batch, n, npoint, ppt, out, stream);
    case 2:
      return launch_batched_w<2>(xyz, batch, n, npoint, ppt, out, stream);
    case 4:
      return launch_batched_w<4>(xyz, batch, n, npoint, ppt, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
