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
// Design: K1 (fps.cuh, shared with K5's FPS phase) runs one thread-block
// cluster per cloud, up to 16 blocks that each hold a slice of the cloud in
// registers and exchange one candidate a step through distributed shared
// memory, so level 0 (16384 points) is spread over 16 SMs with one block
// barrier and one cluster barrier a step.  K2 gives each small cloud
// (N <= 1024) one warp, holding coordinates and min-distances in registers,
// so a step needs no barrier at all, and spreads the clouds over the SMs
// one warp per block.
#include <climits>

#include "fps.cuh"

namespace {

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int PPT>
__global__ void fps_warp_kernel(const float* __restrict__ xyz, int batch,
                                int n, int npoint, int* __restrict__ out) {
  const int cloud = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (cloud >= batch) return;  // uniform per warp
  const float* p = xyz + static_cast<size_t>(cloud) * n * 3;
  int* o = out + static_cast<size_t>(cloud) * npoint;
  float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = lane + 32 * k;
    const bool ok = i < n;
    x[k] = ok ? p[3 * i] : 0.0f;
    y[k] = ok ? p[3 * i + 1] : 0.0f;
    z[k] = ok ? p[3 * i + 2] : 0.0f;
    md[k] = 1e10f;
  }
  if (lane == 0) o[0] = 0;
  int last = 0;
  for (int t = 1; t < npoint; ++t) {
    const float px = __ldg(p + 3 * last);
    const float py = __ldg(p + 3 * last + 1);
    const float pz = __ldg(p + 3 * last + 2);
    float bv = -1.0f;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = lane + 32 * k;
      if (i < n) {
        md[k] = fminf(md[k], sq_dist(x[k] - px, y[k] - py, z[k] - pz));
        if (md[k] > bv) {
          bv = md[k];
          bi = i;
        }
      }
    }
    warp_argmax(bv, bi);  // butterfly: every lane ends with the winner
    last = bi;
    if (lane == 0) o[t] = bi;
  }
}

template <int PPT>
cudaError_t launch_warp(const float* xyz, int batch, int n, int npoint,
                        int* out, cudaStream_t stream) {
  fps_warp_kernel<PPT><<<batch, 32, 0, stream>>>(xyz, batch, n, npoint, out);
  return cudaGetLastError();
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

// xyz (batch, n, 3) float32 contiguous -> out (batch, npoint) int32; one
// warp per cloud, n <= 1024.
JMODT_API int jmodt_fps_warp(const float* xyz, int batch, int n, int npoint,
                             int* out, cudaStream_t stream) {
  const int ppt = (n + 31) / 32;
  if (ppt <= 1) return launch_warp<1>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 2) return launch_warp<2>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 4) return launch_warp<4>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 8) return launch_warp<8>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 16) return launch_warp<16>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 32) return launch_warp<32>(xyz, batch, n, npoint, out, stream);
  return cudaErrorInvalidValue;
}
