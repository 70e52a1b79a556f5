// Farthest point sampling of whole clouds, one 1024-thread block per
// cloud: K1's code, shared by fps.cu (K1) and sa_level.cu (K5's FPS
// phase), so both give the same indices.
//
// Semantics: idx[0] = 0, the running min-distance starts at 1e10, and each
// step takes the argmax of the min-distance with ties to the smaller index.
// The coordinates live in shared memory (12 bytes a point, 192 KB at
// N = 16384) and each thread's min-distances in registers; a step is one
// pass, a warp-shuffle argmax, and one exchange through shared memory (two
// barriers).
#pragma once

// Internal linkage (an anonymous namespace): every source that includes
// this header gets its own copy, and no kernel symbol is exported twice.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kFpsBlock = 1024;

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
__global__ void __launch_bounds__(kFpsBlock)
    fps_block_kernel(const float* __restrict__ xyz, int n, int npoint,
                     int* __restrict__ out) {
  extern __shared__ float coords[];  // x[n], y[n], z[n]
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;
  float* sx = coords;
  float* sy = coords + n;
  float* sz = coords + 2 * n;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < n; i += blockDim.x) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  float md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) md[k] = 1e10f;
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int t = 1; t < npoint; ++t) {
    const float px = sx[last], py = sy[last], pz = sz[last];
    float bv = -1.0f;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * blockDim.x;
      if (i < n) {
        md[k] = fminf(md[k], sq_dist(sx[i] - px, sy[i] - py, sz[i] - pz));
        if (md[k] > bv) {  // ascending i: the first maximum stays
          bv = md[k];
          bi = i;
        }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -1.0f;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_last = bi;
        o[t] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

template <int PPT>
cudaError_t launch_fps_block(const float* xyz, int batch, int n, int npoint,
                             int* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(12) * n;
  const cudaError_t err = cudaFuncSetAttribute(
      fps_block_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = PPT == 1 ? ((n + 31) / 32) * 32 : kFpsBlock;
  fps_block_kernel<PPT><<<batch, threads, smem, stream>>>(xyz, n, npoint,
                                                          out);
  return cudaGetLastError();
}

// xyz (batch, n, 3) float32 contiguous -> out (batch, npoint) int32; one
// block per cloud.  n <= 232448 / 12 (coordinates in shared memory).
inline cudaError_t fps_blocks(const float* xyz, int batch, int n,
                              int npoint, int* out, cudaStream_t stream) {
  const int ppt = (n + kFpsBlock - 1) / kFpsBlock;
  if (ppt <= 1) return launch_fps_block<1>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 2) return launch_fps_block<2>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 4) return launch_fps_block<4>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 8) return launch_fps_block<8>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 16)
    return launch_fps_block<16>(xyz, batch, n, npoint, out, stream);
  if (ppt <= 32)
    return launch_fps_block<32>(xyz, batch, n, npoint, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
