// K6: depth-to-space of a NonOverlapDeconv's tap-major table, with the bias.
//
// Replaces jmodt_tpu/ops/pallas/depth_to_space.py::depth_to_space_pallas:
//
//   out[b, (y*k + dy)*w0*k + x*k + dx, c]
//       = taps[b, y*w0 + x, (dy*k + dx)*r + c] (+ bias[c])
//
// taps (B, h0*w0, k*k*r) is the deconv's one matmul; out (B, h0*k*w0*k, r)
// is the full-resolution NHWC map.  The bias is added in the tensor's type
// (bf16: a float32 add rounded to bf16, as PyTorch adds two bf16 tensors).
//
// What bounds it on an H100: bytes.  It is a pure move: every table element
// is read once and written once (one frame's four pyramid levels move
// 4 x 384*1280*16 bf16 values each way, about 126 MB in all).
//
// Design: for a full-resolution row Y = y*k + dy, the k pixels x*k .. x*k+k-1
// are one contiguous run of k*r elements (64 to 512 bytes in bf16), taken
// from one contiguous run of table row y*w0 + x.  One thread moves one
// 16-byte vector of the output, so neighbouring threads read and write
// neighbouring addresses and no vector crosses a run.  A row of blocks
// covers one output row, so the per-thread index arithmetic is 32-bit.  No
// shared memory: nothing is reused.  Both pointers must be 16-byte aligned
// and k*r a multiple of the vector (8 bf16, 4 float32); every pyramid level
// (r = 16) is, and the wrapper refuses anything else.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// One 16-byte vector of Vec elements a thread; Vec divides k*r.
// blockIdx.y walks the output rows (b*h0*k + Y), blockIdx.x * kThreads +
// threadIdx.x is the vector within the row, so a thread's index arithmetic
// is 32-bit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    d2s_kernel(const T* __restrict__ taps, const T* __restrict__ bias,
               int rows, int k, int r, int w0, T* __restrict__ out) {
  constexpr int Vec = 16 / sizeof(T);
  struct alignas(16) Pack {
    T v[Vec];
  };
  const int kr = k * r;
  const int row_len = w0 * kr;                         // one output row
  const int in_row = (blockIdx.x * kThreads + threadIdx.x) * Vec;
  if (in_row >= row_len) return;
  const int x = in_row / kr;
  const int e = in_row - x * kr;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int by = row / k;                            // b*h0 + y
    const int dy = row - by * k;
    const int64_t src = (static_cast<int64_t>(by) * w0 + x) * k * kr +
                        dy * kr + e;
    Pack p = *reinterpret_cast<const Pack*>(taps + src);
    if (bias != nullptr) {
      int c = e % r;
#pragma unroll
      for (int i = 0; i < Vec; ++i) {
        from_f(to_f(p.v[i]) + to_f(bias[c]), &p.v[i]);
        if (++c == r) c = 0;
      }
    }
    *reinterpret_cast<Pack*>(out + static_cast<int64_t>(row) * row_len +
                             in_row) = p;
  }
}

template <typename T>
cudaError_t launch(const void* taps, const void* bias, int batch, int h0,
                   int w0, int k, int r, void* out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t rows = static_cast<int64_t>(batch) * h0 * k;
  const int64_t row_len = static_cast<int64_t>(w0) * k * r;
  if ((k * r) % kVec != 0 || reinterpret_cast<uintptr_t>(taps) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (rows > INT32_MAX || row_len > INT32_MAX / 2)
    return cudaErrorInvalidValue;
  const dim3 grid((row_len / kVec + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  d2s_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(taps), static_cast<const T*>(bias),
      static_cast<int>(rows), k, r, w0, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// taps (batch, h0*w0, k*k*r) contiguous, bias (r,) or null, of one type:
// dtype 0 float32, 1 bfloat16 -> out (batch, h0*k*w0*k, r) contiguous.
JMODT_API int jmodt_depth_to_space(const void* taps, const void* bias,
                                   int batch, int h0, int w0, int k, int r,
                                   int dtype, void* out,
                                   cudaStream_t stream) {
  if (k < 1 || r < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(taps, bias, batch, h0, w0, k, r, out, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(taps, bias, batch, h0, w0, k, r, out,
                                 stream);
  return cudaErrorInvalidValue;
}
