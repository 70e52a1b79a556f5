// The grouped MLP of K4 (grouped_gather_mlp.cu), shared with K5's MLP
// phase (sa_level.cu):
//
//   out[b, m] = max_s relu(... relu(relu(feats1[b, idx[b, m, s]] + b1
//                                        - cxw[b, m]) W2 + b2) ... WL + bL)
//
// One block of 256 threads owns 64 rows (64 / S centres x S samples).
// Layer 1 is gathered into shared memory, channel-major (row fastest,
// stride 68).  Each further layer is a 64 x 64-column register-tiled
// product: every thread accumulates a 4 x 4 tile in float32 FMAs, the
// weights stream through a 32 x 64 shared-memory tile, and the output goes
// to the other activation buffer.  The last layer folds the max over the S
// rows of a centre into shared memory with an integer atomicMax (post-ReLU
// values are >= 0, whose bit patterns order as integers), so no grouped
// tensor is written to device memory.  Output row (b, m) starts at
// out + (b * M + m) * out_stride, so K5 writes each scale into its columns
// of one pooled tensor.
#pragma once

// Internal linkage (an anonymous namespace): every source that includes
// this header gets its own copy, and no kernel symbol is exported twice.

#include "common.cuh"

namespace {

constexpr int kRows = 64;        // rows (centres x samples) per block
constexpr int kRS = kRows + 4;   // row stride of the activation buffers
constexpr int kTileN = 64;       // output columns per pass
constexpr int kTileK = 32;       // reduction depth of one weight tile
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxLayers = 4;

struct Layers {
  const float* w[kMaxLayers];   // (Cin, Cout) row-major
  const float* b[kMaxLayers];   // (Cout,)
  int dim[kMaxLayers + 1];      // C1, then each layer's Cout
};

__global__ void __launch_bounds__(kThreads)
    grouped_gather_mlp_max_kernel(const float* __restrict__ feats1,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ cxw,
                                  const float* __restrict__ b1, int n, int m,
                                  int s, int n_rest, Layers L,
                                  float* __restrict__ out, int out_stride) {
  extern __shared__ float smem[];
  int even = 0, odd = 0;  // widest layer input at even / odd depth
  for (int l = 0; l < n_rest; ++l) {
    if (l % 2 == 0) even = max(even, L.dim[l]);
    else odd = max(odd, L.dim[l]);
  }
  float* buf_a = smem;
  float* buf_b = buf_a + kRS * even;
  float* wtile = buf_b + kRS * odd;
  int* otile = reinterpret_cast<int*>(wtile + kTileK * kTileN);

  const int c1 = L.dim[0];
  const int tm = kRows / s;  // centres per block
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * tm;
  const int tid = threadIdx.x;

  // layer 1: gather, + b1 - cxw, ReLU; consecutive threads read
  // consecutive channels of one gathered row
  for (int e = tid; e < kRows * c1; e += kThreads) {
    const int r = e / c1, c = e % c1;
    const int mm = m0 + r / s;
    float v = 0.0f;
    if (mm < m) {
      const size_t centre = static_cast<size_t>(b) * m + mm;
      const int j = idx[centre * s + r % s];
      const float g = feats1[(static_cast<size_t>(b) * n + j) * c1 + c];
      v = fmaxf(__fsub_rn(__fadd_rn(g, b1[c]), cxw[centre * c1 + c]), 0.0f);
    }
    buf_a[c * kRS + r] = v;
  }
  for (int e = tid; e < tm * kTileN; e += kThreads) otile[e] = 0;
  __syncthreads();

  const int r0 = (tid / 16) * 4;   // this thread's 4 rows
  const int cc0 = (tid % 16) * 4;  // and 4 columns of the 64-column pass
  float* hin = buf_a;
  float* hout = buf_b;
  for (int l = 0; l < n_rest; ++l) {
    const int cin = L.dim[l], cout = L.dim[l + 1];
    const float* __restrict__ w = L.w[l];
    const float* __restrict__ bias = L.b[l];
    const bool last = l == n_rest - 1;
    for (int n0 = 0; n0 < cout; n0 += kTileN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < cin; k0 += kTileK) {
        __syncthreads();  // the previous weight tile is consumed
        for (int e = tid; e < kTileK * kTileN; e += kThreads) {
          const int k = k0 + e / kTileN, c = n0 + e % kTileN;
          wtile[e] = (k < cin && c < cout)
                         ? w[static_cast<size_t>(k) * cout + c] : 0.0f;
        }
        __syncthreads();
        const int kmax = min(kTileK, cin - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          const float4 a =
              *reinterpret_cast<const float4*>(&hin[(k0 + kk) * kRS + r0]);
          const float4 wv =
              *reinterpret_cast<const float4*>(&wtile[kk * kTileN + cc0]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], wa[j], acc[i][j]);
        }
      }
      if (!last) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + cc0 + j;
          if (c < cout) {
            const float bj = bias[c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              hout[c * kRS + r0 + i] = fmaxf(acc[i][j] + bj, 0.0f);
          }
        }
      } else {
        // rows r0..r0+3 belong to one centre (S is a multiple of 4)
        const int t = r0 / s;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + cc0 + j;
          if (c < cout) {
            const float bj = bias[c];
            float v = 0.0f;
#pragma unroll
            for (int i = 0; i < 4; ++i) v = fmaxf(v, acc[i][j] + bj);
            atomicMax(&otile[t * kTileN + cc0 + j], __float_as_int(v));
          }
        }
        __syncthreads();
        for (int e = tid; e < tm * kTileN; e += kThreads) {
          const int mm = m0 + e / kTileN, c = n0 + e % kTileN;
          const int v = otile[e];
          otile[e] = 0;  // ready for the next column pass
          if (mm < m && c < cout)
            out[(static_cast<size_t>(b) * m + mm) * out_stride + c] =
                __int_as_float(v);
        }
      }
    }
    __syncthreads();  // hout complete before it becomes the next input
    float* const done = hin;
    hin = hout;
    hout = done;
  }
}

}  // namespace
