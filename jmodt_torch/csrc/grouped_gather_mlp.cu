// K4: grouped gather + pointwise MLP + max over the samples of each centre.
//
// Replaces jmodt_tpu/ops/pallas/grouped_gather_mlp.py::grouped_gather_mlp_max:
//
//   out[b, m] = max_s relu(... relu(relu(feats1[b, idx[b, m, s]] + b1
//                                        - cxw[b, m]) W2 + b2) ... WL + bL)
//
// The first Dense (BN folded) was applied per point before the gather by
// the caller.  The TPU kernel's one-hot matmul gather and bf16 hi/lo split
// were workarounds for the TPU; here the gather is a direct float32 load.
//
// What bounds it on an H100: float32 operations.  At RCNN sa_0 the MLP is
// 819,200 rows x (128x128 + 128x128) multiply-adds, about 54 GFLOP, while
// the bytes that must move (feats1, idx, cxw, out) are tens of MB; the
// grouped intermediates never leave the SM.
//
// Design: the kernel lives in grouped_mlp.cuh, shared with K5's MLP phase:
// one block of 256 threads owns 64 rows (centres x samples), each layer is
// a register-tiled float32 product over shared memory, and the max over
// samples folds in shared memory, so no grouped tensor is written to
// device memory.  No tensor cores yet.
#include "grouped_mlp.cuh"

// feats1 (batch, n, C1), idx (batch, m, s) int32, cxw (batch, m, C1),
// b1 (C1,), layers 2..L as n_rest (w (Cin, Cout), b (Cout,)) with
// dims = [C1, Cout_2, ..., Cout_L] -> out (batch, m, Cout_L).  s must be a
// multiple of 4 dividing 64; smem_bytes is the dynamic shared memory the
// wrapper computed for these widths.
JMODT_API int jmodt_grouped_gather_mlp_max(
    const float* feats1, const int* idx, const float* cxw, const float* b1,
    int batch, int n, int m, int s, int n_rest, int smem_bytes,
    const float* const* w, const float* const* bias, const int* dims,
    float* out, cudaStream_t stream) {
  if (n_rest < 1 || n_rest > kMaxLayers || s < 4 || kRows % s != 0)
    return cudaErrorInvalidValue;
  Layers L = {};
  for (int l = 0; l < n_rest; ++l) {
    L.w[l] = w[l];
    L.b[l] = bias[l];
  }
  for (int l = 0; l <= n_rest; ++l) L.dim[l] = dims[l];
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_gather_mlp_max_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const int tm = kRows / s;
  const dim3 grid((m + tm - 1) / tm, batch);
  grouped_gather_mlp_max_kernel<<<grid, kThreads, smem_bytes, stream>>>(
      feats1, idx, cxw, b1, n, m, s, n_rest, L, out, dims[n_rest]);
  return cudaGetLastError();
}
