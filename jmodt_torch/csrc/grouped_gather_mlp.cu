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
// What bounds it on an H100: tensor-core operations.  At the main path's
// RCNN sa_0 and sa_1 the MLP is 819,200 and 204,800 rows of 128 x 128 +
// 128 x 128 and 128 x 128 + 128 x 256 multiply-adds, 74 GFLOP a frame, three
// times that as TF32 products at float32 accuracy, while the bytes that must
// move (feats1, idx, cxw, out) are about 42 MB; the grouped intermediates
// never leave the SM.
//
// Design: the kernel lives in grouped_mlp.cuh, shared with K5's MLP phase:
// one block of 256 threads owns 64 rows (centres x samples), layer 1 is
// gathered into shared memory, layers 2..L run on the tensor cores
// (mma.sync m16n8k8 TF32, each operand split into TF32 hi + lo, three
// products a multiply-add: float32 accuracy), the weights stream through a
// double-buffered cp.async ring, and the max over samples folds in
// registers, shuffles and shared memory, so no grouped tensor is written to
// device memory.
#include "grouped_mlp.cuh"

// feats1 (batch, n, C1), idx (batch, m, s) int32, cxw (batch, m, C1),
// b1 (C1,), layers 2..L as n_rest (w (Cin, Cout), b (Cout,)) with
// dims = [C1, Cout_2, ..., Cout_L] -> out (batch, m, Cout_L).  s must be a
// multiple of 4 dividing 64, Cout_2..Cout_L multiples of 4 and the weights
// 16-byte aligned; smem_bytes is the dynamic shared memory the wrapper
// computed for these widths and col_split the number of blocks that share
// the last layer's column passes (jmodt_torch/ops/fused_sa.py::
// k4_launch_plan).
JMODT_API int jmodt_grouped_gather_mlp_max(
    const float* feats1, const int* idx, const float* cxw, const float* b1,
    int batch, int n, int m, int s, int n_rest, int smem_bytes,
    int col_split, const float* const* w, const float* const* bias,
    const int* dims, float* out, cudaStream_t stream) {
  if (n_rest < 1 || n_rest > kMaxLayers || s < 4 || kRows % s != 0 ||
      col_split < 1 || col_split > (dims[n_rest] + kPassN - 1) / kPassN)
    return cudaErrorInvalidValue;
  Layers L = {};
  for (int l = 0; l < n_rest; ++l) {
    if (dims[l + 1] % 4 != 0 || reinterpret_cast<size_t>(w[l]) % 16 != 0)
      return cudaErrorInvalidValue;
    L.w[l] = w[l];
    L.b[l] = bias[l];
  }
  for (int l = 0; l <= n_rest; ++l) L.dim[l] = dims[l];
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_gather_mlp_max_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const int tm = kRows / s;
  const dim3 grid((m + tm - 1) / tm, batch, col_split);
  grouped_gather_mlp_max_kernel<<<grid, kThreads, smem_bytes, stream>>>(
      feats1, idx, cxw, b1, n, m, s, n_rest, L, out, dims[n_rest]);
  return cudaGetLastError();
}
