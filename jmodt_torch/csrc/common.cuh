// Shared helpers of the port's kernels (plain C interface, loaded with
// ctypes by jmodt_torch/ops/kernels.py).
#pragma once

#include <cuda_runtime.h>

#define JMODT_API extern "C" __attribute__((visibility("default")))

// (dx*dx + dy*dy) + dz*dz with every operation rounded on its own: no
// fused multiply-add, so the result equals the plain PyTorch expression
// bit for bit and argmax / top-3 choices agree on near-ties.
__device__ __forceinline__ float sq_dist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
