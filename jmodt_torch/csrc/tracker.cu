// The device tracker's two loops, with no host feedback.
//
// N2 (jmodt_lap): exact max-weight assignment, Jonker-Volgenant shortest
// augmenting paths, of S independent (T, D) affinities.  Replaces the
// device loop of jmodt_tpu/tracking/device_tracker.py::_lap_assign (a
// fori_loop over detections around a while_loop scan and a while_loop
// walk-back); it has no Pallas kernel.  The arithmetic is the plain
// version's (jmodt_torch/tracking/device_tracker.py::_jonker_volgenant),
// float32 with no product, so the result is bit-equal to the CPU's:
//   gated pairs cost big = 1e4, cost = -affinity transposed (D, T);
//   per detection r: dvec = cost[r] - v; repeatedly pop the first minimum
//   of dvec over unscanned columns (scanned ones read as 1e30); a popped
//   column with no row ends the scan, else its row i relaxes
//   red = (dvec[j] + (cost[i] - v)) - (cost[i, j] - v[j]);
//   then v = (v + dvec) - dvec[jfree] on the scanned columns but the free
//   one, and the path walks back along pred to row r;
//   last, pairs at or below the threshold are dropped.
// Design: one warp a stream.  Column j (a track slot) lives in lane j % 32
// (v, dvec and the scanned flag in registers, T <= 128); the cost matrix,
// pred and the two assignment maps sit in shared memory.  The first
// minimum is a warp butterfly over (value, index) pairs that keeps the
// lower index on ties, torch.argmin's rule.  The walk-back runs on lane 0.
// What bounds it: latency.  A stream takes at most D (D + 1) / 2 dependent
// pops of a few shuffles each; the bytes (S T D floats) are a few KB.
//
// N3 (jmodt_kalman_predict): each stream's own max(steps, 1)
// constant-velocity predict steps of its T slots.  Replaces the device loop
// of jmodt_tpu/tracking/device_tracker.py::_kalman_predict (fori_loop(0,
// max(steps, 1))).  F is the identity plus ones at (0, 7), (1, 8), (2, 9),
// so the plain version's products (mean F^T, then F C F^T + Q, cuBLAS in
// float32) round only at two-term sums:
//   m_i = m_i + m_(i+7) (i < 3),  A = F C: A_ij = C_ij + C_(i+7)j (i < 3),
//   B = A F^T: B_ij = A_ij + A_i(j+7) (j < 3),  C' = B + Q,
// each with the other products exact zeros.  The sums start from +0, as a
// product accumulator does, so a zero comes out +0.  The angle wrap stays
// in the wrapper.  Design: one block a slot, one thread an element of C,
// C and A in shared memory.  What bounds it: latency (a few hundred
// additions a step); the bytes are S T 440.
#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kLaneCols = 4;           // N2: T <= 32 * 4
constexpr float kBig = 1e4f;           // N2: a gated pair's cost
constexpr float kScanned = 1e30f;      // N2: a scanned column's key
constexpr int kDimX = 10;              // N3: Kalman state size

__device__ __forceinline__ float gated(float a) {
  return isfinite(a) ? a : -kBig;
}

__global__ void __launch_bounds__(32)
    lap_kernel(const float* __restrict__ affinity, int t, int d,
               float thresh, int* __restrict__ t2d, int* __restrict__ d2t) {
  extern __shared__ float smem[];
  float* cost = smem;                                  // (d, t)
  int* pred = reinterpret_cast<int*>(cost + d * t);    // (t,)
  int* col2row = pred + t;                             // (t,)
  int* row2col = col2row + t;                          // (d,)
  const int lane = threadIdx.x;
  const float* aff = affinity + static_cast<int64_t>(blockIdx.x) * t * d;
  for (int e = lane; e < t * d; e += 32)
    cost[(e % d) * t + e / d] = -gated(aff[e]);
  for (int e = lane; e < t; e += 32) col2row[e] = -1;
  for (int e = lane; e < d; e += 32) row2col[e] = -1;
  float v[kLaneCols], dvec[kLaneCols];
  bool scanned[kLaneCols];
#pragma unroll
  for (int k = 0; k < kLaneCols; ++k) v[k] = 0.0f;
  __syncwarp();

  for (int r = 0; r < d; ++r) {
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) {
      const int j = lane + 32 * k;
      scanned[k] = false;
      if (j < t) {
        dvec[k] = cost[r * t + j] - v[k];
        pred[j] = r;
      }
    }
    __syncwarp();
    int jfree = -1;
    for (int pop = 0; pop < t && jfree < 0; ++pop) {   // t pops at most
      float best = INFINITY;
      int bj = INT_MAX;
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) {      // ascending j: the first
        const int j = lane + 32 * k;
        if (j < t) {
          const float key = scanned[k] ? kScanned : dvec[k];
          if (key < best) {
            best = key;
            bj = j;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (ob < best || (ob == best && oj < bj)) {
          best = ob;
          bj = oj;
        }
      }
      const int j = bj;
      float dj = 0.0f, vj = 0.0f;
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) {
        if (lane + 32 * k == j) {
          scanned[k] = true;
          dj = dvec[k];
          vj = v[k];
        }
      }
      const int i = col2row[j];
      if (i < 0) {
        jfree = j;
        continue;
      }
      dj = __shfl_sync(0xffffffffu, dj, j & 31);
      vj = __shfl_sync(0xffffffffu, vj, j & 31);
      const float h = cost[i * t + j] - vj;
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) {
        const int jj = lane + 32 * k;
        if (jj < t) {
          const float red = (dj + (cost[i * t + jj] - v[k])) - h;
          if (!scanned[k] && red < dvec[k]) {
            pred[jj] = i;
            dvec[k] = red;
          }
        }
      }
    }
    // dual update on the scanned columns but the free one
    float dfin = 0.0f;
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k)
      if (lane + 32 * k == jfree) dfin = dvec[k];
    dfin = __shfl_sync(0xffffffffu, dfin, jfree & 31);
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) {
      const int jj = lane + 32 * k;
      if (jj < t && scanned[k] && jj != jfree) v[k] = (v[k] + dvec[k]) - dfin;
    }
    __syncwarp();
    if (lane == 0) {                       // augment back to row r
      int j = jfree;
      for (int step = 0; step <= r; ++step) {  // r + 1 rows at most
        const int i = pred[j];
        col2row[j] = i;
        const int next = row2col[i];
        row2col[i] = j;
        j = next;
        if (i == r) break;
      }
    }
    __syncwarp();
  }
  int* out_t = t2d + static_cast<int64_t>(blockIdx.x) * t;
  int* out_d = d2t + static_cast<int64_t>(blockIdx.x) * d;
  for (int e = lane; e < t; e += 32) {
    const int c = col2row[e];
    out_t[e] = c >= 0 && gated(aff[e * d + c]) > thresh ? c : -1;
  }
  for (int e = lane; e < d; e += 32) {
    const int c = row2col[e];
    out_d[e] = c >= 0 && gated(aff[c * d + e]) > thresh ? c : -1;
  }
}

__global__ void __launch_bounds__(128)
    kalman_predict_kernel(const float* __restrict__ mean,
                          const float* __restrict__ cov,
                          const int* __restrict__ steps,
                          const float* __restrict__ q, int t,
                          float* __restrict__ mean_out,
                          float* __restrict__ cov_out) {
  __shared__ float c[kDimX * kDimX], a[kDimX * kDimX], m[kDimX];
  const int slot = blockIdx.x, e = threadIdx.x;
  const int i = e / kDimX, j = e % kDimX;
  const bool el = e < kDimX * kDimX;
  const int64_t cbase = static_cast<int64_t>(slot) * kDimX * kDimX;
  if (el) c[e] = cov[cbase + e];
  if (e < kDimX) m[e] = mean[static_cast<int64_t>(slot) * kDimX + e];
  const int n = max(steps[slot / t], 1);
  const float qe = el ? q[e] : 0.0f;
  for (int step = 0; step < n; ++step) {
    __syncthreads();
    float ae = 0.0f, me = 0.0f;
    if (el) {
      ae = __fadd_rn(0.0f, c[e]);
      if (i < 3) ae = __fadd_rn(ae, c[e + 7 * kDimX]);
    }
    if (e < kDimX) {
      me = __fadd_rn(0.0f, m[e]);
      if (e < 3) me = __fadd_rn(me, m[e + 7]);
    }
    __syncthreads();
    if (el) a[e] = ae;
    if (e < kDimX) m[e] = me;
    __syncthreads();
    if (el) {
      float be = __fadd_rn(0.0f, a[e]);
      if (j < 3) be = __fadd_rn(be, a[e + 7]);
      c[e] = __fadd_rn(be, qe);
    }
  }
  __syncthreads();
  if (el) cov_out[cbase + e] = c[e];
  if (e < kDimX) mean_out[static_cast<int64_t>(slot) * kDimX + e] = m[e];
}

}  // namespace

// affinity (s, t, d) float32 with -inf (or any non-finite value) for a
// gated pair, t >= d -> t2d (s, t), d2t (s, d) int32, -1 unmatched.
JMODT_API int jmodt_lap(const float* affinity, int s, int t, int d,
                        float thresh, int* t2d, int* d2t,
                        cudaStream_t stream) {
  if (s < 0 || d < 0 || t < d || t > 32 * kLaneCols)
    return cudaErrorInvalidValue;
  if (s == 0 || t == 0) return cudaSuccess;
  const size_t smem = (static_cast<size_t>(d) * t + 2 * t + d) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lap_kernel<<<s, 32, smem, stream>>>(affinity, t, d, thresh, t2d, d2t);
  return cudaGetLastError();
}

// mean (s, t, 10), cov (s, t, 10, 10) float32, steps (s,) int32, q (10, 10)
// -> mean_out, cov_out of the same shapes after max(steps, 1) steps.
JMODT_API int jmodt_kalman_predict(const float* mean, const float* cov,
                                   const int* steps, const float* q, int s,
                                   int t, float* mean_out, float* cov_out,
                                   cudaStream_t stream) {
  if (s < 0 || t < 0) return cudaErrorInvalidValue;
  if (s == 0 || t == 0) return cudaSuccess;
  kalman_predict_kernel<<<s * t, 128, 0, stream>>>(mean, cov, steps, q, t,
                                                   mean_out, cov_out);
  return cudaGetLastError();
}
