// The ball query's arithmetic and its warp scan, shared by the ball-query
// kernel (ball_query.cu) and K5's query units (sa_level.cu).
//
// For a centre q and each scale (r^2, nsample S): the first S points in
// index order with d2 < r^2, misses padded with the first hit, an empty
// ball all point 0.  d2 = (|q|^2 + |p|^2) - 2 q.p with each dot product
// and squared norm an fma chain whose steps are computed in double and
// rounded once to float: the bits of jmodt_torch/ops/grouping.py::
// pairwise_d2, so a kernel picks the same neighbours as the plain version
// even at r^2.  Every float step is an explicit __f*_rn intrinsic, so no
// contraction changes a bit.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxScales = 4;   // scales one scan ranks at once
constexpr int kScanBlocks = 4;  // 32-point blocks a warp measures at once

// float32 a * b + c as the plain version's `_fma`: the exact sum rounded
// to double, then to float.  A product of two floats is exact in double,
// so one double fma rounds as the plain version's multiply then add.
__device__ __forceinline__ float fma_d(double a, double b, float c) {
  return __double2float_rn(__fma_rn(a, b, static_cast<double>(c)));
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return fma_d(z, z, fma_d(y, y, __fmul_rn(x, x)));
}

// d2 of centre q (|q|^2 = sqq) and point p (|p|^2 = sqp); the y and z
// coordinates as doubles, converted from float32.
__device__ __forceinline__ float ball_d2(float qx, double qy, double qz,
                                         float sqq, float px, double py,
                                         double pz, float sqp) {
  const float dot = fma_d(qz, pz, fma_d(qy, py, __fmul_rn(qx, px)));
  return __fsub_rn(__fadd_rn(sqq, sqp), __fmul_rn(2.0f, dot));
}

// Per scale: r^2 in float32 (the plain version's `d2 < r * r` compares in
// float32), nsample and the output rows, (centres, S) int32.
struct BallScales {
  float r2[kMaxScales];
  int ns[kMaxScales];
  int* nbr[kMaxScales];
};

// One warp's scan of one centre: hits so far and the first hit of each
// scale, and the scales still short of S hits (all warp-uniform).
struct BallScan {
  int cnt[kMaxScales];
  int first[kMaxScales];
  int open;
};

__device__ __forceinline__ BallScan ball_scan_start(int nscales) {
  BallScan st;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) st.cnt[s] = st.first[s] = 0;
  st.open = nscales;
  return st;
}

// The hits among the kScanBlocks x 32 points from `base` (d2[u] is this
// lane's point base + 32 u + lane; points from `end` on are no hits), in
// index order: a ballot and a popcount rank each scale's hits, and each
// hit ranked below S is written to its slot of the centre's row.
__device__ __forceinline__ void ball_rank(const float (&d2)[kScanBlocks],
                                          int base, int end, int nscales,
                                          const BallScales& sc,
                                          size_t centre, BallScan& st) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kScanBlocks; ++u) {
    const int i = base + 32 * u + lane;
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      const int ns = sc.ns[s];
      if (s >= nscales || st.cnt[s] >= ns) continue;  // warp-uniform
      const bool hit = i < end && d2[u] < sc.r2[s];
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (ballot == 0u) continue;
      if (st.cnt[s] == 0) st.first[s] = base + 32 * u + __ffs(ballot) - 1;
      const int rank = st.cnt[s] + __popc(ballot & below);
      if (hit && rank < ns) sc.nbr[s][centre * ns + rank] = i;
      st.cnt[s] += __popc(ballot);
      if (st.cnt[s] >= ns) --st.open;
    }
  }
}

// Each scale's slots past its hits: the first hit, or 0 for an empty ball.
__device__ __forceinline__ void ball_pad(const BallScan& st, int nscales,
                                         const BallScales& sc,
                                         size_t centre) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s >= nscales) break;  // unrolled: st and sc stay in registers
    const int ns = sc.ns[s];
    const int have = min(st.cnt[s], ns);
    const int fill = have > 0 ? st.first[s] : 0;
    for (int slot = have + lane; slot < ns; slot += 32)
      sc.nbr[s][centre * ns + slot] = fill;
  }
}
