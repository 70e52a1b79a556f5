// N1: greedy BEV NMS of P independent problems, with no host feedback.
//
// Replaces the device loop of jmodt_tpu/ops/nms.py::nms_bev (its
// jax.lax.while_loop of blocked rounds, run under jax.vmap by the proposal
// layer and the detection step); it has no Pallas kernel.  The result is
// one-at-a-time greedy NMS, which the JAX blocked rounds equal: in
// descending score order (lower index first on ties), a live candidate is
// kept unless an earlier kept box overlaps it with IoU > thresh, until
// max_keep are kept.
//
// The wrapper (jmodt_torch/ops/nms.py) sorts each problem's scores on the
// device (dead candidates carry -inf and sort last), gathers the boxes in
// that order with their angle's cos and sin (computed by torch.cos /
// torch.sin, the values the plain version uses), and launches the two
// grids below through jmodt_nms:
//
//   (a) mask: a grid over (column tile, row tile, problem) of 64 x 64
//       boxes, a thread a pair at a time (512 threads a tile, a ballot a
//       row's 32 columns); bit t of word (i, c) is IoU(box_i, box_(64c +
//       t)) > thresh for sorted positions i < 64c + t.  The earlier box is always the
//       first argument, the orientation of the plain version's
//       iou(boxes[cand], boxes): the rotated overlap is not symmetric in
//       its rounding.  Tiles left of the diagonal are never read and are
//       not computed; a tile whose first row (or column) is dead is skipped.
//   (b) scan: one warp a problem holds the "removed" bits of all N sorted
//       positions in registers (word w in lane w % 32), dead positions set
//       (the live candidates are a prefix of the order: a binary search).
//       It repeatedly takes the first position not removed (a warp min over
//       the lanes' first zero bits), keeps it, and ORs its mask row into
//       the removed bits, until max_keep are kept or none is left.  Only
//       kept rows are read.
//
// The IoU is the plain version's (jmodt_torch/ops/rotated_iou.py::
// boxes_iou_bev / boxes_iou_normal) operation for operation, and this file
// is built with -fmad=false, so each product and sum rounds on its own as
// in PyTorch's elementwise kernels; min / max are fminf / fmaxf with the
// operands in PyTorch's order, divisions are IEEE, and the four edge
// terms of the shoelace sum add as PyTorch's CUDA reduction adds a
// contiguous last dim of 4: (e0 + e2) + (e1 + e3) (found on the card: each
// other order differs from `.sum(-1)` on some pairs).  One flipped
// comparison at a threshold changes a keep list, so jmodt_nms_iou exposes
// the pair IoU for chip_smoke.py to hold bit-equal to the plain version's.
//
// What bounds it on an H100: the pair IoUs (operations) in (a), about N^2/2
// pairs of about 20 (axis-aligned) to 640 (rotated) float32 operations a
// problem; the mask is N^2/8 bytes a problem (40 MB for the finetune's 8
// frames of 6300 candidates), written once and read only at kept rows.
// (b) is a chain of dependent rounds, one a kept box: latency-bound.
#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 64;              // boxes a tile = bits a mask word
constexpr int kRowStep = 8;            // mask grid: rows a tile at once
constexpr int kLaneWords = 16;         // scan: N <= 32 * 16 * 64
constexpr int kBoxFloats = 6;          // x1, y1, x2, y2, cos, sin
constexpr float kEps = 1e-8f;          // rotated_iou.EPS
constexpr float kTol = 1e-5f;          // rotated_iou._TOL

struct Box {
  float x1, y1, x2, y2, c, s;
};

__device__ __forceinline__ Box load_box(const float* b) {
  return Box{b[0], b[1], b[2], b[3], b[4], b[5]};
}

// One plane of the branchless Liang-Barsky clip (_edge_clip_shoelace_about's
// loop body): d0, d1 the plane's signed distances at the edge's ends.
__device__ __forceinline__ void clip_plane(float d0, float d1, float& t0,
                                           float& t1) {
  const float denom = d0 - d1;
  const float safe = fabsf(denom) > kEps ? denom : 1.0f;
  const float t = d0 / safe;
  if (d0 > 0.0f && d1 <= 0.0f) t0 = fmaxf(t0, t);      // entering
  if (d0 <= 0.0f && d1 > 0.0f) t1 = fminf(t1, t);      // leaving
  if (d0 > 0.0f && d1 > 0.0f) t1 = -1.0f;              // outside
}

// _edge_clip_shoelace_about: the shoelace terms of the 4 directed edges
// (px[k], py[k]) -> (px[k+1], py[k+1]) clipped to the rect of axes
// u = (c, -s), v = (s, c), half extents (hu, hv), centred at (ox, oy),
// summed in the order of PyTorch's CUDA `.sum(-1)` over 4.
__device__ float clip_shoelace(const float px[4], const float py[4], float c,
                               float s, float hu, float hv, float ox,
                               float oy) {
  const float ns = -s;
  float e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = (k + 1) & 3;
    const float rpx = px[k] - ox, rpy = py[k] - oy;
    const float rqx = px[n] - ox, rqy = py[n] - oy;
    const float pu = rpx * c + rpy * ns;
    const float pv = rpx * s + rpy * c;
    const float qu = rqx * c + rqy * ns;
    const float qv = rqx * s + rqy * c;
    float t0 = 0.0f, t1 = 1.0f;
    clip_plane(pu - hu, qu - hu, t0, t1);
    clip_plane(-pu - hu, -qu - hu, t0, t1);
    clip_plane(pv - hv, qv - hv, t0, t1);
    clip_plane(-pv - hv, -qv - hv, t0, t1);
    const float dx = px[n] - px[k], dy = py[n] - py[k];
    const float ax = px[k] + t0 * dx, ay = py[k] + t0 * dy;
    const float bx = px[k] + t1 * dx, by = py[k] + t1 * dy;
    const float shoe = ax * by - bx * ay;
    e[k] = t1 > t0 ? shoe : 0.0f;
  }
  return (e[0] + e[2]) + (e[1] + e[3]);
}

// _box_corners: (x1,y1), (x2,y1), (x2,y2), (x1,y2) rotated about the centre
__device__ __forceinline__ void corners(const Box& b, float cx, float cy,
                                        float x[4], float y[4]) {
  const float xs[4] = {b.x1, b.x2, b.x2, b.x1};
  const float ys[4] = {b.y1, b.y1, b.y2, b.y2};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = xs[k] - cx, dy = ys[k] - cy;
    x[k] = (dx * b.c + dy * b.s) + cx;
    y[k] = (-dx * b.s + dy * b.c) + cy;
  }
}

__device__ __forceinline__ float area(const Box& b) {
  return (b.x2 - b.x1) * (b.y2 - b.y1);
}

// box_overlap_bev(a, b) and boxes_iou_bev's division
__device__ float iou_rotated(const Box& a, const Box& b) {
  const float acx = (a.x1 + a.x2) * 0.5f, acy = (a.y1 + a.y2) * 0.5f;
  const float bcx = (b.x1 + b.x2) * 0.5f, bcy = (b.y1 + b.y2) * 0.5f;
  float ax[4], ay[4], bx[4], by[4];
  corners(a, acx, acy, ax, ay);
  corners(b, bcx, bcy, bx, by);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] = ax[k] - bcx;
    ay[k] = ay[k] - bcy;
    bx[k] = bx[k] - bcx;
    by[k] = by[k] - bcy;
  }
  const float sum_a = clip_shoelace(
      ax, ay, b.c, b.s, (b.x2 - b.x1) * 0.5f + kTol,
      (b.y2 - b.y1) * 0.5f + kTol, 0.0f, 0.0f);
  const float sum_b = clip_shoelace(
      bx, by, a.c, a.s, (a.x2 - a.x1) * 0.5f - kTol,
      (a.y2 - a.y1) * 0.5f - kTol, acx - bcx, acy - bcy);
  const float sa = area(a), sb = area(b);
  const float inter = fabsf(sum_a + sum_b) * 0.5f;
  const float overlap = fminf(inter, fabsf(fminf(sa, sb)));
  return overlap / fmaxf((sa + sb) - overlap, kEps);
}

// boxes_iou_normal(a, b)
__device__ float iou_normal(const Box& a, const Box& b) {
  const float left = fmaxf(a.x1, b.x1), right = fminf(a.x2, b.x2);
  const float top = fmaxf(a.y1, b.y1), bottom = fminf(a.y2, b.y2);
  const float inter =
      fmaxf(right - left, 0.0f) * fmaxf(bottom - top, 0.0f);
  return inter / fmaxf((area(a) + area(b)) - inter, kEps);
}

template <bool Rotated>
__device__ __forceinline__ float iou(const Box& a, const Box& b) {
  return Rotated ? iou_rotated(a, b) : iou_normal(a, b);
}

__device__ __forceinline__ bool live(float v) { return v > -INFINITY; }

// (a): block (column tile, row tile, problem); thread (x, y) takes column
// x of the tile against rows y, y + kRowStep, ...; a warp's 32 columns of
// one row become one half of the row's 64-bit word by a ballot.
template <bool Rotated>
__global__ void __launch_bounds__(kTile * kRowStep)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ vals, int n, int words,
                    float thresh, unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;                   // the scan reads no word left of
                                         // a row's own
  const int64_t base = static_cast<int64_t>(blockIdx.z) * n;
  const int row0 = rb * kTile, col0 = cb * kTile;
  if (!live(vals[base + row0])) return;  // dead rows are never kept
  const bool cols_live = live(vals[base + col0]);   // else all 0 bits
  __shared__ Box rows[kTile];
  const int x = threadIdx.x, tid = threadIdx.y * kTile + x;
  if (tid < kTile && row0 + tid < n)
    rows[tid] = load_box(boxes + (base + row0 + tid) * kBoxFloats);
  __syncthreads();
  const int j = col0 + x;
  const Box b = j < n && cols_live ? load_box(boxes + (base + j) * kBoxFloats)
                                   : Box{};
  unsigned* half = reinterpret_cast<unsigned*>(mask);
  for (int r = threadIdx.y; r < kTile; r += kRowStep) {
    const int i = row0 + r;
    if (i >= n) break;                   // uniform across the warp
    const bool hit = cols_live && j < n && i < j &&
                     iou<Rotated>(rows[r], b) > thresh;
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    if ((x & 31) == 0)
      half[2 * ((base + i) * words + cb) + (x >> 5)] = bits;
  }
}

// (b): one warp a problem
__global__ void __launch_bounds__(32)
    nms_scan_kernel(const unsigned long long* __restrict__ mask,
                    const float* __restrict__ vals,
                    const int64_t* __restrict__ order, int n, int words,
                    int max_keep, int* __restrict__ keep_idx,
                    bool* __restrict__ keep_mask) {
  const int lane = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  const float* v = vals + base;
  const unsigned long long* m = mask + base * words;
  int* out_idx = keep_idx + static_cast<int64_t>(blockIdx.x) * max_keep;
  bool* out_mask = keep_mask + static_cast<int64_t>(blockIdx.x) * max_keep;

  // the live candidates are a prefix of the sorted order (dead ones carry
  // -inf and sort last): find its length, and set the bits past it
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (live(v[mid])) lo = mid + 1;
    else hi = mid;
  }
  unsigned long long removed[kLaneWords];
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) {
    const int first_dead = lo - (lane + 32 * k) * kTile;
    removed[k] = first_dead <= 0 ? ~0ull
                 : first_dead >= kTile ? 0ull : ~0ull << first_dead;
  }

  int count = 0;
  while (count < max_keep) {
    int first = INT_MAX;                 // this lane's first free position
#pragma unroll
    for (int k = kLaneWords - 1; k >= 0; --k) {
      const int w = lane + 32 * k;
      if (w < words && removed[k] != ~0ull)
        first = w * kTile + __ffsll(static_cast<long long>(~removed[k])) - 1;
    }
    const int i = __reduce_min_sync(0xffffffffu, first);
    if (i == INT_MAX) break;
    if (lane == 0) {
      out_idx[count] = static_cast<int>(order[base + i]);
      out_mask[count] = true;
    }
    ++count;
    const int wi = i / kTile;
    const unsigned long long* row = m + static_cast<int64_t>(i) * words;
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k) {
      const int w = lane + 32 * k;
      if (w < words && w >= wi) {
        removed[k] |= row[w];
        if (w == wi) removed[k] |= 1ull << (i - wi * kTile);
      }
    }
  }
  for (int s = count + lane; s < max_keep; s += 32) {
    out_idx[s] = 0;
    out_mask[s] = false;
  }
}

__global__ void nms_iou_kernel(const float* __restrict__ a,
                               const float* __restrict__ b, int m,
                               int rotated, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m) return;
  const Box ba = load_box(a + static_cast<int64_t>(k) * kBoxFloats);
  const Box bb = load_box(b + static_cast<int64_t>(k) * kBoxFloats);
  out[k] = rotated ? iou<true>(ba, bb) : iou<false>(ba, bb);
}

}  // namespace

// boxes (p, n, 6) [x1, y1, x2, y2, cos, sin] and vals (p, n) in descending
// order of their problem's stable sort, order (p, n) int64 the sort's
// indices; mask (p, n, ceil(n / 64)) uint64 scratch -> keep_idx (p,
// max_keep) int32 original indices in keep order, keep_mask (p, max_keep)
// bool; slots past the kept boxes are (0, false).
JMODT_API int jmodt_nms(const float* boxes, const float* vals,
                        const int64_t* order, int p, int n, int max_keep,
                        float thresh, int rotated, unsigned long long* mask,
                        int* keep_idx, bool* keep_mask, cudaStream_t stream) {
  const int words = (n + kTile - 1) / kTile;
  if (p < 0 || n < 0 || max_keep < 0 || words > 32 * kLaneWords || p > 65535)
    return cudaErrorInvalidValue;
  if (p == 0 || max_keep == 0) return cudaSuccess;
  if (n > 0) {
    const dim3 grid(words, words, p), block(kTile, kRowStep);
    if (rotated)
      nms_mask_kernel<true><<<grid, block, 0, stream>>>(boxes, vals, n, words,
                                                        thresh, mask);
    else
      nms_mask_kernel<false><<<grid, block, 0, stream>>>(boxes, vals, n,
                                                         words, thresh, mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  nms_scan_kernel<<<p, 32, 0, stream>>>(mask, vals, order, n, words, max_keep,
                                        keep_idx, keep_mask);
  return cudaGetLastError();
}

// The debug entry: out[k] = IoU(a[k], b[k]) for m pairs of boxes in the
// (m, 6) layout above, as the mask grid computes it.
JMODT_API int jmodt_nms_iou(const float* a, const float* b, int m,
                            int rotated, float* out, cudaStream_t stream) {
  if (m < 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  nms_iou_kernel<<<(m + 255) / 256, 256, 0, stream>>>(a, b, m, rotated, out);
  return cudaGetLastError();
}
