// The grouped MLP of K4 (grouped_gather_mlp.cu), shared with K5's MLP
// phase (sa_level.cu):
//
//   out[b, m] = max_s relu(... relu(relu(feats1[b, idx[b, m, s]] + b1
//                                        - cxw[b, m]) W2 + b2) ... WL + bL)
//
// Replaces the MLP of jmodt_tpu/ops/pallas/grouped_gather_mlp.py::
// grouped_gather_mlp_max, which runs layers 2..L as MXU dots.
//
// What bounds it on an H100: tensor-core operations.  At the main path's
// RCNN sa_0 and sa_1 the layers are 74 GFLOP a frame, three TF32 products
// each, against ~42 MB that must move; the grouped intermediates never
// leave the SM.  Besides the products, the split's integer work on every
// fragment element, a barrier a weight tile and each block's re-read of
// the weights from L2 take time the design has not removed (PERF.md).
//
// Design: one block of 256 threads (8 warps) owns 64 rows (64 / S centres
// x S samples).  Layer 1 is gathered into shared memory, channel-major (row
// fastest, stride 72, so the fragment loads below hit 32 distinct banks),
// zero-padded to a multiple of 8 channels.  Layers 2..L run on the tensor
// cores as mma.sync m16n8k8 TF32 products at float32 accuracy ("3xTF32"):
// each operand x is split into hi = x rounded to TF32 and lo = x - hi, and
// each product is a_lo w_hi + a_hi w_lo + a_hi w_hi, small terms first,
// accumulated in float32 (a_lo w_lo is below float32's rounding).  A pass
// computes 64 rows x 128 columns, each warp 32 x 32 (2 x 4 tiles of
// 16 x 8); the activations are split in registers as their fragments are
// loaded from shared memory, and the weights stream through a double-
// buffered ring of 32 x 128 shared-memory tiles filled by cp.async (the
// next tile in flight while one is used; deeper rings of shallower tiles,
// with a barrier a tile, measured slower) and are split in registers too,
// so neither operand needs a hi/lo copy in shared memory.  A 16 x 8 tile
// wholly past a layer's width is skipped.  The output goes to the other
// activation buffer; the last layer folds the max over the S rows of a
// centre in registers and warp shuffles, then into shared memory with an
// integer atomicMax (post-ReLU values are >= 0, whose bit patterns order as
// integers), so no grouped tensor is written to device memory.  Output row
// (b, m) starts at out + (b * M + m) * out_stride, so K5 writes each scale
// into its columns of one pooled tensor.  Where M gives fewer blocks than
// one wave, the grid's z dimension splits the last layer's column passes
// over blocks that each recompute the layers before (the wrapper's plan).
// Widths 2..L must be multiples of 4 and the weights 16-byte aligned
// (16-byte cp.async).  The block's work is `grouped_mlp_block`, a device
// function of the block's coordinates, so K5 runs the same code for the
// MLP units of its one consumer grid; there the table, the neighbour lists
// and cxw are written while the grid runs and are read through L2
// (ld.global.cg), not through the read-only path K4 uses.
#pragma once

// Internal linkage (an anonymous namespace): every source that includes
// this header gets its own copy, and no kernel symbol is exported twice.

#include "common.cuh"

namespace {

constexpr int kRows = 64;         // rows (centres x samples) per block
constexpr int kRS = kRows + 8;    // row stride of the activation buffers
constexpr int kPassN = 128;       // output columns per pass
constexpr int kTileK = 32;        // reduction depth of one weight tile
constexpr int kStages = 2;        // weight tiles in the ring
constexpr int kWS = kPassN + 8;   // row stride of a weight tile
constexpr int kThreads = 256;     // 8 warps: 2 x 4 warp tiles of 32 x 32
constexpr int kMaxLayers = 4;

struct Layers {
  const float* w[kMaxLayers];   // (Cin, Cout) row-major
  const float* b[kMaxLayers];   // (Cout,)
  int dim[kMaxLayers + 1];      // C1, then each layer's Cout
};

__device__ __forceinline__ int pad8(int c) { return (c + 7) & ~7; }

// x = hi + lo for the tensor cores (CUTLASS's "fast float32" split): hi is
// x rounded to TF32 on its bits (to nearest, ties away from zero), lo =
// x - hi exactly; the tensor core reads only lo's top 19 bits.  Integer and
// one float op, no cvt: the split runs for every fragment element.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b for a 16 x 8 (row) A fragment and an 8 x 8 (col) B fragment
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when !ok (then src is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// until at most `kPending` of the latest groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows k0..k0+31, columns n0..n0+127 of w (cin, cout) into a weight tile,
// zeros outside w; 4 cp.async of 16 bytes a thread.
__device__ __forceinline__ void load_weight_tile(float* dst,
                                                 const float* __restrict__ w,
                                                 int cin, int cout, int k0,
                                                 int n0, int tid) {
  constexpr int kChunks = kPassN / 4;  // 16-byte chunks a tile row
#pragma unroll
  for (int j = 0; j < kTileK * kChunks / kThreads; ++j) {
    const int e = tid + j * kThreads;
    const int kk = e / kChunks, c4 = (e % kChunks) * 4;
    const int k = k0 + kk, c = n0 + c4;
    const bool ok = k < cin && c < cout;
    cp_async16(dst + kk * kWS + c4,
               ok ? w + static_cast<size_t>(k) * cout + c : w, ok);
  }
}

// The columns of layer l a block computes: all of them, but of the last
// layer only its share of the 128-column passes when the grid splits them
// over nz blocks (each of which computes layers 2..L-1 in full).
struct Columns {
  int last, begin_last, end_last;

  // block zi of the nz that share the last layer
  __device__ __forceinline__ Columns(const Layers& L, int n_rest, int zi,
                                     int nz) {
    last = n_rest - 1;
    const int cout = L.dim[n_rest];
    const int passes = (cout + kPassN - 1) / kPassN;
    const int share = (passes + nz - 1) / nz;
    begin_last = zi * share * kPassN;
    end_last = min(cout, begin_last + share * kPassN);
  }
  __device__ __forceinline__ int begin(int l) const {
    return l == last ? begin_last : 0;
  }
  __device__ __forceinline__ int end(int l, const Layers& L) const {
    return l == last ? end_last : L.dim[l + 1];
  }
};

// The weight tiles in the order the kernel uses them (layer, column pass,
// depth); `load` puts the next one into the ring's next slot and commits a
// cp.async group, an empty one past the last tile, so that the groups in
// flight are counted alike at every tile.
struct WeightCursor {
  int l, n0, k0 = 0, slot = 0;

  __device__ __forceinline__ explicit WeightCursor(const Columns& cols)
      : l(0), n0(cols.begin(0)) {}

  __device__ __forceinline__ void load(float* ring, const Layers& L,
                                       const Columns& cols, int n_rest,
                                       int tid) {
    if (l < n_rest) {
      load_weight_tile(ring + slot * kTileK * kWS, L.w[l], L.dim[l],
                       L.dim[l + 1], k0, n0, tid);
      k0 += kTileK;
      if (k0 >= pad8(L.dim[l])) {
        k0 = 0;
        n0 += kPassN;
        if (n0 >= cols.end(l, L)) {
          ++l;
          n0 = l < n_rest ? cols.begin(l) : 0;
        }
      }
    }
    cp_async_commit();
    slot = (slot + 1) % kStages;
  }
};

// A load of data the grid itself may have written (kCoherent: through L2)
// or of data that is read-only while it runs.
template <bool kCoherent, typename T>
__device__ __forceinline__ T load_in(const T* p) {
  return kCoherent ? __ldcg(p) : __ldg(p);
}

// The rows of centres [mblk * tm, (mblk + 1) * tm) of cloud b, tm = 64 / s,
// through every layer, for the last layer's columns of block zi of nz;
// smem as the kernel's dynamic shared memory.
template <bool kCoherent>
__device__ __forceinline__ void grouped_mlp_block(
    float* smem, const float* feats1, const int* idx, const float* cxw,
    const float* __restrict__ b1, int n, int m, int s, int n_rest,
    const Layers& L, float* __restrict__ out, int out_stride, int mblk,
    int b, int zi, int nz) {
  int even = 0, odd = 0;  // widest padded layer input at even / odd depth
  for (int l = 0; l < n_rest; ++l) {
    if (l % 2 == 0) even = max(even, pad8(L.dim[l]));
    else odd = max(odd, pad8(L.dim[l]));
  }
  float* buf_a = smem;
  float* buf_b = buf_a + kRS * even;
  float* ring = buf_b + kRS * odd;  // kStages weight tiles
  int* otile = reinterpret_cast<int*>(ring + kStages * kTileK * kWS);

  const int c1 = L.dim[0], c1p = pad8(c1);
  const int tm = kRows / s;  // centres per block
  const int m0 = mblk * tm;
  const int tid = threadIdx.x;

  // the first kStages - 1 weight tiles are in flight while layer 1 is
  // gathered
  const Columns cols(L, n_rest, zi, nz);
  WeightCursor next(cols);
  for (int i = 0; i < kStages - 1; ++i)
    next.load(ring, L, cols, n_rest, tid);

  // layer 1: gather, + b1 - cxw, ReLU.  A warp reads 8 consecutive
  // channels of 4 gathered rows and stores them 2 lanes a bank.
  {
    const int cl = tid & 7;
    for (int half = 0; half < 2; ++half) {
      const int r = (tid >> 3) + 32 * half;
      const int mm = m0 + r / s;
      const bool live = mm < m;
      const size_t centre = static_cast<size_t>(b) * m + (live ? mm : 0);
      const int row =
          live ? load_in<kCoherent>(idx + centre * s + r % s) : 0;
      const float* src = feats1 + (static_cast<size_t>(b) * n + row) * c1;
      const float* cx = cxw + centre * c1;
      for (int c = cl; c < c1p; c += 8) {
        float v = 0.0f;
        if (live && c < c1)
          v = fmaxf(__fsub_rn(__fadd_rn(load_in<kCoherent>(src + c), b1[c]),
                              load_in<kCoherent>(cx + c)),
                    0.0f);
        buf_a[c * kRS + r] = v;
      }
    }
  }
  for (int e = tid; e < tm * kPassN; e += kThreads) otile[e] = 0;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row group, column
  const int wr = (warp >> 2) * 32;        // the warp's rows
  const int wc = (warp & 3) * 32;         // and columns of a pass
  float* hin = buf_a;
  float* hout = buf_b;
  int stage = 0;
  for (int l = 0; l < n_rest; ++l) {
    const int cin = pad8(L.dim[l]), cout = L.dim[l + 1];
    const float* __restrict__ bias = L.b[l];
    const bool last = l == n_rest - 1;
    for (int n0 = cols.begin(l); n0 < cols.end(l, L); n0 += kPassN) {
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      for (int k0 = 0; k0 < cin; k0 += kTileK) {
        // this tile has landed, every thread is done with the slot the
        // last one used, and the activations written before are visible
        cp_async_wait<kStages - 2>();
        __syncthreads();
        next.load(ring, L, cols, n_rest, tid);  // kStages - 1 tiles ahead
        const float* wt = ring + stage * kTileK * kWS;
        const int kmax = min(kTileK, cin - k0);
        for (int kk = 0; kk < kmax; kk += 8) {
          unsigned ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* ap = hin + (k0 + kk + q) * kRS + wr + 16 * i + g;
            split_tf32(ap[0], ah[i][0], al[i][0]);             // (g, q)
            split_tf32(ap[8], ah[i][1], al[i][1]);             // (g+8, q)
            split_tf32(ap[4 * kRS], ah[i][2], al[i][2]);       // (g, q+4)
            split_tf32(ap[4 * kRS + 8], ah[i][3], al[i][3]);   // (g+8, q+4)
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (n0 + wc + 8 * j >= cout) continue;  // warp-uniform
            const float* bp = wt + (kk + q) * kWS + wc + 8 * j + g;
            unsigned bh0, bl0, bh1, bl1;
            split_tf32(bp[0], bh0, bl0);         // (k = q, n = g)
            split_tf32(bp[4 * kWS], bh1, bl1);   // (k = q+4, n = g)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_tf32(acc[i][j], al[i], bh0, bh1);
              mma_tf32(acc[i][j], ah[i], bl0, bl1);
              mma_tf32(acc[i][j], ah[i], bh0, bh1);
            }
          }
        }
        stage = (stage + 1) % kStages;
      }

      // acc[i][j]: rows wr + 16i + {g, g+8}, columns wc + 8j + 2q + {0, 1}
      if (!last) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c0 = n0 + wc + 8 * j;
          if (c0 >= cout) continue;  // columns to pad8(cout) are written
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + 2 * q + e;
            const float bj = c < cout ? bias[c] : 0.0f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float* h = hout + c * kRS + wr + 16 * i + g;
              h[0] = fmaxf(acc[i][j][e] + bj, 0.0f);
              h[8] = fmaxf(acc[i][j][2 + e] + bj, 0.0f);
            }
          }
        }
      } else {
        // max over each centre's rows: in registers across the rows a
        // thread holds, then across the lanes' row groups g
        const bool join_h = s >= 16;   // rows g and g+8: one centre
        const bool join_i = s >= 32;   // both 16-row tiles: one centre
        const int gmask = s >= 8 ? 7 : 3;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl0 = wc + 8 * j;
          if (n0 + cl0 >= cout) continue;  // warp-uniform
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = cl0 + 2 * q + e;
            const int c = n0 + cl;
            const float bj = c < cout ? bias[c] : 0.0f;
            float v[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                v[i][h] = fmaxf(acc[i][j][2 * h + e] + bj, 0.0f);
            if (join_h) {
              v[0][0] = fmaxf(v[0][0], v[0][1]);
              v[1][0] = fmaxf(v[1][0], v[1][1]);
            }
            if (join_i) v[0][0] = fmaxf(v[0][0], v[1][0]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if ((i > 0 && join_i) || (h > 0 && join_h)) continue;
                float x = v[i][h];
                x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
                x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
                if (s >= 8) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
                if ((g & gmask) == 0) {
                  const int t = (wr + 16 * i + 8 * h + g) / s;
                  atomicMax(&otile[t * kPassN + cl], __float_as_int(x));
                }
              }
          }
        }
        __syncthreads();
        for (int e = tid; e < tm * kPassN; e += kThreads) {
          const int mm = m0 + e / kPassN, c = n0 + e % kPassN;
          const int v = otile[e];
          otile[e] = 0;  // ready for the next column pass
          if (mm < m && c < cout)
            out[(static_cast<size_t>(b) * m + mm) * out_stride + c] =
                __int_as_float(v);
        }
      }
    }
    float* const done = hin;
    hin = hout;
    hout = done;
  }
}

// K4: one block per (64-row tile, cloud, column share)
__global__ void __launch_bounds__(kThreads)
    grouped_gather_mlp_max_kernel(const float* __restrict__ feats1,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ cxw,
                                  const float* __restrict__ b1, int n, int m,
                                  int s, int n_rest, Layers L,
                                  float* __restrict__ out, int out_stride) {
  extern __shared__ __align__(16) float smem[];
  grouped_mlp_block<false>(smem, feats1, idx, cxw, b1, n, m, s, n_rest, L,
                           out, out_stride, blockIdx.x, blockIdx.y,
                           blockIdx.z, gridDim.z);
}

}  // namespace
