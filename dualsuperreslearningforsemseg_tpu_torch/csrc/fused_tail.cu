// Fused train tail for Hopper (sm_90a): final ConvTranspose2d(C, C, 2, 2) +
// bias + masked cross-entropy, forward and backward, without writing the
// (B, C, 2H, 2W) logits.
//
// Replaces the Pallas TPU kernels of `convt_cols_ce_sum` in
// dualsuperreslearningforsemseg_tpu/ops/pallas/fused_tail.py: `_fwd_kernel`
// (pallas_call at line 218, in `_fwd_impl`) and `_bwd_kernel` (pallas_call
// at line 251, in `_vjp_bwd`).  The logits and CE terms come from
// tail_common.cuh, shared with the eval tail (eval_tail.cu), and so does
// the rounding rule: for a bfloat16 x the weight is rounded to bfloat16
// for every product, sums are float32 and the bias float32.
//
// Forward: (ce_sum, count) = (sum of the NLL over valid output pixels,
// number of valid output pixels), built around Hopper's asynchronous
// warpgroup products.  A persistent grid, one block an SM of 5 (float32 x)
// or 6 (bfloat16 x) warpgroups (`FwdShape`: as many as the registers
// allow), walks tiles of 64 consecutive pre-tail pixels, warpgroup i taking
// tiles i, i + all warpgroups, ...  Each warp of a warpgroup owns 16 pixels
// of its tiles: it loads their (C, 16) slab with cp.async two tiles ahead
// into a ring of two buffers, and their labels one tile ahead into
// registers (lanes l and l + 16 hold pixel l; shuffled to the lanes that
// need them).  The logits (64 x 80) = X^T . W of a tile are one chain of
// `wgmma.mma_async` (m64n80k8 TF32, 3 k steps x 3 passes for float32 x;
// m64n80k16 bfloat16, 2 k steps for bfloat16 x), A from registers (the
// warp's hi/lo or packed fragments of its slab), B from the split or
// rounded weight table in shared memory, built once a block, read through
// a matrix descriptor.  While a tile's products run the warpgroup starts
// its next loads; then each lane adds the bias to its two output pixels
// and takes their CE with the shared helpers (`row_max`, `exp_sum`,
// `picked_logit`, `ce_nll`), summed in float64, while the other
// warpgroups' products run.  (Two accumulator sets, to run the next
// tile's products under this tile's CE, need 80 accumulator registers a
// thread and leave room for 3 warpgroups: slower, PERF.md.)  Each block
// writes its CE sum and count to its own slot and a one-block pass sums
// the slots in a fixed order, so the result is the same from run to run.
//
// Backward, given `scale` = the cotangent of ce_sum as a device scalar (no
// host sync): per output pixel dlogits = (softmax - onehot) * scale * valid
// (float32),
//   dX[ci]          = sum_{pos, co} dlogits[pos, co] * W[ci, co, pos]
//   dW[ci, co, pos] = sum_pixels x[ci] * dlogits[pos, co]
//   db[co]          = sum_pixels sum_pos dlogits[pos, co]   (float32 dlogits)
// For a bfloat16 x the dX and dW products take dlogits rounded to bfloat16
// (fused_tail.py:173 there) and dX is rounded to bfloat16 at the end.
//
// Backward design: a persistent grid (the SM count times the blocks the
// occupancy allows per SM) walks tiles of 128 consecutive pre-tail pixels,
// block i taking tiles i, i + grid, ...  Each of the 8 warps owns 16 pixels
// of a tile and works on them alone: it loads their (C, 16) activation slab
// with cp.async into one of its two shared buffers while it computes on
// the other, loads their labels and offsets into registers one tile ahead,
// and runs on the tensor cores with mma.sync (3xTF32 for float32 x, one
// bfloat16 pass for bfloat16 x; see tail_common.cuh) the logits (16 x 80)
// = X^T . W, whose columns are ordered so that each lane holds whole output
// pixels: each lane adds the bias, takes the softmax once (`exp_sum` keeps
// exp(l - m)) and turns its logits into dlogits in its accumulators, and
// writes them to the warp's shared tile, from which dX (16 x 24) = dlogits
// . W^T (written to global memory in x's dtype) reads them back as pairs
// (keeping them in registers through dX spilled).  The block meets twice a
// tile, around dW^T (80 x 24) += dlogits^T .
// X^T over all 128 pixels, whose accumulators stay in registers across the
// block's tiles (15 m16n8 tiles, two per warp), and db, the float32 column
// sums of the dlogits in three fixed pixel ranges.  At the end each block
// writes its dW and db partial in float64 to its own slot and a one-block
// pass adds the slots in a fixed order: no float atomics, so two launches
// on the same inputs give bit-identical results.
//
// Layout: x is NCHW (float32 or bfloat16), contiguous, as the model gives
// it; labels are (B, 2H, 2W) uint8, read as 2-byte pairs.  A tile may cross
// image rows and samples (the loader falls back to plain loads there).  The
// TPU kernel's 128-column carry, block-diagonal (512, 128) weight and g16
// labels existed for its 128 lanes and are not carried over.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 and 989 bf16 on the
// tensor cores; 67 TFLOP/s FP32 off them) at the stage-1 recipe (x
// 8x19x256x512 float32, 4.19 M output pixels):
//   forward: reads x (79.7 MB) and the labels (4.2 MB): 25 us; the 19x19
//     products are 3.03 GFLOP, three TF32 passes at 495 TFLOP/s: 18 us (a
//     bfloat16 x: 42 MB, 13 us, one pass 3 us); the softmax and pick (~6 x
//     19 operations per output pixel) 0.48 GOP of FP32: 7 us.
//   backward: reads x and the labels, writes dX: 163.6 MB, 49 us; the three
//     19x19 products are 9.08 GFLOP, three TF32 passes at 495 TFLOP/s: 55 us
//     (one bfloat16 pass at 989: 9 us, and half the bytes); the softmax and
//     dlogits (~9 x 19 operations per output pixel) 0.72 GOP of FP32: 11 us.
// So the forward is bound by its bytes, the float32 backward by its 3xTF32
// products and the bfloat16 one by its bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_common.cuh"

namespace {

using dsrl_tail::kC;
using dsrl_tail::kN;
using dsrl_tail::kNPad;
using dsrl_tail::kThreads;
using dsrl_tail::kTileP;
using dsrl_tail::kWarpP;
using dsrl_tail::kWarps;
using dsrl_tail::from_float;
using dsrl_tail::to_float;
constexpr int kRows = kC + 1;                   // dW's channels and db
constexpr int kCols = kN;                       // (output position, class)
constexpr int kSWT = 24;                        // dX's B table row stride (words)
constexpr int kSL = 88;                         // dlogits row stride (floats): conflict-free loads
constexpr int kWarpL = kWarpP * kSL;            // a warp's dlogits
constexpr int kFinalThreads = 1024;
constexpr int kSlabElems = kC * dsrl_tail::kSlabStride;   // a warp's (C, 16) slab

// Shared memory of the backward kernel, in bytes (each part a multiple of 16).
template <typename T> struct BwdSmem {
  static constexpr int kX = kWarps * 2 * kSlabElems * (int)sizeof(T);   // two slabs a warp
  static constexpr int kL = kWarps * kWarpL * 4;              // each warp's dlogits
  static constexpr int kW = dsrl_tail::b_table_words<T>(dsrl_tail::LogitsK<T>::kPad, dsrl_tail::kSW) * 4;
  static constexpr int kWT = dsrl_tail::b_table_words<T>(kNPad, kSWT) * 4;   // W^T for dX
  static constexpr int kB = 80;                               // bias per class (20 floats)
  static constexpr int kLab = kWarps * 2 * kWarpP * 4;        // labels, two parts a warp
  static constexpr int kOff = kWarps * 2 * kWarpP * 8;        // x offsets, two parts a warp
  static constexpr int kDb = 3 * kNPad * 4;                   // db's column sums
  static constexpr int kBytes = kX + kL + kW + kWT + kB + kLab + kOff + kDb;
};

// The forward's block: one a SM, of as many warpgroups as the registers
// allow (float32 x: 5 at 96 registers a thread; bfloat16 x, whose A
// fragments take 8 registers instead of 24: 6 at 80).  While one
// warpgroup waits for its products, the others take their CE.
template <typename T> struct FwdShape {
  static constexpr int kWG = sizeof(T) == 4 ? 5 : 6;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kWarps = 4 * kWG;
};

// Shared memory of the forward kernel, in bytes: the wgmma B table first
// (its descriptors want 16-byte alignment), the bias, two slabs a warp.
template <typename T> struct FwdSmem {
  static constexpr int kW = dsrl_tail::WgTable<T>::kBytes;
  static constexpr int kB = 80;
  static constexpr int kX = FwdShape<T>::kWarps * 2 * kSlabElems * (int)sizeof(T);
  static constexpr int kBytes = kW + kB + kX;
};

// Adds the CE of this lane's output pixel of row `Half` (output position t
// of a pre-tail pixel whose four labels are `labels4`) to ce and n_valid.
// Branch-free: the CE is taken for every pixel and added where it is valid
// (adding 0.0 leaves the sum's bits as skipping would), so a lane's two
// pixels interleave.
template <int Half>
__device__ __forceinline__ void add_ce(float (&acc)[dsrl_tail::kNT][4], const float* s_b, uint32_t labels4,
                                       int t, bool active, int ignore_label, double& ce, int& n_valid) {
  const int lab = (labels4 >> (8 * t)) & 0xff;
  const bool valid = active && lab != ignore_label;
  const dsrl_tail::LaneRow<Half> l = dsrl_tail::lane_logits<Half>(acc, s_b);
  const float picked = dsrl_tail::picked_logit(l, lab), m = dsrl_tail::row_max(l);
  const float nll = dsrl_tail::ce_nll(m, dsrl_tail::exp_sum(l, m), picked);
  ce += valid ? (double)nll : 0.0;
  n_valid += valid;
}

// Sums a block's per-thread CE and counts in a fixed order into its slot.
template <int kBlockWarps>
__device__ __forceinline__ void block_partial(double ce, int n_valid, double* __restrict__ ce_partials,
                                              long long* __restrict__ cnt_partials) {
  __shared__ double s_ce[kBlockWarps];
  __shared__ int s_cnt[kBlockWarps];
  const double ce_w = dsrl_tail::warp_sum(ce);
  const int valid_w = dsrl_tail::warp_sum(n_valid);
  if ((threadIdx.x & 31) == 0) {
    s_ce[threadIdx.x >> 5] = ce_w;
    s_cnt[threadIdx.x >> 5] = valid_w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    long long n = 0;
#pragma unroll
    for (int i = 0; i < kBlockWarps; ++i) {
      t += s_ce[i];
      n += s_cnt[i];
    }
    ce_partials[blockIdx.x] = t;
    cnt_partials[blockIdx.x] = n;
  }
}

// A warp's walk over its warpgroup's tiles (the forward).
template <typename T> struct FwdWalk {
  const T* x;
  const uint8_t* labels;
  T* s_x;                    // the warp's two slabs
  const float* s_b;
  long long tile, ntiles, groups, p0, npix;
  dsrl_tail::PixelPos pos;   // of p0
  unsigned hw, stride;       // stride: pixels from one of the warpgroup's tiles to the next
  int width, ignore_label, lane, it;
  uint32_t labels4;          // lane l: the four labels of pixel p0 + l % 16 of this tile
  double ce;
  int n_valid;
};

// Starts loading this warp's slab of the tile `ahead` tiles after w.tile.
template <typename T>
__device__ __forceinline__ void load_slab(const FwdWalk<T>& w, T* slab, unsigned ahead) {
  const long long p0 = w.p0 + (long long)ahead * w.stride;
  const dsrl_tail::PixelPos pos = dsrl_tail::advance(w.pos, ahead * w.stride, w.hw);
  if (!dsrl_tail::load_x_part_whole<T>(slab, w.x, p0, pos, w.npix, w.hw, w.lane))
    dsrl_tail::load_x_part<T>(slab, w.x, p0, pos, w.npix, w.hw, w.lane);
}

// One step of the walk: the slab of tile `w.tile` has been requested two
// steps before.  Issues the tile's products, starts loading the slab two
// tiles ahead into the buffer just read and the next tile's labels while
// the tensor cores run, waits for the products and takes the CE.  The tile
// indices are warpgroup-uniform (derived from a shuffled warp index) and
// no wgmma sits in a branch, so ptxas keeps them asynchronous.  Returns
// whether a next tile exists.
template <typename T>
__device__ __forceinline__ bool fwd_step(FwdWalk<T>& w, dsrl_tail::WgA<T>& a, float (&acc)[dsrl_tail::kNT][4],
                                         uint64_t desc) {
  const bool more = w.tile + w.groups < w.ntiles;
  T* slab = w.s_x + (w.it & 1) * kSlabElems;
  dsrl_tail::cp_async_wait<1>();
  __syncwarp();      // this tile's slab has landed
  dsrl_tail::load_wg_a<T>(slab, w.lane, a);
  __syncwarp();      // every lane has read it
  dsrl_tail::wg_fence();
  dsrl_tail::issue_logits_wgmma<T>(acc, a, desc);
  dsrl_tail::wg_commit();
  dsrl_tail::wg_fence_acc(acc);
  if (w.tile + 2 * w.groups < w.ntiles) load_slab(w, slab, 2);
  dsrl_tail::cp_async_commit();
  const int pl = w.lane & (kWarpP - 1);
  const uint32_t labels_next =
      dsrl_tail::pixel_info(w.labels, w.p0 + w.stride + pl, dsrl_tail::advance(w.pos, w.stride + pl, w.hw),
                            w.npix, w.width, w.hw).labels4;
  const int g = w.lane >> 2, t = w.lane & 3;
  const uint32_t lab0 = __shfl_sync(0xffffffffu, w.labels4, g);
  const uint32_t lab1 = __shfl_sync(0xffffffffu, w.labels4, g + 8);
  dsrl_tail::wg_wait<0>();
  dsrl_tail::wg_fence_acc(acc);
  add_ce<0>(acc, w.s_b, lab0, t, w.p0 + g < w.npix, w.ignore_label, w.ce, w.n_valid);
  add_ce<1>(acc, w.s_b, lab1, t, w.p0 + g + 8 < w.npix, w.ignore_label, w.ce, w.n_valid);
  w.labels4 = labels_next;
  w.tile += w.groups;
  w.p0 += w.stride;
  w.pos = dsrl_tail::advance(w.pos, w.stride, w.hw);
  ++w.it;
  return more;
}

template <typename T>
__global__ void __launch_bounds__(FwdShape<T>::kThreads, 1)
fused_tail_fwd_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, const uint8_t* __restrict__ labels,
                      double* __restrict__ ce_partials, long long* __restrict__ cnt_partials,
                      int height, int width, long long npix, int ignore_label) {
  using S = FwdSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  // Shuffled from lane 0, so the compiler sees it uniform over the warp.
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  uint32_t* s_wb = reinterpret_cast<uint32_t*>(smem);
  float* s_b = reinterpret_cast<float*>(smem + S::kW);
  dsrl_tail::load_wg_weights<T>(s_wb, s_b, weight, bias);
  dsrl_tail::wg_fence_proxy();
  __syncthreads();   // the weights

  FwdWalk<T> w;
  w.x = x;
  w.labels = labels;
  w.s_x = reinterpret_cast<T*>(smem + S::kW + S::kB) + warp * 2 * kSlabElems;
  w.s_b = s_b;
  w.hw = (unsigned)height * (unsigned)width;
  w.ntiles = (npix + dsrl_tail::kWgM - 1) / dsrl_tail::kWgM;
  w.groups = (long long)gridDim.x * FwdShape<T>::kWG;
  w.stride = (unsigned)w.groups * dsrl_tail::kWgM;
  w.tile = (long long)blockIdx.x * FwdShape<T>::kWG + warp / 4;
  w.npix = npix;
  w.width = width;
  w.ignore_label = ignore_label;
  w.lane = lane;
  w.it = 0;
  w.ce = 0.0;
  w.n_valid = 0;
  if (w.tile < w.ntiles) {   // uniform over the warpgroup
    // The slabs of the first two tiles in flight, the first tile's labels.
    w.p0 = w.tile * dsrl_tail::kWgM + (warp % 4) * kWarpP;
    w.pos = dsrl_tail::pixel_pos(w.p0, w.hw);
    load_slab(w, w.s_x, 0);
    dsrl_tail::cp_async_commit();
    if (w.tile + w.groups < w.ntiles) load_slab(w, w.s_x + kSlabElems, 1);
    dsrl_tail::cp_async_commit();
    w.labels4 = dsrl_tail::pixel_info(labels, w.p0 + (lane & (kWarpP - 1)),
                                      dsrl_tail::advance(w.pos, lane & (kWarpP - 1), w.hw), npix, width,
                                      w.hw).labels4;
    // A's fragments and the accumulators live across the steps: as locals
    // of a step the float32 kernel spills (measured).
    dsrl_tail::WgA<T> a;
    float acc[dsrl_tail::kNT][4];
    const uint64_t desc = dsrl_tail::wg_desc(s_wb);
    while (fwd_step<T>(w, a, acc, desc)) {
    }
  }
  dsrl_tail::cp_async_wait<0>();
  block_partial<FwdShape<T>::kWarps>(w.ce, w.n_valid, ce_partials, cnt_partials);
}

// One block: sums the forward's per-block partials in a fixed order.
__global__ void __launch_bounds__(kFinalThreads)
fwd_sum_kernel(const double* __restrict__ ce_partials, const long long* __restrict__ cnt_partials,
               long long n, double* __restrict__ ce_sum, long long* __restrict__ count) {
  __shared__ double s_ce[kFinalThreads];
  __shared__ long long s_n[kFinalThreads];
  double t = 0.0;
  long long c = 0;
  for (long long i = threadIdx.x; i < n; i += kFinalThreads) {
    t += ce_partials[i];
    c += cnt_partials[i];
  }
  s_ce[threadIdx.x] = t;
  s_n[threadIdx.x] = c;
  __syncthreads();
  for (int stride = kFinalThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_ce[threadIdx.x] += s_ce[threadIdx.x + stride];
      s_n[threadIdx.x] += s_n[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *ce_sum = s_ce[0];
    *count = s_n[0];
  }
}

// Turns one output pixel's logits (with bias) into its dlogits, in place:
// (softmax - onehot) * scale where the pixel is active and its label is not
// ignored, else 0; the padding class 19 becomes 0 too.
template <typename Row>
__device__ __forceinline__ void to_dlogits(const Row& l, int lab, bool active, float scale,
                                           int ignore_label) {
  const bool valid = active && lab != ignore_label;
  const float inv_z = 1.f / dsrl_tail::exp_sum(l, dsrl_tail::row_max(l));
#pragma unroll
  for (int co = 0; co < kC; ++co) l[co] = valid ? (l[co] * inv_z - (co == lab ? 1.f : 0.f)) * scale : 0.f;
  l[kC] = 0.f;
}

// dX of a warp's 16 pixels: (16 x 24) = dlogits (16 x 80) . W^T (80 x 24),
// the dlogits read back from the warp's shared tile `s_lw` (row p, column
// n) as pairs: for bfloat16 columns 2t, 2t + 1 of a k16 step, the m16n8k16
// layout; for TF32 the k8 step nt takes columns nt*8 + 2t and + 1 as its
// columns t and t + 4, and the dX B table (`dx_table_col`) is ordered to
// match.  Written in x's dtype for the real channels of the active pixels.
template <typename T>
__device__ __forceinline__ void part_dx(const float* s_lw, const uint32_t* s_wtb, const long long* s_off,
                                        T* __restrict__ dx, long long p0, long long npix, unsigned hw,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  float acc[3][4] = {};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int nt = 0; nt < dsrl_tail::kNT; ++nt) {
      const float2 r0 = *reinterpret_cast<const float2*>(s_lw + g * kSL + nt * 8 + 2 * t);
      const float2 r1 = *reinterpret_cast<const float2*>(s_lw + (g + 8) * kSL + nt * 8 + 2 * t);
      uint32_t a_hi[4], a_lo[4];
      dsrl_tail::split_tf32(r0.x, a_hi[0], a_lo[0]);
      dsrl_tail::split_tf32(r1.x, a_hi[1], a_lo[1]);
      dsrl_tail::split_tf32(r0.y, a_hi[2], a_lo[2]);
      dsrl_tail::split_tf32(r1.y, a_hi[3], a_lo[3]);
#pragma unroll
      for (int ct = 0; ct < 3; ++ct) {
        uint32_t b_hi[2], b_lo[2];
        dsrl_tail::b_frag_tf32(s_wtb, kNPad, kSWT, nt * 8, ct * 8 + g, t, b_hi, b_lo);
        dsrl_tail::mma_3xtf32(acc[ct], a_hi, a_lo, b_hi, b_lo);
      }
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < kNPad; k0 += 16) {
      uint32_t a[4];   // dlogits rounded to bfloat16 (fused_tail.py:173)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(s_lw + (g + 8 * (i & 1)) * kSL + k0 + 8 * (i >> 1) + 2 * t);
        a[i] = dsrl_tail::pack_bf16(v.x, v.y);
      }
#pragma unroll
      for (int ct = 0; ct < 3; ++ct) {
        uint32_t b[2];
        dsrl_tail::b_frag_bf16(s_wtb, kSWT, k0, ct * 8 + g, t, b);
        dsrl_tail::mma_bf16(acc[ct], a, b);
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = g + 8 * hr;
    if (p0 + p < npix) {
      T* dp = dx + s_off[p];
#pragma unroll
      for (int ct = 0; ct < 3; ++ct)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ci = ct * 8 + 2 * t + j;
          if (ci < kC) dp[ci * (long long)hw] = from_float<T>(acc[ct][2 * hr + j]);
        }
    }
  }
}

// The logits column (dlogits column of dX's A operand) that row k of dX's B
// table stands for: for TF32, row r < 4 of k8 step nt is column nt*8 + 2r,
// row r + 4 column nt*8 + 2r + 1 (see `part_dx`); for bfloat16 row k.
template <typename T>
__device__ __forceinline__ int dx_table_col(int k) {
  if constexpr (sizeof(T) == 4) {
    const int r = k % 8;
    return k - r + (r < 4 ? 2 * r : 2 * (r - 4) + 1);
  } else {
    return k;
  }
}

// dW^T (80 x 24) += dlogits^T (80 x 128) . X^T (128 x 24) over the block's
// tile for the m16n8 tile `id` of 15 (rows = logits columns, 5 x 16;
// columns = channels, 3 x 8).  Pixel k of the tile is pixel k % 16 of warp
// k / 16's part: its dlogits at s_l + (k / 16) * kWarpL, its slab at s_x +
// (k / 16) * warp_slabs.
template <typename T>
__device__ __forceinline__ void tile_dw(const float* s_l, const T* s_x, int warp_slabs, int id, int lane,
                                        float (&acc)[4]) {
  constexpr int SX = dsrl_tail::kSlabStride;
  const int g = lane >> 2, t = lane & 3;
  const int m = (id / 3) * 16 + g;      // logits column
  const int ci = (id % 3) * 8 + g;      // x channel
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float* lw = s_l + w * kWarpL;
    const T* xw = s_x + w * warp_slabs;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k0 = 0; k0 < kWarpP; k0 += 8) {
        uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
        dsrl_tail::split_tf32(lw[(k0 + t) * kSL + m], a_hi[0], a_lo[0]);
        dsrl_tail::split_tf32(lw[(k0 + t) * kSL + m + 8], a_hi[1], a_lo[1]);
        dsrl_tail::split_tf32(lw[(k0 + t + 4) * kSL + m], a_hi[2], a_lo[2]);
        dsrl_tail::split_tf32(lw[(k0 + t + 4) * kSL + m + 8], a_hi[3], a_lo[3]);
        dsrl_tail::split_tf32(dsrl_tail::slab_at(xw, ci, k0 + t), b_hi[0], b_lo[0]);
        dsrl_tail::split_tf32(dsrl_tail::slab_at(xw, ci, k0 + t + 4), b_hi[1], b_lo[1]);
        dsrl_tail::mma_3xtf32(acc, a_hi, a_lo, b_hi, b_lo);
      }
    } else {
      const int r0 = 2 * t, r1 = r0 + 8;
      uint32_t a[4], b[2];
      a[0] = dsrl_tail::pack_bf16(lw[r0 * kSL + m], lw[(r0 + 1) * kSL + m]);
      a[1] = dsrl_tail::pack_bf16(lw[r0 * kSL + m + 8], lw[(r0 + 1) * kSL + m + 8]);
      a[2] = dsrl_tail::pack_bf16(lw[r1 * kSL + m], lw[(r1 + 1) * kSL + m]);
      a[3] = dsrl_tail::pack_bf16(lw[r1 * kSL + m + 8], lw[(r1 + 1) * kSL + m + 8]);
      b[0] = ci < kC ? *reinterpret_cast<const uint32_t*>(xw + ci * SX + r0) : 0u;
      b[1] = ci < kC ? *reinterpret_cast<const uint32_t*>(xw + ci * SX + r1) : 0u;
      dsrl_tail::mma_bf16(acc, a, b);
    }
  }
}

// partials: [gridDim.x][kRows][kCols] float64, row r < C = channel r of dW
// at column pos*C + co; row C = db at the same columns.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_tail_bwd_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, const uint8_t* __restrict__ labels,
                      const float* __restrict__ scale_ptr, T* __restrict__ dx,
                      double* __restrict__ partials, int height, int width, long long npix,
                      int ignore_label) {
  using S = BwdSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  T* s_xall = reinterpret_cast<T*>(smem);                                // [warp][2][C][24]
  float* s_lall = reinterpret_cast<float*>(smem + S::kX);               // [warp][16][kSL]
  uint32_t* s_wb = reinterpret_cast<uint32_t*>(smem + S::kX + S::kL);    // logits' B table
  uint32_t* s_wtb = reinterpret_cast<uint32_t*>(smem + S::kX + S::kL + S::kW);   // dX's B table
  float* s_b = reinterpret_cast<float*>(smem + S::kX + S::kL + S::kW + S::kWT);
  // This warp's slabs, dlogits, labels and x offsets.
  T* s_x = s_xall + warp * 2 * kSlabElems;
  float* s_l = s_lall + warp * kWarpL;
  uint32_t* s_lab = reinterpret_cast<uint32_t*>(smem + S::kX + S::kL + S::kW + S::kWT + S::kB) +
                    warp * 2 * kWarpP;
  long long* s_off = reinterpret_cast<long long*>(smem + S::kX + S::kL + S::kW + S::kWT + S::kB +
                                                  S::kLab) + warp * 2 * kWarpP;
  float* s_db = reinterpret_cast<float*>(smem + S::kX + S::kL + S::kW + S::kWT + S::kB + S::kLab +
                                         S::kOff);   // [kDbParts * 80]

  const float scale = *scale_ptr;
  const unsigned hw = (unsigned)height * (unsigned)width;
  const long long ntiles = (npix + kTileP - 1) / kTileP;
  const unsigned stride = gridDim.x * kTileP;   // pixels from one of the block's tiles to the next

  dsrl_tail::load_tile_weights<T>(s_wb, s_b, weight, bias);
  dsrl_tail::fill_b_table<T>(s_wtb, kNPad, kSWT, [&](int k, int ci) {
    const int n = dx_table_col<T>(k), co = dsrl_tail::col_class(n);
    return co < kC && ci < kC ? weight[(ci * kC + co) * 4 + dsrl_tail::col_pos(n)] : 0.f;
  });
  // Each warp loads, multiplies and reduces its 16-pixel part of the tile
  // (logits, dlogits, dX) on its own; the block meets twice a tile, around
  // dW, which takes every warp's part.
  long long tile = blockIdx.x;
  long long p0 = tile * kTileP + warp * kWarpP;
  const dsrl_tail::PixelPos pos = dsrl_tail::pixel_pos(p0, hw);
  dsrl_tail::load_x_part<T>(s_x, x, p0, pos, npix, hw, lane);
  dsrl_tail::cp_async_commit();
  if (lane < kWarpP) {
    const dsrl_tail::PixelInfo info =
        dsrl_tail::pixel_info(labels, p0 + lane, dsrl_tail::advance(pos, lane, hw), npix, width, hw);
    s_lab[lane] = info.labels4;
    s_off[lane] = info.xoff;
  }

  // db: thread tid < 240 sums logits column tid % 80 over the pixels of part
  // tid / 80 of the tile into its slot s_db[tid].
  constexpr int kDbParts = kThreads / kNPad, kDbSpan = (kTileP + kDbParts - 1) / kDbParts;
  const int db_col = tid % kNPad, db_part = tid / kNPad;
  if (db_part < kDbParts) s_db[tid] = 0.f;
  float dw_acc[2][4] = {};   // dW^T tiles warp and warp + 8 (of 15)
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int cur = it & 1;
    const bool more = tile + gridDim.x < ntiles;
    const long long p0_next = p0 + stride;
    const dsrl_tail::PixelPos pos_next = dsrl_tail::pixel_pos(p0_next, hw);
    __syncthreads();   // every warp is done with the previous tile (dW reads all parts)
    if (more) dsrl_tail::load_x_part<T>(s_x + (cur ^ 1) * kSlabElems, x, p0_next, pos_next, npix, hw, lane);
    dsrl_tail::cp_async_commit();
    dsrl_tail::cp_async_wait<1>();
    __syncwarp();      // this part's slab has landed
    float acc[dsrl_tail::kNT][4];
    dsrl_tail::tile_logits_mma<T>(s_x + cur * kSlabElems, s_wb, lane, acc);
    // The next part's labels and offsets: loaded now, stored after the
    // softmax (out of the registers' busiest stretch, the logits product).
    dsrl_tail::PixelInfo info_next = {0, 0, 0u};
    if (lane < kWarpP && more)
      info_next = dsrl_tail::pixel_info(labels, p0_next + lane, dsrl_tail::advance(pos_next, lane, hw),
                                        npix, width, hw);
    // Lane (g, t) owns output position t of pixels g and g + 8: it turns
    // their logits into dlogits in place, in the accumulators.
    to_dlogits(dsrl_tail::lane_logits<0>(acc, s_b), s_lab[cur * kWarpP + g] >> (8 * t) & 0xff,
               p0 + g < npix, scale, ignore_label);
    to_dlogits(dsrl_tail::lane_logits<1>(acc, s_b), s_lab[cur * kWarpP + g + 8] >> (8 * t) & 0xff,
               p0 + g + 8 < npix, scale, ignore_label);
    if (lane < kWarpP && more) {
      s_lab[(cur ^ 1) * kWarpP + lane] = info_next.labels4;
      s_off[(cur ^ 1) * kWarpP + lane] = info_next.xoff;
    }
    // The dlogits to this warp's shared tile for dW and db (row p, column n).
#pragma unroll
    for (int nt = 0; nt < dsrl_tail::kNT; ++nt) {
      *reinterpret_cast<float2*>(s_l + g * kSL + nt * 8 + 2 * t) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(s_l + (g + 8) * kSL + nt * 8 + 2 * t) = make_float2(acc[nt][2], acc[nt][3]);
    }
    __syncwarp();      // the dlogits leave the registers: dX reads them back
    part_dx<T>(s_l, s_wtb, s_off + cur * kWarpP, dx, p0, npix, hw, lane);
    __syncthreads();   // every warp's dlogits are in place
    const T* xs = s_xall + cur * kSlabElems;
    tile_dw<T>(s_lall, xs, 2 * kSlabElems, warp, lane, dw_acc[0]);
    if (warp + 8 < 15) tile_dw<T>(s_lall, xs, 2 * kSlabElems, warp + 8, lane, dw_acc[1]);
    if (db_part < kDbParts) {
      float sum = 0.f;
      const int p_end = min(kTileP, (db_part + 1) * kDbSpan);
      for (int p = db_part * kDbSpan; p < p_end; ++p)
        sum += s_lall[(p / kWarpP) * kWarpL + (p % kWarpP) * kSL + db_col];
      s_db[tid] += sum;
    }
    p0 = p0_next;
  }
  dsrl_tail::cp_async_wait<0>();
  __syncthreads();

  // The block's partial, float64, at column pos*C + co of logits column n.
  // dW from the accumulators (each entry has one owner); db from the parts'
  // column sums, in part order.
  double* part = partials + (long long)blockIdx.x * kRows * kCols;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int id = warp + 8 * s;
    if (id < 15) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = (id / 3) * 16 + g + (j >= 2 ? 8 : 0);
        const int ci = (id % 3) * 8 + 2 * t + (j & 1);
        const int co = dsrl_tail::col_class(n);
        if (co < kC && ci < kC) part[ci * kCols + dsrl_tail::col_pos(n) * kC + co] = (double)dw_acc[s][j];
      }
    }
  }
  if (tid < kNPad && dsrl_tail::col_class(tid) < kC) {
    double sum = 0.0;
#pragma unroll
    for (int i = 0; i < kDbParts; ++i) sum += (double)s_db[i * kNPad + tid];
    part[kC * kCols + dsrl_tail::col_pos(tid) * kC + dsrl_tail::col_class(tid)] = sum;
  }
}

// One block: sums the backward's per-block partials over blocks in a fixed
// order (float64) and writes dW (IOHW) and db as float32.
__global__ void __launch_bounds__(kFinalThreads)
bwd_sum_kernel(const double* __restrict__ partials, int nblocks, float* __restrict__ dw,
               float* __restrict__ db) {
  __shared__ double s_db[kCols];
  for (int o = threadIdx.x; o < kRows * kCols; o += kFinalThreads) {
    double t = 0.0;
    for (int i = 0; i < nblocks; ++i) t += partials[(long long)i * kRows * kCols + o];
    const int row = o / kCols, col = o - row * kCols;
    const int kpos = col / kC, co = col - kpos * kC;
    if (row < kC) dw[(row * kC + co) * 4 + kpos] = (float)t;   // IOHW: ((ci*C + co)*2 + kh)*2 + kw
    else s_db[col] = t;
  }
  __syncthreads();
  if (threadIdx.x < kC) {
    double t = 0.0;
#pragma unroll
    for (int kpos = 0; kpos < 4; ++kpos) t += s_db[kpos * kC + threadIdx.x];
    db[threadIdx.x] = (float)t;
  }
}

// The persistent grid of a tile kernel: the SM count times the blocks the
// occupancy allows per SM, at most `blocks_needed`.
template <typename K>
int persistent_grid(K kernel, int threads, int smem, long long blocks_needed, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long full = (long long)sms * per_sm;
  *grid = (int)(blocks_needed < full ? blocks_needed : full);
  return 0;
}

template <typename T>
int fwd_grid(long long npix, int* grid) {
  const long long tiles = (npix + dsrl_tail::kWgM - 1) / dsrl_tail::kWgM;
  return persistent_grid(fused_tail_fwd_kernel<T>, FwdShape<T>::kThreads, FwdSmem<T>::kBytes,
                         (tiles + FwdShape<T>::kWG - 1) / FwdShape<T>::kWG, grid);
}

template <typename T>
int launch_fwd(const void* x, const float* weight, const float* bias, const uint8_t* labels,
               double* ce_partials, long long* cnt_partials, int grid, double* ce_sum, long long* count,
               int batch, int height, int width, int ignore_label, cudaStream_t s) {
  const long long npix = (long long)batch * height * width;
  int expected = 0;
  const int err0 = fwd_grid<T>(npix, &expected);
  if (err0) return err0;
  if (grid != expected) return (int)cudaErrorInvalidValue;   // partials sized for another grid
  fused_tail_fwd_kernel<T><<<grid, FwdShape<T>::kThreads, FwdSmem<T>::kBytes, s>>>(
      static_cast<const T*>(x), weight, bias, labels, ce_partials, cnt_partials, height, width, npix,
      ignore_label);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_sum_kernel<<<1, kFinalThreads, 0, s>>>(ce_partials, cnt_partials, grid, ce_sum, count);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_grid(long long npix, int* grid) {
  return persistent_grid(fused_tail_bwd_kernel<T>, kThreads, BwdSmem<T>::kBytes,
                         (npix + kTileP - 1) / kTileP, grid);
}

template <typename T>
int launch_bwd(const void* x, const float* weight, const float* bias, const uint8_t* labels,
               const float* scale, void* dx, double* partials, int grid, float* dw, float* db,
               int batch, int height, int width, int ignore_label, cudaStream_t s) {
  const long long npix = (long long)batch * height * width;
  int expected = 0;
  const int err0 = bwd_grid<T>(npix, &expected);
  if (err0) return err0;
  if (grid != expected) return (int)cudaErrorInvalidValue;   // partials sized for another grid
  fused_tail_bwd_kernel<T><<<grid, kThreads, BwdSmem<T>::kBytes, s>>>(
      static_cast<const T*>(x), weight, bias, labels, scale, static_cast<T*>(dx), partials,
      height, width, npix, ignore_label);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_sum_kernel<<<1, kFinalThreads, 0, s>>>(partials, grid, dw, db);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dsrl_fused_tail_classes() { return kC; }
int dsrl_fused_tail_partial_size() { return kRows * kCols; }

// dtype: 0 = float32 x, 1 = bfloat16 x.  Write the fixed forward or
// backward grid for npix pre-tail pixels to *grid (the wrapper sizes the
// partials with it); return a CUDA error code (0 = ok).
int dsrl_fused_tail_fwd_grid(int dtype, long long npix, int* grid) {
  return dtype ? fwd_grid<__nv_bfloat16>(npix, grid) : fwd_grid<float>(npix, grid);
}

int dsrl_fused_tail_bwd_grid(int dtype, long long npix, int* grid) {
  return dtype ? bwd_grid<__nv_bfloat16>(npix, grid) : bwd_grid<float>(npix, grid);
}

// Both passes on `stream`.  ce_partials and cnt_partials hold `grid` slots
// (dsrl_fused_tail_fwd_grid); returns cudaGetLastError() (0 = ok).
int dsrl_fused_tail_fwd(int dtype, const void* x, const float* weight, const float* bias,
                        const uint8_t* labels, double* ce_partials, long long* cnt_partials, int grid,
                        double* ce_sum, long long* count, int batch, int height, int width,
                        int ignore_label, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_fwd<__nv_bfloat16>(x, weight, bias, labels, ce_partials, cnt_partials, grid,
                                           ce_sum, count, batch, height, width, ignore_label, s)
               : launch_fwd<float>(x, weight, bias, labels, ce_partials, cnt_partials, grid, ce_sum,
                                   count, batch, height, width, ignore_label, s);
}

// Both passes on `stream`.  scale: float32 device scalar (the cotangent of
// ce_sum); partials: grid * partial_size doubles, grid from
// dsrl_fused_tail_bwd_grid.  dx has x's dtype and shape; dw (C, C, 2, 2) and
// db (C,) are float32.
int dsrl_fused_tail_bwd(int dtype, const void* x, const float* weight, const float* bias,
                        const uint8_t* labels, const float* scale, void* dx, double* partials,
                        int grid, float* dw, float* db, int batch, int height, int width,
                        int ignore_label, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_bwd<__nv_bfloat16>(x, weight, bias, labels, scale, dx, partials, grid,
                                           dw, db, batch, height, width, ignore_label, s)
               : launch_bwd<float>(x, weight, bias, labels, scale, dx, partials, grid, dw, db,
                                   batch, height, width, ignore_label, s);
}

}  // extern "C"
