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
// Backward design, around the same warpgroup products as the forward.  A
// persistent grid, one block an SM of 3 or 4 warpgroups (`BwdShape`),
// walks the 64-pixel tiles as the forward does, each warp loading its 16
// pixels' (C, 16) slab with cp.async two tiles ahead and their labels one
// tile ahead; here the slab is kept in the tensor cores' K-major
// core-matrix layout (`CoreSlab`), so that it is also the B operand of
// dW^T, and lane (g, t) owns pixels 2g and 2g + 1 of its warp's 16 (rows g
// and g + 8 of the m16 fragments), so that its two pixels lie side by side
// in the slab, in the staged dlogits and in dX.  A float32 slab is split
// once into TF32 hi (in place) and lo planes.  Per tile:
//   * logits (64 x 80) = X^T . W: the forward's chain (`issue_logits_wgmma`,
//     A from registers), then each lane turns its two output pixels'
//     logits into dlogits in the accumulators (`to_dlogits`) and adds them
//     to its float32 db sums (19 registers, one per class of its output
//     position t), in a fixed order;
//   * the dlogits, split into TF32 hi and lo (float32 x) or rounded to
//     bfloat16, once: staged into the warpgroup's (80 x 64) K-major dW^T A
//     operand (`DlStage`, one 8-byte or 4-byte store per pixel pair) and,
//     in registers, the A fragments of dX;
//   * dX (64 x 24) = dlogits . W^T: wgmma m64n24 (k8 TF32, 10 k steps x 3
//     passes; k16 bfloat16, 5 k steps), A from registers (the k8 step nt
//     takes columns nt*8 + 2t and + 1 as its columns t and t + 4, and W^T's
//     table rows are ordered to match, `dx_table_col`), B W^T's table;
//   * dW^T (80 x 24) += dlogits^T . X over the tile's 64 pixels, K =
//     pixels.  M = 80 is not a multiple of 64: rows 0-63 are one wgmma
//     m64n24 chain, A the staged dlogits and B the four warps' slabs, both
//     from shared memory; rows 64-79 (classes 16-19) are finished by each
//     warp over its own 16 pixels with mma.sync (`tail_rows_dw`: A from its
//     part of the staging, B from its slab; 18 m16n8k8 TF32 or 3 m16n8k16
//     bfloat16 products a warp a tile), after dX's wait, while the wgmma
//     chain runs.  (A second m64 chain over rows
//     16-79 instead read 2.8 KB of shared memory per k step for 16 useful
//     rows: 0.300 against 0.282 ms float32, PERF.md.)  Both accumulator
//     sets stay in registers across the warpgroup's tiles, the mma.sync
//     ones a warp's partial sums added at the end;
//   * dX is written in x's dtype (a pixel pair per store) while dW^T runs.
// A warpgroup meets only itself, at two named barriers a tile (bar.sync id,
// 128): its staged dlogits and slabs are in place before dW^T, and every
// warp's products are done before the slabs and the staging are reused.
// At the end each block adds its warpgroups' and warps' dW^T and db in a
// fixed order into its float64 slot, and a one-block pass adds the slots in
// a fixed order: no float atomics, so two launches on the same inputs give
// bit-identical results.
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
using dsrl_tail::kNT;
using dsrl_tail::kWarpP;
using dsrl_tail::kWgM;
using dsrl_tail::kWgSbo;
using dsrl_tail::from_float;
constexpr int kRows = kC + 1;                   // dW's channels and db
constexpr int kCols = kN;                       // (output position, class)
constexpr int kFinalThreads = 1024;
constexpr int kSlabElems = dsrl_tail::RowSlab<float>::kElems;   // a warp's (C, 16) slab (the forward's)

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
__device__ __forceinline__ void add_ce(float (&acc)[kNT][4], const float* s_b, uint32_t labels4,
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

template <typename T> struct FwdWalk : dsrl_tail::TailWalk<T> {
  double ce;
  int n_valid;
};

// One step of the walk: the slab of tile `w.tile` has been requested two
// steps before.  Issues the tile's products, starts loading the slab two
// tiles ahead into the buffer just read and the next tile's labels while
// the tensor cores run, waits for the products and takes the CE.  The tile
// indices are warpgroup-uniform (derived from a shuffled warp index) and
// no wgmma sits in a branch, so ptxas keeps them asynchronous.  Returns
// whether a next tile exists.
template <typename T>
__device__ __forceinline__ bool fwd_step(FwdWalk<T>& w, dsrl_tail::WgA<T>& a, float (&acc)[kNT][4],
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
  if (w.tile + 2 * w.groups < w.ntiles) dsrl_tail::load_slab(w, slab, 2);
  dsrl_tail::cp_async_commit();
  const uint32_t labels_next = dsrl_tail::walk_pixel(w, 1).labels4;
  const int g = w.lane >> 2, t = w.lane & 3;
  const uint32_t lab0 = __shfl_sync(0xffffffffu, w.labels4, g);
  const uint32_t lab1 = __shfl_sync(0xffffffffu, w.labels4, g + 8);
  dsrl_tail::wg_wait<0>();
  dsrl_tail::wg_fence_acc(acc);
  add_ce<0>(acc, w.s_b, lab0, t, w.p0 + g < w.npix, w.ignore_label, w.ce, w.n_valid);
  add_ce<1>(acc, w.s_b, lab1, t, w.p0 + g + 8 < w.npix, w.ignore_label, w.ce, w.n_valid);
  dsrl_tail::advance_walk(w, labels_next);
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
  dsrl_tail::init_walk<T>(w, x, labels, reinterpret_cast<T*>(smem + S::kW + S::kB) + warp * 2 * kSlabElems,
                          s_b, height, width, npix, ignore_label, FwdShape<T>::kWG, warp, lane);
  w.ce = 0.0;
  w.n_valid = 0;
  if (w.tile < w.ntiles) {   // uniform over the warpgroup
    dsrl_tail::start_walk<T>(w, warp % 4);
    // A's fragments and the accumulators live across the steps: as locals
    // of a step the float32 kernel spills (measured).
    dsrl_tail::WgA<T> a;
    float acc[kNT][4];
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

// ---------------------------------------------------------------- backward

// The backward's block: one an SM of 3 (float32 x) or 4 (bfloat16 x)
// warpgroups.  A float32 block's shared memory (206 KB: each warpgroup's
// staged dlogits, 41 KB, and its warps' slabs) leaves no room for a
// fourth, nor do its registers (168 a thread while dX is in flight: the
// dlogits' hi and lo fragments, both accumulator sets, the db sums); a
// bfloat16 block of 4 fits in 128 registers without spills.  Fewer
// warpgroups are slower (PERF.md).
template <typename T> struct BwdShape {
  static constexpr int kWG = sizeof(T) == 4 ? 3 : 4;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kWarps = 4 * kWG;
};

// A warp's (C, 16) slab in the tensor cores' K-major core-matrix layout,
// the B operand of dW^T (N = channels, K = pixels): 8 channels x 16 bytes
// of pixels make a 128-byte core matrix; K-adjacent ones kLbo = 128 bytes
// apart, the three groups of 8 channels kSbo apart.  Channels 19-23 stay
// zero.  (The pixel pairs of the logits' A fragments meet a 2-way bank
// conflict in this layout: 6 (bfloat16: 6) loads a lane a tile.)
template <typename T> struct CoreSlab {
  static constexpr int kChunk = 16 / sizeof(T);             // pixels of a 16-byte row: 4 or 8
  static constexpr int kLbo = 128;
  static constexpr int kSbo = kWarpP / kChunk * kLbo;        // 512 or 256
  static constexpr int kBytes = 3 * kSbo;
  static constexpr int kElems = kBytes / (int)sizeof(T);
  static __host__ __device__ constexpr int off(int ci, int p) {   // in elements
    return ((ci / 8) * kSbo + (p / kChunk) * kLbo) / (int)sizeof(T) + (ci % 8) * kChunk + p % kChunk;
  }
};

// A warpgroup's staged dlogits, the A operand of dW^T (M = 80 logits
// columns, K = its 64 pixels), K-major: 8 columns x 16 bytes of pixels a
// core matrix, M-adjacent ones kDlSbo = 128 bytes apart and K-adjacent
// ones kDlLbo = 1296 bytes apart (10 x 128 and 16 more, so that the pixel
// pairs of a warp's stores fall in distinct banks).  Float32 x: TF32 hi
// and lo planes; bfloat16 x: one plane.
constexpr int kDlLbo = 1296;
constexpr int kDlSbo = 128;
template <typename T> struct DlStage {
  static constexpr int kChunk = 16 / sizeof(T);
  static constexpr int kPlane = kWgM / kChunk * kDlLbo;      // 20736 or 10368
  static constexpr int kBytes = (sizeof(T) == 4 ? 2 : 1) * kPlane;
};

// dX's B table, W^T (K = the 80 logits columns, N = 24 channels) in the
// wgmma table layout of tail_common.cuh: 3 groups of 8 channels.
constexpr int kDxGroups = 3;
template <typename T> struct DxTable {
  static constexpr int kSteps = sizeof(T) == 4 ? kNPad / 8 : kNPad / 16;   // 10 or 5
  static constexpr int kStep = kDxGroups * kWgSbo;                         // 768 bytes
  static constexpr int kPlane = kSteps * kStep;
  static constexpr int kBytes = (sizeof(T) == 4 ? 2 : 1) * kPlane;
};

// Shared memory of the backward kernel, in bytes (each part a multiple of
// 16): the logits' and dX's B tables, the bias, two slabs a warp (and a lo
// plane a warp for float32 x), each warpgroup's staged dlogits.
template <typename T> struct BwdSmem {
  static constexpr int kW = dsrl_tail::WgTable<T>::kBytes;
  static constexpr int kWT = DxTable<T>::kBytes;
  static constexpr int kB = 80;
  static constexpr int kX = BwdShape<T>::kWarps * 2 * CoreSlab<T>::kBytes;
  static constexpr int kXLo = sizeof(T) == 4 ? BwdShape<T>::kWarps * CoreSlab<T>::kBytes : 0;
  static constexpr int kL = BwdShape<T>::kWG * DlStage<T>::kBytes;
  static constexpr int kBytes = kW + kWT + kB + kX + kXLo + kL;
  // The end's reductions reuse the slabs and the staging: each warpgroup's
  // dW^T rows 0-63 and each warp's rows 64-79 (24 columns, float32), then
  // each warp's db sums (4 positions x C, float64).
  static_assert((BwdShape<T>::kWG * kWgM + BwdShape<T>::kWarps * 16) * 24 * 4 +
                        BwdShape<T>::kWarps * 4 * kC * 8 <= kX + kXLo + kL,
                "the end's reductions must fit in the slabs and the staging");
};

// The logits column that row k of dX's B table stands for: for TF32, row
// r < 4 of k8 step nt is column nt*8 + 2r, row r + 4 column nt*8 + 2r + 1
// (the accumulator pairs a lane holds, `issue_dx_wgmma`); for bfloat16 row k.
template <typename T>
__device__ __forceinline__ int dx_table_col(int k) {
  if constexpr (sizeof(T) == 4) {
    const int r = k % 8;
    return k - r + (r < 4 ? 2 * r : 2 * (r - 4) + 1);
  } else {
    return k;
  }
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d = a . B (scale_d 0) or d += a . B, m64n24k8 TF32 (A from registers;
// B at desc_b).
__device__ __forceinline__ void wgmma_n24_tf32(float (&d)[3][4], const uint32_t (&a)[4], uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The same, m64n24k16 bfloat16 (B K-major).
__device__ __forceinline__ void wgmma_n24_bf16(float (&d)[3][4], const uint32_t (&a)[4], uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d += A . B, m64n24k8 TF32 (k16 bfloat16), A and B from shared memory,
// both K-major.
template <typename T>
__device__ __forceinline__ void wgmma_n24_ss(float (&d)[3][4], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (sizeof(T) == 4) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, 1, 1, 1;\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
          "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
        : "l"(desc_a), "l"(desc_b));
  } else {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, 1, 1, 1, 0, 0;\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
          "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
        : "l"(desc_a), "l"(desc_b));
  }
}

// Splits a landed float32 slab into TF32 hi (in place) and lo planes, 16
// bytes a lane at a time (8 consecutive lanes take 8 channels of one
// pixel chunk: distinct banks).
__device__ __forceinline__ void split_slab(float* hi, float* lo, int lane) {
  for (int i = lane; i < kC * 4; i += 32) {
    const int ci = i % kC, c = i / kC;
    const int o = CoreSlab<float>::off(ci, 4 * c);
    const float4 v = *reinterpret_cast<const float4*>(hi + o);
    uint4 h, l;
    dsrl_tail::split_tf32(v.x, h.x, l.x);
    dsrl_tail::split_tf32(v.y, h.y, l.y);
    dsrl_tail::split_tf32(v.z, h.z, l.z);
    dsrl_tail::split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// The logits' A fragments of a warp's part from its core-matrix slab: rows
// g and g + 8 are pixels 2g and 2g + 1, side by side (one 8-byte or 4-byte
// load), columns as `a_frag_tf32` / `a_frag_bf16`.  Float32 x: the TF32 hi
// and lo planes; bfloat16 x: channel pairs packed with a byte permute
// (channels 24-31 of the second k16 step are zero).
template <typename T>
__device__ __forceinline__ void load_bwd_a(const T* slab, const T* lo, int lane, dsrl_tail::WgA<T>& a) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int s = 0; s < dsrl_tail::WgTable<T>::kSteps; ++s) {
      const int o0 = CoreSlab<T>::off(8 * s + t, 2 * g), o1 = CoreSlab<T>::off(8 * s + t + 4, 2 * g);
      const uint2 h0 = *reinterpret_cast<const uint2*>(slab + o0);
      const uint2 h1 = *reinterpret_cast<const uint2*>(slab + o1);
      const uint2 l0 = *reinterpret_cast<const uint2*>(lo + o0);
      const uint2 l1 = *reinterpret_cast<const uint2*>(lo + o1);
      a.hi[s][0] = h0.x;
      a.hi[s][1] = h0.y;
      a.hi[s][2] = h1.x;
      a.hi[s][3] = h1.y;
      a.lo[s][0] = l0.x;
      a.lo[s][1] = l0.y;
      a.lo[s][2] = l1.x;
      a.lo[s][3] = l1.y;
    }
  } else {
    const auto pair = [&](int ci) {
      return *reinterpret_cast<const uint32_t*>(slab + CoreSlab<T>::off(ci, 2 * g));
    };
#pragma unroll
    for (int s = 0; s < dsrl_tail::WgTable<T>::kSteps; ++s) {
      const int c0 = 16 * s + 2 * t;
      const uint32_t u0 = pair(c0), u1 = pair(c0 + 1);
      a.hi[s][0] = __byte_perm(u0, u1, 0x5410);   // pixel 2g: channels c0, c0 + 1
      a.hi[s][1] = __byte_perm(u0, u1, 0x7632);   // pixel 2g + 1
      if (s == 0) {
        const uint32_t u2 = pair(c0 + 8), u3 = pair(c0 + 9);
        a.hi[s][2] = __byte_perm(u2, u3, 0x5410);
        a.hi[s][3] = __byte_perm(u2, u3, 0x7632);
      } else {
        a.hi[s][2] = a.hi[s][3] = 0u;
      }
    }
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

// The dX operands of a lane's dlogits, which are in the accumulators
// (column nt*8 + 2t + j of pixel 2g + h at acc[nt][2h + j]).  Float32 x:
// each dlogit split into TF32 hi (in place, as float bits) and lo (`lo`,
// same places); bfloat16 x: `pk`, the m64n24k16 A fragments of the
// dlogits rounded to bfloat16 (k16 step s: columns 16s + 2t, + 1 and 16s +
// 8 + 2t, + 1).  Each value is also stored into the warpgroup's staging,
// the pixel pair (2g, 2g + 1) of a column side by side: dW^T's A operand.
template <typename T>
__device__ __forceinline__ void stage_dlogits(float (&acc)[kNT][4], uint32_t (&lo)[sizeof(T) == 4 ? kNT : 1][4],
                                              uint32_t (&pk)[kNPad / 16][4], unsigned char* stage, int w4,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int kChunk = DlStage<T>::kChunk;
  const int k = 16 * w4 + 2 * g;   // the pair's first pixel (K index)
  unsigned char* base = stage + (k / kChunk) * kDlLbo + 32 * t + (k % kChunk) * (int)sizeof(T);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t h;
        dsrl_tail::split_tf32(acc[nt][i], h, lo[nt][i]);
        acc[nt][i] = __uint_as_float(h);
      }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned char* p = base + nt * kDlSbo + 16 * j;
        *reinterpret_cast<uint2*>(p) = make_uint2(__float_as_uint(acc[nt][j]), __float_as_uint(acc[nt][2 + j]));
        *reinterpret_cast<uint2*>(p + DlStage<T>::kPlane) = make_uint2(lo[nt][j], lo[nt][2 + j]);
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint32_t*>(base + nt * kDlSbo + 16 * j) =
            dsrl_tail::pack_bf16(acc[nt][j], acc[nt][2 + j]);
#pragma unroll
    for (int s = 0; s < kNPad / 16; ++s) {
      pk[s][0] = dsrl_tail::pack_bf16(acc[2 * s][0], acc[2 * s][1]);
      pk[s][1] = dsrl_tail::pack_bf16(acc[2 * s][2], acc[2 * s][3]);
      pk[s][2] = dsrl_tail::pack_bf16(acc[2 * s + 1][0], acc[2 * s + 1][1]);
      pk[s][3] = dsrl_tail::pack_bf16(acc[2 * s + 1][2], acc[2 * s + 1][3]);
    }
  }
}

// Issues dX (64 x 24) = dlogits . W^T into dxa (three TF32 passes, small
// terms first, for float32 x).  The k8 step nt's A fragment is the lane's
// pairs (acc[nt][0], acc[nt][2]) as its column t and (acc[nt][1],
// acc[nt][3]) as its column t + 4.
template <typename T>
__device__ __forceinline__ void issue_dx_wgmma(float (&dxa)[3][4], const float (&acc)[kNT][4],
                                               const uint32_t (&lo)[sizeof(T) == 4 ? kNT : 1][4],
                                               const uint32_t (&pk)[kNPad / 16][4], uint64_t desc) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const uint64_t hi_b = desc + (uint64_t)(nt * DxTable<T>::kStep >> 4);
      const uint64_t lo_b = hi_b + (uint64_t)(DxTable<T>::kPlane >> 4);
      const uint32_t hi_a[4] = {__float_as_uint(acc[nt][0]), __float_as_uint(acc[nt][2]),
                                __float_as_uint(acc[nt][1]), __float_as_uint(acc[nt][3])};
      const uint32_t lo_a[4] = {lo[nt][0], lo[nt][2], lo[nt][1], lo[nt][3]};
      wgmma_n24_tf32(dxa, lo_a, hi_b, nt > 0);
      wgmma_n24_tf32(dxa, hi_a, lo_b, 1);
      wgmma_n24_tf32(dxa, hi_a, hi_b, 1);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kNPad / 16; ++s)
      wgmma_n24_bf16(dxa, pk[s], desc + (uint64_t)(s * DxTable<T>::kStep >> 4), s > 0);
  }
}

// Issues dW^T rows 0-63 += dlogits^T . X over the warpgroup's 64 pixels
// into dw, a k step per 8 (TF32; three passes) or 16 (bfloat16) pixels.
// stage: the descriptor of the staged dlogits; slab: of the warpgroup's
// first warp's first slab; slab_lo: of its lo plane; buf: the slab buffer
// of this tile.
template <typename T>
__device__ __forceinline__ void issue_dw_wgmma(float (&dw)[3][4], uint64_t stage, uint64_t slab,
                                               uint64_t slab_lo, int buf) {
  constexpr int kSteps = kWgM / (2 * DlStage<T>::kChunk);      // 8 or 4
  constexpr int kPerWarp = kWarpP / (2 * DlStage<T>::kChunk);  // k steps in a warp's slab: 2 or 1
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int w = j / kPerWarp, jj = j % kPerWarp;
    const uint64_t b_hi =
        slab + (uint64_t)(((2 * w + buf) * CoreSlab<T>::kBytes + 2 * jj * CoreSlab<T>::kLbo) >> 4);
    const uint64_t a_hi = stage + (uint64_t)((2 * j * kDlLbo) >> 4);
    if constexpr (sizeof(T) == 4) {
      const uint64_t a_lo = a_hi + (uint64_t)(DlStage<T>::kPlane >> 4);
      const uint64_t b_lo = slab_lo + (uint64_t)((w * CoreSlab<T>::kBytes + 2 * jj * CoreSlab<T>::kLbo) >> 4);
      wgmma_n24_ss<T>(dw, a_lo, b_hi);
      wgmma_n24_ss<T>(dw, a_hi, b_lo);
      wgmma_n24_ss<T>(dw, a_hi, b_hi);
    } else {
      wgmma_n24_ss<T>(dw, a_hi, b_hi);
    }
  }
}

// dW^T rows 64-79 (the logits columns of classes 16-19) += over the warp's
// own 16 pixels, on mma.sync (m16n8k8 3xTF32, 2 k steps; m16n8k16
// bfloat16, 1), into dwt[ct] (channels ct*8 to ct*8 + 7; rows g and g + 8
// of lane (g, t) are columns 64 + g and 72 + g): A from the warp's part of
// the staged dlogits, B from its slab (and lo plane), conflict-free.  The
// warps' sums are added at the end.
template <typename T>
__device__ __forceinline__ void tail_rows_dw(float (&dwt)[3][4], const unsigned char* stage, const T* slab,
                                             const T* slab_lo, int w4, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int kRow = kWgM / 8 * kDlSbo;     // byte of column 64 in a chunk
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const unsigned char* a = stage + (4 * w4 + 2 * s) * kDlLbo + kRow + 16 * g + 4 * t;
      const auto ld = [&](int off) { return *reinterpret_cast<const uint32_t*>(a + off); };
      constexpr int P = DlStage<T>::kPlane;
      const uint32_t a_hi[4] = {ld(0), ld(kDlSbo), ld(kDlLbo), ld(kDlLbo + kDlSbo)};
      const uint32_t a_lo[4] = {ld(P), ld(P + kDlSbo), ld(P + kDlLbo), ld(P + kDlLbo + kDlSbo)};
#pragma unroll
      for (int ct = 0; ct < 3; ++ct) {
        const int o = CoreSlab<T>::off(ct * 8 + g, 8 * s + t), o4 = o + CoreSlab<T>::kLbo / 4;
        const uint32_t b_hi[2] = {__float_as_uint(slab[o]), __float_as_uint(slab[o4])};
        const uint32_t b_lo[2] = {__float_as_uint(slab_lo[o]), __float_as_uint(slab_lo[o4])};
        dsrl_tail::mma_3xtf32(dwt[ct], a_hi, a_lo, b_hi, b_lo);
      }
    }
  } else {
    const unsigned char* a = stage + 2 * w4 * kDlLbo + kRow + 16 * g + 4 * t;
    const auto ld = [&](int off) { return *reinterpret_cast<const uint32_t*>(a + off); };
    const uint32_t a_bf[4] = {ld(0), ld(kDlSbo), ld(kDlLbo), ld(kDlLbo + kDlSbo)};
#pragma unroll
    for (int ct = 0; ct < 3; ++ct) {
      const T* b = slab + CoreSlab<T>::off(ct * 8 + g, 2 * t);
      const uint32_t b_bf[2] = {*reinterpret_cast<const uint32_t*>(b),
                                *reinterpret_cast<const uint32_t*>(b + CoreSlab<T>::kLbo / 2)};
      dsrl_tail::mma_bf16(dwt[ct], a_bf, b_bf);
    }
  }
}

// Stores a pixel pair's dX into channel plane position `d` (pixels 2g, 2g + 1).
__device__ __forceinline__ void store_pair(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* d, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);   // .x = a at the lower address
}

// Writes dX of a lane's pixels 2g and 2g + 1 (accumulator rows g and g +
// 8) for the real channels ct*8 + 2t + j: one pair store where the plane
// size is even (the pair then lies in one sample, aligned), else one store
// a pixel.
template <typename T>
__device__ __forceinline__ void store_dx(const dsrl_tail::TailWalk<T>& w, T* __restrict__ dx,
                                         const float (&dxa)[3][4]) {
  const int g = w.lane >> 2, t = w.lane & 3;
  const long long p = w.p0 + 2 * g;
  if (p >= w.npix) return;
  const dsrl_tail::PixelPos q0 = dsrl_tail::advance(w.pos, 2 * g, w.hw);
  T* d0 = dx + q0.b * kC * (long long)w.hw + q0.rem;
  if (w.hw % 2 == 0) {
#pragma unroll
    for (int ct = 0; ct < 3; ++ct)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ci = ct * 8 + 2 * t + j;
        if (ci < kC) store_pair(d0 + ci * (long long)w.hw, dxa[ct][j], dxa[ct][2 + j]);
      }
  } else {
    const dsrl_tail::PixelPos q1 = dsrl_tail::advance(q0, 1, w.hw);
    T* d1 = dx + q1.b * kC * (long long)w.hw + q1.rem;
    const bool second = p + 1 < w.npix;
#pragma unroll
    for (int ct = 0; ct < 3; ++ct)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ci = ct * 8 + 2 * t + j;
        if (ci < kC) {
          d0[ci * (long long)w.hw] = from_float<T>(dxa[ct][j]);
          if (second) d1[ci * (long long)w.hw] = from_float<T>(dxa[ct][2 + j]);
        }
      }
  }
}

template <typename T> struct BwdWalk : dsrl_tail::TailWalk<T> {
  T* s_xlo;                 // float32 x: the warp's lo plane
  unsigned char* stage;     // the warpgroup's staged dlogits
  float scale;
  int w4, bar;              // the warp's index in its warpgroup; the warpgroup's named barrier
  uint64_t desc_w, desc_wt, desc_stage, desc_slab, desc_lo;
};

// One backward step (see the design note at the top).  The slab of tile
// `w.tile` has been requested two steps before; at the end the slab two
// tiles ahead is requested into the buffer just used.  Returns whether a
// next tile exists.
template <typename T>
__device__ __forceinline__ bool bwd_step(BwdWalk<T>& w, T* __restrict__ dx, dsrl_tail::WgA<T>& a,
                                         float (&acc)[kNT][4], uint32_t (&lo)[sizeof(T) == 4 ? kNT : 1][4],
                                         uint32_t (&pk)[kNPad / 16][4], float (&dxa)[3][4],
                                         float (&dw)[2][3][4], float (&db)[kC]) {
  const bool more = w.tile + w.groups < w.ntiles;
  const int buf = w.it & 1;
  T* slab = w.s_x + buf * CoreSlab<T>::kElems;
  dsrl_tail::cp_async_wait<1>();
  __syncwarp();      // this tile's slab has landed
  if constexpr (sizeof(T) == 4) {
    split_slab(slab, w.s_xlo, w.lane);
    __syncwarp();
  }
  load_bwd_a<T>(slab, w.s_xlo, w.lane, a);
  dsrl_tail::wg_fence();
  dsrl_tail::issue_logits_wgmma<T>(acc, a, w.desc_w);
  dsrl_tail::wg_commit();
  dsrl_tail::wg_fence_acc(acc);
  const uint32_t labels_next = dsrl_tail::walk_pixel(w, 1).labels4;
  const int g = w.lane >> 2, t = w.lane & 3;
  const uint32_t lab0 = __shfl_sync(0xffffffffu, w.labels4, 2 * g);
  const uint32_t lab1 = __shfl_sync(0xffffffffu, w.labels4, 2 * g + 1);
  dsrl_tail::wg_wait<0>();
  dsrl_tail::wg_fence_acc(acc);
  // Lane (g, t) owns output position t of pixels 2g and 2g + 1.
  to_dlogits(dsrl_tail::lane_logits<0>(acc, w.s_b), (lab0 >> (8 * t)) & 0xff, w.p0 + 2 * g < w.npix, w.scale,
             w.ignore_label);
  to_dlogits(dsrl_tail::lane_logits<1>(acc, w.s_b), (lab1 >> (8 * t)) & 0xff, w.p0 + 2 * g + 1 < w.npix,
             w.scale, w.ignore_label);
#pragma unroll
  for (int co = 0; co < kC; ++co) db[co] += acc[co / 2][co % 2] + acc[co / 2][2 + co % 2];
  stage_dlogits<T>(acc, lo, pk, w.stage, w.w4, w.lane);
  dsrl_tail::wg_fence_proxy();
  named_barrier(w.bar);   // the warpgroup's staged dlogits and slabs are in place
  dsrl_tail::wg_fence();
  issue_dx_wgmma<T>(dxa, acc, lo, pk, w.desc_wt);
  dsrl_tail::wg_commit();
  issue_dw_wgmma<T>(dw[0], w.desc_stage, w.desc_slab, w.desc_lo, buf);
  dsrl_tail::wg_commit();
  dsrl_tail::wg_fence_acc(dxa);
  dsrl_tail::wg_fence_acc(dw[0]);
  dsrl_tail::wg_wait<1>();
  dsrl_tail::wg_fence_acc(dxa);
  store_dx<T>(w, dx, dxa);
  tail_rows_dw<T>(dw[1], w.stage, slab, w.s_xlo, w.w4, w.lane);
  dsrl_tail::wg_wait<0>();
  dsrl_tail::wg_fence_acc(dw[0]);
  named_barrier(w.bar);   // every warp's products are done with the slabs and the staging
  if (w.tile + 2 * w.groups < w.ntiles) dsrl_tail::load_slab<T, CoreSlab<T>>(w, slab, 2);
  dsrl_tail::cp_async_commit();
  dsrl_tail::advance_walk(w, labels_next);
  return more;
}

// partials: [gridDim.x][kRows][kCols] float64, row r < C = channel r of dW
// at column pos*C + co; row C = db at the same columns.
template <typename T>
__global__ void __launch_bounds__(BwdShape<T>::kThreads, 1)
fused_tail_bwd_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, const uint8_t* __restrict__ labels,
                      const float* __restrict__ scale_ptr, T* __restrict__ dx,
                      double* __restrict__ partials, int height, int width, long long npix,
                      int ignore_label) {
  using S = BwdSmem<T>;
  constexpr int kWG = BwdShape<T>::kWG;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);   // uniform over the warp
  const int wg = warp / 4, w4 = warp % 4;
  uint32_t* s_wb = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_wtb = reinterpret_cast<uint32_t*>(smem + S::kW);
  float* s_b = reinterpret_cast<float*>(smem + S::kW + S::kWT);
  unsigned char* s_xall = smem + S::kW + S::kWT + S::kB;   // [warp][2] slabs, then [warp] lo planes
  unsigned char* s_stage = s_xall + S::kX + S::kXLo;       // [warpgroup] staged dlogits

  // Zero the slabs (channels 19-23 stay zero: no load writes them); build
  // both B tables.
  for (int i = threadIdx.x; i < (S::kX + S::kXLo) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(s_xall)[i] = make_uint4(0u, 0u, 0u, 0u);
  dsrl_tail::load_wg_weights<T>(s_wb, s_b, weight, bias);
  dsrl_tail::fill_wg_table<T, DxTable<T>::kSteps, kDxGroups>(s_wtb, [&](int k, int ci) {
    const int n = dx_table_col<T>(k), co = dsrl_tail::col_class(n);
    return co < kC && ci < kC ? weight[(ci * kC + co) * 4 + dsrl_tail::col_pos(n)] : 0.f;
  });
  dsrl_tail::wg_fence_proxy();
  __syncthreads();   // the tables and the zeroed slabs

  BwdWalk<T> w;
  dsrl_tail::init_walk<T>(w, x, labels, reinterpret_cast<T*>(s_xall + warp * 2 * CoreSlab<T>::kBytes), s_b,
                          height, width, npix, ignore_label, kWG, warp, lane);
  w.s_xlo = reinterpret_cast<T*>(s_xall + S::kX + warp * CoreSlab<T>::kBytes);
  w.stage = s_stage + wg * DlStage<T>::kBytes;
  w.scale = *scale_ptr;
  w.w4 = w4;
  w.bar = 1 + wg;
  w.desc_w = dsrl_tail::wg_desc(s_wb);
  w.desc_wt = dsrl_tail::wg_desc(s_wtb);
  w.desc_stage = dsrl_tail::wg_desc(w.stage, kDlLbo, kDlSbo);
  w.desc_slab = dsrl_tail::wg_desc(s_xall + 4 * wg * 2 * CoreSlab<T>::kBytes, CoreSlab<T>::kLbo,
                                   CoreSlab<T>::kSbo);
  w.desc_lo = dsrl_tail::wg_desc(s_xall + S::kX + 4 * wg * CoreSlab<T>::kBytes, CoreSlab<T>::kLbo,
                                 CoreSlab<T>::kSbo);
  float dw[2][3][4], db[kC];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ct = 0; ct < 3; ++ct)
#pragma unroll
      for (int j = 0; j < 4; ++j) dw[mt][ct][j] = 0.f;
#pragma unroll
  for (int co = 0; co < kC; ++co) db[co] = 0.f;
  if (w.tile < w.ntiles) {   // uniform over the warpgroup
    dsrl_tail::start_walk<T, CoreSlab<T>>(w, w4);
    dsrl_tail::WgA<T> a;
    float acc[kNT][4], dxa[3][4];
    uint32_t lo[sizeof(T) == 4 ? kNT : 1][4], pk[kNPad / 16][4];
    while (bwd_step<T>(w, dx, a, acc, lo, pk, dxa, dw, db)) {
    }
  }
  dsrl_tail::cp_async_wait<0>();
  __syncthreads();   // every warpgroup is done with the staging: the reductions reuse it

  // Each warpgroup's dW^T rows 0-63 (dw[0]) and each warp's rows 64-79
  // (dw[1]), and each warp's db sums over its lanes g (a fixed tree of
  // shuffles), in the slabs' and the staging's place.
  float* s_dw = reinterpret_cast<float*>(s_xall);                 // [wg][64][24]
  float* s_dwt = s_dw + kWG * kWgM * 24;                          // [warp][16][24]
  double* s_db = reinterpret_cast<double*>(s_dwt + BwdShape<T>::kWarps * 16 * 24);   // [warp][t][C]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ct = 0; ct < 3; ++ct)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ci = ct * 8 + 2 * t + j, r = g + 8 * h;
        s_dw[(wg * kWgM + 16 * w4 + r) * 24 + ci] = dw[0][ct][2 * h + j];
        s_dwt[(warp * 16 + r) * 24 + ci] = dw[1][ct][2 * h + j];
      }
#pragma unroll
  for (int co = 0; co < kC; ++co) {
    double v = db[co];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (g == 0) s_db[(warp * 4 + t) * kC + co] = v;
  }
  __syncthreads();
  // The block's partial, float64, at column pos*C + co (logits column m).
  double* part = partials + (long long)blockIdx.x * kRows * kCols;
  for (int i = threadIdx.x; i < kC * kCols; i += blockDim.x) {
    const int ci = i / kCols, col = i - ci * kCols, pos = col / kC, co = col - pos * kC;
    const int m = 8 * (co / 2) + 2 * pos + co % 2;   // col_class(m) = co, col_pos(m) = pos
    double sum = 0.0;
    if (m < kWgM) {
#pragma unroll
      for (int k = 0; k < kWG; ++k) sum += (double)s_dw[(k * kWgM + m) * 24 + ci];
    } else {
#pragma unroll
      for (int k = 0; k < BwdShape<T>::kWarps; ++k) sum += (double)s_dwt[(k * 16 + m - kWgM) * 24 + ci];
    }
    part[i] = sum;
  }
  for (int i = threadIdx.x; i < kCols; i += blockDim.x) {
    const int pos = i / kC, co = i - pos * kC;
    double sum = 0.0;
    for (int k = 0; k < BwdShape<T>::kWarps; ++k) sum += s_db[(k * 4 + pos) * kC + co];
    part[kC * kCols + i] = sum;
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

template <typename T>
int fwd_grid(long long npix, int* grid) {
  const long long tiles = (npix + kWgM - 1) / kWgM;
  return dsrl_tail::persistent_grid(fused_tail_fwd_kernel<T>, FwdShape<T>::kThreads, FwdSmem<T>::kBytes,
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
  const long long tiles = (npix + kWgM - 1) / kWgM;
  return dsrl_tail::persistent_grid(fused_tail_bwd_kernel<T>, BwdShape<T>::kThreads, BwdSmem<T>::kBytes,
                         (tiles + BwdShape<T>::kWG - 1) / BwdShape<T>::kWG, grid);
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
  fused_tail_bwd_kernel<T><<<grid, BwdShape<T>::kThreads, BwdSmem<T>::kBytes, s>>>(
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

// The backward kernel's dynamic shared memory a block, in bytes (reported
// beside its registers).
int dsrl_fused_tail_bwd_smem(int dtype) {
  return dtype ? BwdSmem<__nv_bfloat16>::kBytes : BwdSmem<float>::kBytes;
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
