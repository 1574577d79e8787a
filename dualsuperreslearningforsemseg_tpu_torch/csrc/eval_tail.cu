// Fused eval tail for Hopper (sm_90a): final ConvTranspose2d(C, C, 2, 2) +
// bias, masked cross-entropy, first-max argmax and the mIoU/accuracy
// counts in one pass.  The (B, C, 2H, 2W) logits are never written.
//
// Replaces the Pallas TPU kernel `convt_cols_eval` / `_eval_kernel` in
// dualsuperreslearningforsemseg_tpu/ops/pallas/eval_tail.py (pallas_call at
// line 132).  What it computes, per output pixel with label `lab`:
//   logits   = ConvT(x) + bias         (for a bfloat16 x: the weight rounded
//              to bfloat16, float32 sums and bias, as `_tile_logits_t`)
//   pred     = first index of the max; C-1 if any logit is NaN
//   nll      = max + log(sum exp(logit - max)) - picked, where picked is
//              logits[lab] for lab < C and 0 for lab in [C, ignore)
//              (the shared `_ce_terms`, fused_tail.py:102-118); 0 if ignored
//   area_pred[pred], area_inter[pred] (if pred == lab), valid, correct:
//              over pixels whose label is not `ignore`
//   area_target[lab]: over labels < C
//
// Design: K1 forward's warpgroup walk (tail_common.cuh, `TailWalk`) with
// this kernel's epilogue.  A persistent grid, one block an SM of 4
// (float32 x) or 6 (bfloat16 x) warpgroups (`EvalShape`: as many as the
// registers allow), walks tiles of 64 consecutive pre-tail pixels,
// warpgroup i taking tiles i, i + all warpgroups, ...  Each warp of a
// warpgroup owns 16 pixels of its tiles: it loads their (C, 16) slab with
// cp.async two tiles ahead into a ring of two buffers, and their labels
// and class-map offsets one tile ahead into its two rows of shared memory
// (`WarpSmem`; registers are what limits the warpgroups).  The logits (64
// x 80) = X^T . W of a tile are one chain of `wgmma.mma_async`
// (`issue_logits_wgmma`: m64n80k8 TF32, 3 k steps x 3 passes for float32
// x; m64n80k16 bfloat16, 2 k steps for bfloat16 x), A from registers, B
// from the split or rounded weight table in shared memory.  While a
// tile's products run the warpgroup starts its next loads; then lane (g,
// t) adds the bias to its two output pixels (position t of pixels g and g
// + 8) and takes for each (`tally`): CE terms, argmax, the class map (each
// pair of output pixels of a row written as one 2-byte store by the left
// one, its right neighbour's class from a shuffle) and the counts, while
// the other warpgroups' products run.  Each warp counts into private
// shared-memory bins with plain shared atomics; at the end the block sums
// its warps' bins in a fixed order (`correct` and `valid` are sums of
// bins) and adds them with one 64-bit global atomic per count (integer
// counts: any order is exact), and writes its CE (float64, per-thread
// sums) to its own slot; a one-block pass sums the slots in a fixed
// order, so the CE is the same from run to run.
//
// Layout: x is NCHW float32 or bfloat16, contiguous; labels and the class
// map are (B, 2H, 2W) uint8, read and written as 2-byte pairs.  The TPU's
// channel-padded columns and g16 labels existed for its 128 lanes.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32, 989 bf16 on the tensor
// cores; 67 TFLOP/s FP32 off them), at the benchmark's batch of 16 (x
// 16x19x256x512 float32): it reads x (159.4 MB) and the labels (8.4 MB) and
// writes the class map (8.4 MB): 176 MB, 53 us; the 19x19 product is 6.06
// GFLOP, three TF32 passes: 37 us; the softmax, argmax and pick (~6 x 19
// operations per output pixel) 0.96 GOP of FP32: 14 us.  So it is bound by
// its bytes (a bfloat16 x: 96 MB, 29 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_common.cuh"

namespace {

using dsrl_tail::kC;
using dsrl_tail::kNT;
using dsrl_tail::kWarpP;
using dsrl_tail::kWgM;
constexpr int kBins = 3 * kC + 2;     // area_pred, area_inter, area_target, correct, valid
constexpr int kFinalThreads = 1024;
constexpr int kSlabElems = dsrl_tail::RowSlab<float>::kElems;   // a warp's (C, 16) slab

// The block: one an SM, of as many warpgroups as the registers allow
// (float32 x: 4 at 128 registers a thread; bfloat16 x, whose A fragments
// take 8 registers instead of 24: 6 at 80).
template <typename T> struct EvalShape {
  static constexpr int kWG = sizeof(T) == 4 ? 4 : 6;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kWarps = 4 * kWG;
};

// A warp's part of the block's shared memory, byte offsets from its first
// slab (each part a multiple of 16): its two slabs, the class-map offsets
// (long long) and the four labels (uint32) of its 16 pixels of two tiles,
// [tile & 1][pixel], and its bins: area_pred, area_inter and area_target
// (`correct` and `valid` are the sums of the first two, taken at the end).
// Everything the warp keeps in shared memory is found from one pointer.
template <typename T> struct WarpSmem {
  static constexpr int kOut = 2 * kSlabElems * (int)sizeof(T);
  static constexpr int kLab = kOut + 2 * kWarpP * 8;
  static constexpr int kHist = kLab + 2 * kWarpP * 4;
  static constexpr int kBytes = kHist + (3 * kC * 4 + 15) / 16 * 16;
};

template <typename T> __device__ __forceinline__ long long* warp_out(T* s_x) {
  return reinterpret_cast<long long*>(reinterpret_cast<unsigned char*>(s_x) + WarpSmem<T>::kOut);
}
template <typename T> __device__ __forceinline__ uint32_t* warp_labels(T* s_x) {
  return reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(s_x) + WarpSmem<T>::kLab);
}
template <typename T> __device__ __forceinline__ int* warp_bins(T* s_x) {
  return reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(s_x) + WarpSmem<T>::kHist);
}

// Shared memory of the kernel, in bytes: the wgmma B table first (its
// descriptors want 16-byte alignment), the bias, each warp's part.
template <typename T> struct EvalSmem {
  static constexpr int kW = dsrl_tail::WgTable<T>::kBytes;
  static constexpr int kB = 80;
  static constexpr int kBytes = kW + kB + EvalShape<T>::kWarps * WarpSmem<T>::kBytes;
};

template <typename T> struct EvalWalk : dsrl_tail::TailWalk<T> {
  uint8_t* pred;
  double ce;
};

// Keeps the class-map offset and labels of pixel p0 + lane % 16 of a tile
// in the warp's row `buf` (lanes l and l + 16 store the same values).
template <typename T>
__device__ __forceinline__ void keep_pixel(const EvalWalk<T>& w, int buf, const dsrl_tail::PixelInfo& info) {
  const int i = buf * kWarpP + (w.lane & (kWarpP - 1));
  warp_out(w.s_x)[i] = info.out0;
  warp_labels(w.s_x)[i] = info.labels4;
}

// The CE, class and counts of this lane's output pixel of row `Half`
// (position t of pixel p = g + 8*Half of the warp's 16 in the tile of row
// `buf`), from its logits in the accumulators; the class map is written
// by the kw = 0 lane of each pair.  Every lane of the warp calls it (a
// shuffle).  The CE is taken for every pixel and added where it is valid
// (adding 0.0 leaves the sum's bits as skipping would), so a lane's two
// pixels interleave.
template <int Half, typename T>
__device__ __forceinline__ void tally(EvalWalk<T>& w, float (&acc)[kNT][4], int buf, int p, int t) {
  const bool active = w.p0 + p < w.npix;
  const int lab = (warp_labels(w.s_x)[buf * kWarpP + p] >> (8 * t)) & 0xff;
  const dsrl_tail::LaneRow<Half> l = dsrl_tail::lane_logits<Half>(acc, w.s_b);
  const float m = dsrl_tail::row_max(l);
  const int cls = dsrl_tail::first_max(l, m);
  const float picked = dsrl_tail::picked_logit(l, lab);
  const bool valid = active && lab != w.ignore_label;
  const bool hit = valid && cls == lab;
  const float nll = dsrl_tail::ce_nll(m, dsrl_tail::exp_sum(l, m), picked);
  w.ce += valid ? (double)nll : 0.0;
  int* hist = warp_bins(w.s_x);
  if (valid) atomicAdd(&hist[cls], 1);
  if (hit) atomicAdd(&hist[kC + cls], 1);
  if (active && lab < kC) atomicAdd(&hist[2 * kC + lab], 1);
  const int right = __shfl_down_sync(0xffffffffu, cls, 1);   // kw = 1 of the same row
  if (!(t & 1) && active)
    *reinterpret_cast<uchar2*>(w.pred + warp_out(w.s_x)[buf * kWarpP + p] + (t >> 1) * 2LL * w.width) =
        make_uchar2((uint8_t)cls, (uint8_t)right);
}

// One step of the walk: the slab of tile `w.tile` has been requested two
// steps before.  Issues the tile's products, starts loading the slab two
// tiles ahead into the buffer just read and keeps the next tile's pixels
// while the tensor cores run, waits for the products and tallies the
// tile.  Returns whether a next tile exists.
template <typename T>
__device__ __forceinline__ bool eval_step(EvalWalk<T>& w, dsrl_tail::WgA<T>& a, float (&acc)[kNT][4],
                                          uint64_t desc) {
  const bool more = w.tile + w.groups < w.ntiles;
  const int cur = w.it & 1;
  T* slab = w.s_x + cur * kSlabElems;
  dsrl_tail::cp_async_wait<1>();
  __syncwarp();      // this tile's slab and pixels are in place
  dsrl_tail::load_wg_a<T>(slab, w.lane, a);
  __syncwarp();      // every lane has read the slab
  dsrl_tail::wg_fence();
  dsrl_tail::issue_logits_wgmma<T>(acc, a, desc);
  dsrl_tail::wg_commit();
  dsrl_tail::wg_fence_acc(acc);
  // The plane size as if new each step: ptxas otherwise hoists the slab
  // loads' 64-bit channel offsets (ci * hw) out of the walk and, at 128
  // registers (float32 x), spills them.
  asm volatile("" : "+r"(w.hw));
  if (w.tile + 2 * w.groups < w.ntiles) dsrl_tail::load_slab(w, slab, 2);
  dsrl_tail::cp_async_commit();
  keep_pixel(w, cur ^ 1, dsrl_tail::walk_pixel(w, 1));
  const int g = w.lane >> 2, t = w.lane & 3;
  dsrl_tail::wg_wait<0>();
  dsrl_tail::wg_fence_acc(acc);
  tally<0>(w, acc, cur, g, t);
  tally<1>(w, acc, cur, g + 8, t);
  dsrl_tail::advance_walk(w, 0u);   // the labels are in shared memory
  return more;
}

// counts layout: [area_pred(C), area_inter(C), area_target(C), correct, valid]
template <typename T>
__global__ void __launch_bounds__(EvalShape<T>::kThreads, 1)
eval_tail_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                 const float* __restrict__ bias, const uint8_t* __restrict__ labels,
                 uint8_t* __restrict__ pred, double* __restrict__ ce_partials,
                 unsigned long long* __restrict__ counts,
                 int height, int width, long long npix, int ignore_label) {
  using S = EvalSmem<T>;
  constexpr int kWarps = EvalShape<T>::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_ce[kWarps];
  const int lane = threadIdx.x & 31;
  // Shuffled from lane 0, so the compiler sees it uniform over the warp.
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  uint32_t* s_wb = reinterpret_cast<uint32_t*>(smem);
  float* s_b = reinterpret_cast<float*>(smem + S::kW);
  unsigned char* s_warps = smem + S::kW + S::kB;   // [warp] WarpSmem
  dsrl_tail::load_wg_weights<T>(s_wb, s_b, weight, bias);
  T* s_x = reinterpret_cast<T*>(s_warps + warp * WarpSmem<T>::kBytes);
  for (int i = lane; i < 3 * kC; i += 32) warp_bins(s_x)[i] = 0;
  dsrl_tail::wg_fence_proxy();
  __syncthreads();   // the weights and the zeroed bins

  EvalWalk<T> w;
  dsrl_tail::init_walk<T>(w, x, labels, s_x, s_b, height, width, npix, ignore_label, EvalShape<T>::kWG, warp,
                          lane);
  w.pred = pred;
  w.ce = 0.0;
  if (w.tile < w.ntiles) {   // uniform over the warpgroup
    keep_pixel(w, 0, dsrl_tail::start_walk<T>(w, warp % 4));
    // A's fragments and the accumulators live across the steps, as in K1.
    dsrl_tail::WgA<T> a;
    float acc[kNT][4];
    const uint64_t desc = dsrl_tail::wg_desc(s_wb);
    while (eval_step<T>(w, a, acc, desc)) {
    }
  }
  dsrl_tail::cp_async_wait<0>();

  const double ce_w = dsrl_tail::warp_sum(w.ce);
  if (lane == 0) s_ce[warp] = ce_w;
  __syncthreads();
  // Each count summed over the warps' bins in a fixed order (integers: any
  // order is exact): `correct` over the area_inter bins, `valid` over the
  // area_pred bins; one 64-bit global atomic a count.
  if (threadIdx.x < kBins) {
    const int first = threadIdx.x < 3 * kC ? threadIdx.x : threadIdx.x == 3 * kC ? kC : 0;
    const int n = threadIdx.x < 3 * kC ? 1 : kC;
    unsigned long long v = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int* bins = warp_bins(reinterpret_cast<T*>(s_warps + k * WarpSmem<T>::kBytes));
      for (int j = 0; j < n; ++j) v += (unsigned long long)bins[first + j];
    }
    if (v) atomicAdd(&counts[threadIdx.x], v);
  }
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += s_ce[k];
    ce_partials[blockIdx.x] = t;
  }
}

// One block: sums the per-block CE partials in a fixed order.
__global__ void __launch_bounds__(kFinalThreads)
sum_partials_kernel(const double* __restrict__ partials, long long n, double* __restrict__ out) {
  __shared__ double s[kFinalThreads];
  double t = 0.0;
  for (long long i = threadIdx.x; i < n; i += kFinalThreads) t += partials[i];
  s[threadIdx.x] = t;
  __syncthreads();
  for (int stride = kFinalThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

template <typename T>
int eval_grid(long long npix, int* grid) {
  const long long tiles = (npix + kWgM - 1) / kWgM;
  return dsrl_tail::persistent_grid(eval_tail_kernel<T>, EvalShape<T>::kThreads, EvalSmem<T>::kBytes,
                                    (tiles + EvalShape<T>::kWG - 1) / EvalShape<T>::kWG, grid);
}

template <typename T>
int launch(const void* x, const float* weight, const float* bias, const uint8_t* labels,
           uint8_t* pred, double* ce_partials, int grid, double* ce_sum, long long* counts,
           int batch, int height, int width, int ignore_label, cudaStream_t s) {
  const long long npix = (long long)batch * height * width;
  int expected = 0;
  const int err0 = eval_grid<T>(npix, &expected);
  if (err0) return err0;
  if (grid != expected) return (int)cudaErrorInvalidValue;   // partials sized for another grid
  eval_tail_kernel<T><<<grid, EvalShape<T>::kThreads, EvalSmem<T>::kBytes, s>>>(
      static_cast<const T*>(x), weight, bias, labels, pred, ce_partials,
      reinterpret_cast<unsigned long long*>(counts), height, width, npix, ignore_label);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kFinalThreads, 0, s>>>(ce_partials, grid, ce_sum);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dsrl_eval_tail_classes() { return kC; }

// dtype: 0 = float32 x, 1 = bfloat16 x.  Writes the fixed grid for npix
// pre-tail pixels to *grid (the wrapper sizes the CE partials with it);
// returns a CUDA error code (0 = ok).
int dsrl_eval_tail_grid(int dtype, long long npix, int* grid) {
  return dtype ? eval_grid<__nv_bfloat16>(npix, grid) : eval_grid<float>(npix, grid);
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 = ok).
// ce_partials holds `grid` doubles (dsrl_eval_tail_grid); counts (3*C + 2)
// int64 must be zero on entry.
int dsrl_eval_tail(int dtype, const void* x, const float* weight, const float* bias,
                   const uint8_t* labels, uint8_t* pred, double* ce_partials, int grid,
                   double* ce_sum, long long* counts, int batch, int height, int width,
                   int ignore_label, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch<__nv_bfloat16>(x, weight, bias, labels, pred, ce_partials, grid, ce_sum,
                                       counts, batch, height, width, ignore_label, s)
               : launch<float>(x, weight, bias, labels, pred, ce_partials, grid, ce_sum, counts,
                               batch, height, width, ignore_label, s);
}

}  // extern "C"
