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
// Design: the skeleton of the train tail's backward (fused_tail.cu), from
// tail_common.cuh.  A persistent grid (the SM count times the blocks the
// occupancy allows per SM) walks tiles of 128 consecutive pre-tail pixels,
// block i taking tiles i, i + grid, ...  Each of the 8 warps owns 16 pixels
// of a tile and works on them alone, meeting the other warps only at the
// end: it loads their (C, 16) activation slab with cp.async into one of its
// two shared buffers while it computes on the other, loads their labels
// and class-map offsets into registers one tile ahead, runs the logits (16
// x 80) = X^T . W on the tensor cores (`tile_logits_mma`: 3xTF32 for
// float32 x, one bfloat16 pass for bfloat16 x), whose columns are ordered
// so that each lane ends with the logits of two whole output pixels in its
// accumulators (tail_common.cuh, `col_pos`); each lane then takes for its
// two output pixels: CE terms, argmax, the class map (each pair of output pixels of a
// row written as one 2-byte store by the left one, its right neighbour's
// class from a shuffle) and the counts.  Each warp counts into private
// shared-memory bins with plain shared atomics; at the end the block sums
// its warps' bins and adds them with one 64-bit global atomic per bin
// (integer counts: any order is exact), and writes its CE (float64,
// per-thread sums) to its own slot; a one-block pass sums the slots in a
// fixed order, so the CE is the same from run to run.
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
using dsrl_tail::kThreads;
using dsrl_tail::kTileP;
using dsrl_tail::kWarpP;
using dsrl_tail::kWarps;
constexpr int kBins = 3 * kC + 2;     // area_pred, area_inter, area_target, correct, valid
constexpr int kFinalThreads = 1024;

// Shared memory of the kernel, in bytes (each part a multiple of 16).
template <typename T> struct EvalSmem {
  static constexpr int kSlab = kC * dsrl_tail::kSlabStride * (int)sizeof(T);   // one warp's slab
  static constexpr int kX = kWarps * 2 * kSlab;               // two slabs per warp
  static constexpr int kW = dsrl_tail::b_table_words<T>(dsrl_tail::LogitsK<T>::kPad, dsrl_tail::kSW) * 4;
  static constexpr int kB = 80;                               // bias per class (20 floats)
  static constexpr int kLab = kWarps * 2 * kWarpP * 4;        // labels, two parts per warp
  static constexpr int kOut = kWarps * 2 * kWarpP * 8;        // class-map offsets, two per warp
  static constexpr int kHist = (kWarps * kBins * 4 + 15) / 16 * 16;   // per-warp bins
  static constexpr int kBytes = kX + kW + kB + kLab + kOut + kHist;
};

// The CE, class and counts of one output pixel (pixel p of the warp's
// part, position t) from its logits row; the class map is written by the
// kw = 0 lane of each pair.  Every lane of the warp calls it (a shuffle).
template <typename Row>
__device__ __forceinline__ void tally(const Row& l, int p, int t, int cur, long long p0, long long npix,
                                      int ignore_label, const uint32_t* s_lab, const long long* s_out,
                                      long long out_w, int* hist, uint8_t* __restrict__ pred, double& ce,
                                      int& n_valid, int& n_correct) {
  const bool active = p0 + p < npix;
  const int lab = (s_lab[cur * kWarpP + p] >> (8 * t)) & 0xff;
  const float m = dsrl_tail::row_max(l);
  const int cls = dsrl_tail::first_max(l, m);
  const bool valid = active && lab != ignore_label;
  const bool hit = valid && cls == lab;
  if (valid) {
    const float picked = dsrl_tail::picked_logit(l, lab);
    ce += (double)dsrl_tail::ce_nll(m, dsrl_tail::exp_sum(l, m), picked);
  }
  n_valid += valid;
  n_correct += hit;
  if (valid) atomicAdd(&hist[cls], 1);
  if (hit) atomicAdd(&hist[kC + cls], 1);
  if (active && lab < kC) atomicAdd(&hist[2 * kC + lab], 1);
  const int right = __shfl_down_sync(0xffffffffu, cls, 1);   // kw = 1 of the same row
  if (!(t & 1) && active)
    *reinterpret_cast<uchar2*>(pred + s_out[cur * kWarpP + p] + (t >> 1) * out_w) =
        make_uchar2((uint8_t)cls, (uint8_t)right);
}

// counts layout: [area_pred(C), area_inter(C), area_target(C), correct, valid]
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
eval_tail_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                 const float* __restrict__ bias, const uint8_t* __restrict__ labels,
                 uint8_t* __restrict__ pred, double* __restrict__ ce_partials,
                 unsigned long long* __restrict__ counts,
                 int height, int width, long long npix, int ignore_label) {
  using S = EvalSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_ce[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // This warp's slabs, logits, labels and class-map offsets.
  T* s_x = reinterpret_cast<T*>(smem + warp * 2 * S::kSlab);
  uint32_t* s_wb = reinterpret_cast<uint32_t*>(smem + S::kX);    // logits' B table
  float* s_b = reinterpret_cast<float*>(smem + S::kX + S::kW);
  uint32_t* s_lab = reinterpret_cast<uint32_t*>(smem + S::kX + S::kW + S::kB) + warp * 2 * kWarpP;
  long long* s_out = reinterpret_cast<long long*>(smem + S::kX + S::kW + S::kB + S::kLab) +
                     warp * 2 * kWarpP;
  int* hist = reinterpret_cast<int*>(smem + S::kX + S::kW + S::kB + S::kLab + S::kOut) +
              warp * kBins;

  const unsigned hw = (unsigned)height * (unsigned)width;
  const long long out_w = 2LL * width;
  const long long ntiles = (npix + kTileP - 1) / kTileP;
  const unsigned stride = gridDim.x * kTileP;   // pixels from one of the block's tiles to the next

  dsrl_tail::load_tile_weights<T>(s_wb, s_b, weight, bias);
  for (int i = lane; i < kBins; i += 32) hist[i] = 0;
  // Each warp walks its 16-pixel part of the block's tiles on its own: it
  // loads, multiplies and reduces only its pixels, so after the weights it
  // meets the other warps only at the end.
  long long tile = blockIdx.x;
  long long p0 = tile * kTileP + warp * kWarpP;
  dsrl_tail::PixelPos pos = dsrl_tail::pixel_pos(p0, hw);
  dsrl_tail::load_x_part<T>(s_x, x, p0, pos, npix, hw, lane);
  dsrl_tail::cp_async_commit();
  if (lane < kWarpP) {
    const dsrl_tail::PixelInfo info =
        dsrl_tail::pixel_info(labels, p0 + lane, dsrl_tail::advance(pos, lane, hw), npix, width, hw);
    s_lab[lane] = info.labels4;
    s_out[lane] = info.out0;
  }
  __syncthreads();   // the weights

  double ce = 0.0;
  int n_valid = 0, n_correct = 0;
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int cur = it & 1;
    const bool more = tile + gridDim.x < ntiles;
    const long long p0_next = p0 + stride;
    const dsrl_tail::PixelPos pos_next = dsrl_tail::advance(pos, stride, hw);
    __syncwarp();      // the warp is done with the other buffers (its previous part)
    if (more) dsrl_tail::load_x_part<T>(s_x + (cur ^ 1) * kC * dsrl_tail::kSlabStride, x, p0_next,
                                        pos_next, npix, hw, lane);
    dsrl_tail::cp_async_commit();
    dsrl_tail::PixelInfo info_next = {0, 0, 0u};
    if (lane < kWarpP && more)
      info_next = dsrl_tail::pixel_info(labels, p0_next + lane, dsrl_tail::advance(pos_next, lane, hw),
                                        npix, width, hw);
    dsrl_tail::cp_async_wait<1>();
    __syncwarp();      // this part's slab has landed
    float acc[dsrl_tail::kNT][4];
    dsrl_tail::tile_logits_mma<T>(s_x + cur * kC * dsrl_tail::kSlabStride, s_wb, lane, acc);
    // Lane (g, t) owns output position t (kh = t / 2, kw = t % 2) of pixels
    // g and g + 8: its logits are in its accumulators.
    const int g = lane >> 2, t = lane & 3;
    tally(dsrl_tail::lane_logits<0>(acc, s_b), g, t, cur, p0, npix, ignore_label, s_lab, s_out, out_w,
          hist, pred, ce, n_valid, n_correct);
    tally(dsrl_tail::lane_logits<1>(acc, s_b), g + 8, t, cur, p0, npix, ignore_label, s_lab, s_out, out_w,
          hist, pred, ce, n_valid, n_correct);
    if (lane < kWarpP && more) {
      s_lab[(cur ^ 1) * kWarpP + lane] = info_next.labels4;
      s_out[(cur ^ 1) * kWarpP + lane] = info_next.out0;
    }
    p0 = p0_next;
    pos = pos_next;
  }
  dsrl_tail::cp_async_wait<0>();

  const double ce_w = dsrl_tail::warp_sum(ce);
  const int correct_w = dsrl_tail::warp_sum(n_correct);
  const int valid_w = dsrl_tail::warp_sum(n_valid);
  if (lane == 0) {
    s_ce[warp] = ce_w;
    atomicAdd(&hist[3 * kC], correct_w);
    atomicAdd(&hist[3 * kC + 1], valid_w);
  }
  __syncthreads();
  const int* s_hist = reinterpret_cast<const int*>(smem + S::kX + S::kW + S::kB + S::kLab + S::kOut);
  if (tid < kBins) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_hist[w * kBins + tid];
    if (v) atomicAdd(&counts[tid], (unsigned long long)v);
  }
  if (tid == 0) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_ce[w];
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
  const int smem = EvalSmem<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(eval_tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(eval_tail_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eval_tail_kernel<T>, kThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (npix + kTileP - 1) / kTileP;
  const long long full = (long long)sms * per_sm;
  *grid = (int)(ntiles < full ? ntiles : full);
  return 0;
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
  eval_tail_kernel<T><<<grid, kThreads, EvalSmem<T>::kBytes, s>>>(
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
