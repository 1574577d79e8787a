// Fused train tail for Hopper (sm_90a): final ConvTranspose2d(C, C, 2, 2) +
// bias + masked cross-entropy, forward and backward, without writing the
// (B, C, 2H, 2W) logits.
//
// Replaces the Pallas TPU kernels of `convt_cols_ce_sum` in
// dualsuperreslearningforsemseg_tpu/ops/pallas/fused_tail.py: `_fwd_kernel`
// (pallas_call at line 218, in `_fwd_impl`) and `_bwd_kernel` (pallas_call
// at line 251, in `_vjp_bwd`).  The per-pixel logits and CE terms come from
// tail_common.cuh, shared with the eval tail (eval_tail.cu).
//
// Forward: (ce_sum, count) = (sum of the NLL over valid output pixels,
// number of valid output pixels).  One thread per pre-tail pixel (b, h, w),
// consecutive threads along w (coalesced channel loads), the 4 x C logits in
// registers; each block writes its CE sum (float64) and count to its own
// slot and a one-block pass sums the slots in a fixed order, so the result
// is the same from run to run.
//
// Backward, given `scale` = the cotangent of ce_sum as a device scalar (no
// host sync): per output pixel dlogits = (softmax - onehot) * scale * valid,
//   dX[ci]          = sum_{pos, co} dlogits[pos, co] * W[ci, co, pos]
//   dW[ci, co, pos] = sum_pixels x[ci] * dlogits[pos, co]
//   db[co]          = sum_pixels sum_pos dlogits[pos, co]
// dX is written in x's dtype.  dW and db are reduced without float
// atomics, in a fixed order, so two launches on the same inputs give
// bit-identical results: a fixed grid of blocks (one per SM) walks tiles of
// 256 pixels, block i taking tiles i, i + grid, ...  For each tile a thread
// per pixel recomputes the logits, writes dX and stages x (plus a row of
// ones, which turns db into one more row of the same product) and the 76
// dlogits of its pixel in shared memory; then 240 threads, one per
// (pixel slice, row), add the tile's share of the (20 x 76) product to
// their running sums, kept in shared memory between tiles and in registers
// within one.  At the end each block sums its 12 slices in float64 into its
// own partial (1520 doubles; 1.6 MB for 132 blocks, not one partial per
// tile), and a one-block pass sums the partials over blocks in float64.
//
// Layout: x is NCHW (float32 or bfloat16), contiguous, as the model gives
// it; labels are (B, 2H, 2W) uint8, read as 2-byte pairs.  The TPU kernel's
// 128-column carry, block-diagonal (512, 128) weight and g16 labels existed
// for its 128 lanes and are not carried over.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 off the tensor cores)
// at the stage-1 recipe (x 8x19x256x512 float32, 4.19 M output pixels):
//   forward: reads x (79.7 MB) and the labels (4.2 MB): 25 us; 4.19 M x
//     (2*19*19 + 6*19) = 836 ops per output pixel = 3.5 GOP: 52 us.
//   backward: reads x and the labels, writes dX: 163.6 MB, 49 us; per output
//     pixel the logits, dX and dW products (3 x 722 flops) and the softmax
//     (~6 x 19): ~2,300 ops, 9.6 GOP: 0.14 ms.
// Both are bound by FP32 arithmetic on the CUDA cores.  This first design
// keeps every product in FP32 FMAs; tensor cores (mma/wgmma for the 19x19
// products) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_common.cuh"

namespace {

using dsrl_tail::kC;
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kBwdThreads = 256;                // = pixels per tile
constexpr int kRows = kC + 1;                   // x channels and a row of ones (db)
constexpr int kCols = 4 * kC;                   // (output position, class)
constexpr int kGroups = kBwdThreads / kRows;    // pixel slices of the contraction: 12
// x and dlogits tiles, and the contraction threads' running sums: 171,264
constexpr int kBwdSmemBytes = (kBwdThreads * (kRows + kCols) + kGroups * kRows * kCols) * 4;
constexpr int kFinalThreads = 1024;
static_assert(kCols % 4 == 0, "dlogits rows are read as float4");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// Where pre-tail pixel p lives: its sample, its offset in a channel plane,
// and the first label byte of its 2x2 output block.
struct Pixel {
  long long b, rem, out0;
};

__device__ __forceinline__ Pixel locate(long long p, int height, int width) {
  const long long hw = (long long)height * width;
  Pixel px;
  px.b = p / hw;
  px.rem = p - px.b * hw;
  const long long h = px.rem / width, w = px.rem - h * width;
  px.out0 = px.b * 4 * hw + 2 * h * (2LL * width) + 2 * w;
  return px;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
fused_tail_fwd_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, const uint8_t* __restrict__ labels,
                      double* __restrict__ ce_partials, long long* __restrict__ cnt_partials,
                      int height, int width, long long npix, int ignore_label) {
  __shared__ dsrl_tail::TailParams s_p;
  __shared__ double s_ce[kFwdWarps];
  __shared__ int s_cnt[kFwdWarps];
  dsrl_tail::load_tail_params(s_p, weight, bias);
  __syncthreads();

  const long long p = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
  const bool active = p < npix;
  const Pixel px = locate(active ? p : 0, height, width);
  const long long hw = (long long)height * width;
  const long long out_w = 2LL * width;

  float xv[kC];
  {
    const T* xp = x + px.b * kC * hw + px.rem;
#pragma unroll
    for (int ci = 0; ci < kC; ++ci) xv[ci] = active ? to_float(xp[ci * hw]) : 0.f;
  }
  float ce = 0.f;
  int n_valid = 0;
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    uchar2 lab2 = make_uchar2(0, 0);
    if (active) lab2 = *reinterpret_cast<const uchar2*>(labels + px.out0 + kh * out_w);
#pragma unroll
    for (int kw = 0; kw < 2; ++kw) {
      const int lab = kw ? lab2.y : lab2.x;
      float l[kC];
      dsrl_tail::tail_logits(xv, s_p, kh * 2 + kw, l);
      const bool valid = active && lab != ignore_label;
      if (valid) ce += dsrl_tail::ce_nll(dsrl_tail::ce_terms(l, lab));
      n_valid += valid;
    }
  }
  const double ce_w = dsrl_tail::warp_sum((double)ce);
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
    for (int i = 0; i < kFwdWarps; ++i) {
      t += s_ce[i];
      n += s_cnt[i];
    }
    ce_partials[blockIdx.x] = t;
    cnt_partials[blockIdx.x] = n;
  }
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

// partials: [gridDim.x][kRows][kCols] float64, row r < C = channel r of dW
// at column pos*C + co; row C = db at the same columns.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
fused_tail_bwd_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, const uint8_t* __restrict__ labels,
                      const float* __restrict__ scale_ptr, T* __restrict__ dx,
                      double* __restrict__ partials, int height, int width, long long npix,
                      int ignore_label) {
  extern __shared__ __align__(16) float s_dyn[];
  float* s_x = s_dyn;                                  // [kBwdThreads][kRows]
  float* s_dl = s_x + kBwdThreads * kRows;             // [kBwdThreads][kCols]
  float* s_acc = s_dl + kBwdThreads * kCols;           // [kGroups * kRows][kCols]
  __shared__ dsrl_tail::TailParams s_p;
  dsrl_tail::load_tail_params(s_p, weight, bias);

  const int tid = threadIdx.x;
  const int g = tid / kRows, r = tid - g * kRows;   // contraction role
  const bool contracts = g < kGroups;
  const float scale = *scale_ptr;
  const long long hw = (long long)height * width;
  const long long out_w = 2LL * width;
  const long long ntiles = (npix + kBwdThreads - 1) / kBwdThreads;
  if (contracts) {
    for (int j = 0; j < kCols; ++j) s_acc[tid * kCols + j] = 0.f;
  }
  __syncthreads();

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // Pixel phase: one thread per pixel.
    const long long p = tile * kBwdThreads + tid;
    const bool active = p < npix;
    const Pixel px = locate(active ? p : 0, height, width);
    float xv[kC];
    {
      const T* xp = x + px.b * kC * hw + px.rem;
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) xv[ci] = active ? to_float(xp[ci * hw]) : 0.f;
    }
#pragma unroll
    for (int ci = 0; ci < kC; ++ci) s_x[tid * kRows + ci] = xv[ci];
    s_x[tid * kRows + kC] = 1.f;
    float dxv[kC];
#pragma unroll
    for (int ci = 0; ci < kC; ++ci) dxv[ci] = 0.f;
#pragma unroll 1
    for (int kpos = 0; kpos < 4; ++kpos) {
      const int kh = kpos >> 1, kw = kpos & 1;
      const int lab = active ? labels[px.out0 + kh * out_w + kw] : 0;
      float l[kC];
      dsrl_tail::tail_logits(xv, s_p, kpos, l);
      const dsrl_tail::CeTerms t = dsrl_tail::ce_terms(l, lab);
      const bool valid = active && lab != ignore_label;
#pragma unroll
      for (int co = 0; co < kC; ++co) {
        const float d = valid ? (expf(l[co] - t.m) / t.z - (co == lab ? 1.f : 0.f)) * scale : 0.f;
        s_dl[tid * kCols + kpos * kC + co] = d;
        dsrl_tail::axpy_row(d, s_p.wt[kpos][co], dxv);
      }
    }
    if (active) {
      T* dp = dx + px.b * kC * hw + px.rem;
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) dp[ci * hw] = from_float<T>(dxv[ci]);
    }
    __syncthreads();
    // Contraction phase: thread (g, r) adds x[r] * dlogits[:] of the pixels
    // g, g + kGroups, ... of the tile, in that order, to its running sums.
    if (contracts) {
      float acc[kCols];
      float4* a4 = reinterpret_cast<float4*>(s_acc + tid * kCols);
#pragma unroll
      for (int j = 0; j < kCols / 4; ++j) {
        const float4 v = a4[j];
        acc[4 * j] = v.x; acc[4 * j + 1] = v.y; acc[4 * j + 2] = v.z; acc[4 * j + 3] = v.w;
      }
      for (int t = g; t < kBwdThreads; t += kGroups) {
        const float xr = s_x[t * kRows + r];
        const float4* d4 = reinterpret_cast<const float4*>(s_dl + t * kCols);
#pragma unroll
        for (int j = 0; j < kCols / 4; ++j) {
          const float4 v = d4[j];
          acc[4 * j + 0] = fmaf(xr, v.x, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(xr, v.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xr, v.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xr, v.w, acc[4 * j + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols / 4; ++j)
        a4[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncthreads();
  }

  // The block's partial: its kGroups slices summed in order, in float64.
  for (int o = tid; o < kRows * kCols; o += kBwdThreads) {
    double t = 0.0;
    for (int gg = 0; gg < kGroups; ++gg) t += (double)s_acc[gg * kRows * kCols + o];
    partials[(long long)blockIdx.x * kRows * kCols + o] = t;
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
int launch_fwd(const void* x, const float* weight, const float* bias, const uint8_t* labels,
               double* ce_partials, long long* cnt_partials, double* ce_sum, long long* count,
               int batch, int height, int width, int ignore_label, cudaStream_t s) {
  const long long npix = (long long)batch * height * width;
  const long long blocks = (npix + kFwdThreads - 1) / kFwdThreads;
  fused_tail_fwd_kernel<T><<<(unsigned)blocks, kFwdThreads, 0, s>>>(
      static_cast<const T*>(x), weight, bias, labels, ce_partials, cnt_partials, height, width,
      npix, ignore_label);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_sum_kernel<<<1, kFinalThreads, 0, s>>>(ce_partials, cnt_partials, blocks, ce_sum, count);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_grid(long long npix, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(fused_tail_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_tail_bwd_kernel<T>,
                                                           kBwdThreads, kBwdSmemBytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (npix + kBwdThreads - 1) / kBwdThreads;
  const long long full = (long long)sms * per_sm;
  *grid = (int)(ntiles < full ? ntiles : full);
  return 0;
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
  fused_tail_bwd_kernel<T><<<grid, kBwdThreads, kBwdSmemBytes, s>>>(
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
int dsrl_fused_tail_fwd_threads() { return kFwdThreads; }
int dsrl_fused_tail_partial_size() { return kRows * kCols; }

// dtype: 0 = float32 x, 1 = bfloat16 x.  Writes the fixed backward grid for
// npix pre-tail pixels to *grid (the wrapper sizes the partials with it);
// returns a CUDA error code (0 = ok).
int dsrl_fused_tail_bwd_grid(int dtype, long long npix, int* grid) {
  return dtype ? bwd_grid<__nv_bfloat16>(npix, grid) : bwd_grid<float>(npix, grid);
}

// Both passes on `stream`.  ce_partials and cnt_partials hold
// ceil(B*H*W / fwd_threads) slots; returns cudaGetLastError() (0 = ok).
int dsrl_fused_tail_fwd(int dtype, const void* x, const float* weight, const float* bias,
                        const uint8_t* labels, double* ce_partials, long long* cnt_partials,
                        double* ce_sum, long long* count, int batch, int height, int width,
                        int ignore_label, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_fwd<__nv_bfloat16>(x, weight, bias, labels, ce_partials, cnt_partials,
                                           ce_sum, count, batch, height, width, ignore_label, s)
               : launch_fwd<float>(x, weight, bias, labels, ce_partials, cnt_partials, ce_sum,
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
