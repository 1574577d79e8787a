// Fused eval tail for Hopper (sm_90a): final ConvTranspose2d(C, C, 2, 2) +
// bias, masked cross-entropy, first-max argmax and the mIoU/accuracy
// counts in one pass.  The (B, C, 2H, 2W) logits are never written.
//
// Replaces the Pallas TPU kernel `convt_cols_eval` / `_eval_kernel` in
// dualsuperreslearningforsemseg_tpu/ops/pallas/eval_tail.py (pallas_call at
// line 132).  What it computes, per output pixel with label `lab`:
//   logits   = ConvT(x) + bias                         (C values, registers)
//   pred     = first index of the max; C-1 if any logit is NaN
//   nll      = max + log(sum exp(logit - max)) - picked, where picked is
//              logits[lab] for lab < C and 0 for lab in [C, ignore)
//              (the shared `_ce_terms`, fused_tail.py:102-118); 0 if ignored
//   area_pred[pred], area_inter[pred] (if pred == lab), valid, correct:
//              over pixels whose label is not `ignore`
//   area_target[lab]: over labels < C
// The TPU kernel carries its sums from grid step to grid step in order and
// counts in f32; here blocks run in no order, so each block reduces its own
// counts (shared-memory integer atomics, warp-aggregated) and adds them with
// one 64-bit global atomic per bin, and writes its CE partial to its own slot;
// a second one-block pass sums the partials in a fixed order (float64), so
// the CE is the same from run to run.
//
// The per-pixel logits and CE terms come from tail_common.cuh, shared with
// the train tail (fused_tail.cu).
//
// Layout: x is NCHW float32, contiguous; one thread per pre-tail pixel
// (b, h, w), consecutive threads along w, so the C channel loads of a warp
// are coalesced.  Each thread writes the 2x2 output block it owns: labels
// and the class map are read/written as 2-byte pairs per output row.  The
// 2x2xCxC weights (5.8 KB) and the bias live in shared memory; every thread
// of a warp reads the same word (broadcast).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 off the tensor cores),
// at the benchmark's batch of 16 (x 16x19x256x512): it reads x (159.4 MB)
// and the labels (8.4 MB) and writes the class map (8.4 MB): 176 MB, 53 us;
// it does 8.4 M output pixels x (2*19*19 FMA flops + 6*19 softmax/argmax/
// pick operations) = 836 ops each, 7.0 GOP, 105 us.  So it is bound by
// FP32 arithmetic on the CUDA cores (the TPU version ran the ConvT on the
// MXU); this first design keeps the product in FP32 FMAs for exactness and
// leaves tensor-core (TF32/wgmma) variants to later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tail_common.cuh"

namespace {

using dsrl_tail::kC;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFinalThreads = 1024;

// Adds 1 to hist[bin] for every lane where `on`, with one shared atomic per
// distinct bin in the warp.  Every lane of the warp must call it.
__device__ __forceinline__ void warp_hist_add(int* hist, int bin, bool on) {
  const unsigned members = __ballot_sync(0xffffffffu, on);
  if (on) {
    const unsigned peers = __match_any_sync(members, bin);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
  }
}

// counts layout: [area_pred(C), area_inter(C), area_target(C), correct, valid]
__global__ void __launch_bounds__(kThreads)
eval_tail_kernel(const float* __restrict__ x, const float* __restrict__ weight,
                 const float* __restrict__ bias, const uint8_t* __restrict__ labels,
                 uint8_t* __restrict__ pred, double* __restrict__ ce_partials,
                 unsigned long long* __restrict__ counts,
                 int height, int width, long long npix, int ignore_label) {
  __shared__ dsrl_tail::TailParams s_p;
  __shared__ int s_hist[3][kC];
  __shared__ int s_cnt[2];           // correct, valid
  __shared__ double s_ce[kWarps];

  dsrl_tail::load_tail_params(s_p, weight, bias);
  if (threadIdx.x < 3 * kC) (&s_hist[0][0])[threadIdx.x] = 0;
  if (threadIdx.x < 2) s_cnt[threadIdx.x] = 0;
  __syncthreads();

  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool active = p < npix;
  const long long hw = (long long)height * width;
  const long long b = active ? p / hw : 0;
  const long long rem = active ? p - b * hw : 0;
  const long long h = rem / width, w = rem - h * width;
  const long long out_w = 2LL * width;
  // First label/class-map byte of this pixel's 2x2 output block.
  const long long out0 = b * 4 * hw + 2 * h * out_w + 2 * w;

  float xv[kC];
  {
    const float* xp = x + b * kC * hw + rem;
#pragma unroll
    for (int ci = 0; ci < kC; ++ci) xv[ci] = active ? xp[ci * hw] : 0.f;
  }

  float ce = 0.f;
  int n_valid = 0, n_correct = 0;
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    uchar2 lab2 = make_uchar2(0, 0);
    if (active) lab2 = *reinterpret_cast<const uchar2*>(labels + out0 + kh * out_w);
    uchar2 cls2;
#pragma unroll
    for (int kw = 0; kw < 2; ++kw) {
      const int lab = kw ? lab2.y : lab2.x;
      float l[kC];
      dsrl_tail::tail_logits(xv, s_p, kh * 2 + kw, l);
      const dsrl_tail::CeTerms t = dsrl_tail::ce_terms(l, lab);
      const int cls = t.nan ? kC - 1 : t.arg;
      const bool valid = active && lab != ignore_label;
      const bool hit = valid && cls == lab;
      if (valid) ce += dsrl_tail::ce_nll(t);
      n_valid += valid;
      n_correct += hit;
      warp_hist_add(s_hist[0], cls, valid);
      warp_hist_add(s_hist[1], cls, hit);
      warp_hist_add(s_hist[2], lab, active && lab < kC);
      if (kw) cls2.y = (uint8_t)cls; else cls2.x = (uint8_t)cls;
    }
    if (active) *reinterpret_cast<uchar2*>(pred + out0 + kh * out_w) = cls2;
  }

  const double ce_w = dsrl_tail::warp_sum((double)ce);
  const int correct_w = dsrl_tail::warp_sum(n_correct);
  const int valid_w = dsrl_tail::warp_sum(n_valid);
  if ((threadIdx.x & 31) == 0) {
    s_ce[threadIdx.x >> 5] = ce_w;
    atomicAdd(&s_cnt[0], correct_w);
    atomicAdd(&s_cnt[1], valid_w);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += s_ce[i];
    ce_partials[blockIdx.x] = t;
    atomicAdd(&counts[3 * kC], (unsigned long long)s_cnt[0]);
    atomicAdd(&counts[3 * kC + 1], (unsigned long long)s_cnt[1]);
  }
  if (threadIdx.x < 3 * kC) {
    const int v = (&s_hist[0][0])[threadIdx.x];
    if (v) atomicAdd(&counts[threadIdx.x], (unsigned long long)v);
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

}  // namespace

extern "C" {

int dsrl_eval_tail_threads() { return kThreads; }
int dsrl_eval_tail_classes() { return kC; }

// Launches both passes on `stream`; returns cudaGetLastError() (0 = ok).
// ce_partials holds ceil(B*H*W / threads) doubles; counts (3*C + 2) int64
// must be zero on entry.
int dsrl_eval_tail_f32(const float* x, const float* weight, const float* bias,
                       const uint8_t* labels, uint8_t* pred, double* ce_partials,
                       double* ce_sum, long long* counts, int batch, int height,
                       int width, int ignore_label, void* stream) {
  const long long npix = (long long)batch * height * width;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  eval_tail_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      x, weight, bias, labels, pred, ce_partials,
      reinterpret_cast<unsigned long long*>(counts), height, width, npix, ignore_label);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kFinalThreads, 0, s>>>(ce_partials, blocks, ce_sum);
  return (int)cudaGetLastError();
}

}  // extern "C"
