// Semantics shared by the train tail (fused_tail.cu) and the eval tail
// (eval_tail.cu): the final ConvTranspose2d(C, C, 2, 2) + bias of one
// pre-tail pixel and the masked cross-entropy terms of its output pixels.
// The JAX package shares `_ce_terms` (ops/pallas/fused_tail.py:102-118)
// between its train and eval kernels for the same reason: the two CE
// computations must not drift apart.  Per output pixel with label `lab`:
//   valid  = lab != ignore
//   picked = logits[lab] for lab < C; 0 for a label in [C, 255) (an
//            out-of-range label adds its pixel's full logsumexp)
//   nll    = max + log(sum exp(logit - max)) - picked
//   onehot = (co == lab): all zero for a label >= C (the backward's
//            one-hot, fused_tail.py:164-170)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dsrl_tail {

constexpr int kC = 19;   // classes (Cityscapes); each wrapper checks it
constexpr int kPad = 20;  // rows padded to whole float4s

// Shared-memory copies of the IOHW weight as w[kh*2+kw][ci][co] and as its
// transpose wt[kh*2+kw][co][ci], rows padded to 20 floats (the pad is 0) so
// a thread reads them as float4s, and the bias.  Every thread of a warp
// reads the same words (a broadcast).
struct __align__(16) TailParams {
  float w[4][kC][kPad];
  float wt[4][kC][kPad];
  float b[kC];
};

// Fills `p` from the IOHW (C, C, 2, 2) weight and the bias; the caller
// synchronises the block afterwards.
__device__ __forceinline__ void load_tail_params(TailParams& p, const float* __restrict__ weight,
                                                 const float* __restrict__ bias) {
  for (int i = threadIdx.x; i < 4 * kC * kPad; i += blockDim.x) {
    const int kpos = i / (kC * kPad), row = (i / kPad) % kC, col = i % kPad;
    // IOHW source index ((ci*C + co)*2 + kh)*2 + kw
    (&p.w[0][0][0])[i] = col < kC ? weight[(row * kC + col) * 4 + kpos] : 0.f;
    (&p.wt[0][0][0])[i] = col < kC ? weight[(col * kC + row) * 4 + kpos] : 0.f;
  }
  if (threadIdx.x < kC) p.b[threadIdx.x] = bias[threadIdx.x];
}

// acc[j] += s * row[j] for j < C, reading the padded row as float4s.
__device__ __forceinline__ void axpy_row(float s, const float* row, float (&acc)[kC]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < kPad / 4; ++q) {
    const float4 v = r4[q];
    acc[4 * q] = fmaf(s, v.x, acc[4 * q]);
    acc[4 * q + 1] = fmaf(s, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(s, v.z, acc[4 * q + 2]);
    if (4 * q + 3 < kC) acc[4 * q + 3] = fmaf(s, v.w, acc[4 * q + 3]);
  }
}

// The logits of output position kpos (kh*2+kw) of one pre-tail pixel:
// l[co] = sum over ci in order of x[ci] * W[ci, co] (FMAs), then + bias.
__device__ __forceinline__ void tail_logits(const float (&xv)[kC], const TailParams& p, int kpos,
                                            float (&l)[kC]) {
#pragma unroll
  for (int co = 0; co < kC; ++co) l[co] = 0.f;
#pragma unroll
  for (int ci = 0; ci < kC; ++ci) axpy_row(xv[ci], p.w[kpos][ci], l);
#pragma unroll
  for (int co = 0; co < kC; ++co) l[co] += p.b[co];
}

struct CeTerms {
  float m;       // max logit (the first compared; NaN-tolerant as below)
  float z;       // sum exp(logit - m)
  float picked;  // logits[lab] for lab < C, else 0
  int arg;       // first index of the max
  bool nan;      // any logit NaN
};

// The CE terms of one output pixel.  A NaN logit makes m or z NaN, so the
// NaN reaches the loss and its gradient, as in JAX.
__device__ __forceinline__ CeTerms ce_terms(const float (&l)[kC], int lab) {
  CeTerms t;
  t.m = l[0];
  t.arg = 0;
  t.nan = isnan(l[0]);
#pragma unroll
  for (int co = 1; co < kC; ++co) {
    t.nan |= isnan(l[co]);
    if (l[co] > t.m) { t.m = l[co]; t.arg = co; }
  }
  t.z = 0.f;
  t.picked = 0.f;
#pragma unroll
  for (int co = 0; co < kC; ++co) {
    t.z += expf(l[co] - t.m);
    if (co == lab) t.picked = l[co];
  }
  return t;
}

__device__ __forceinline__ float ce_nll(const CeTerms& t) { return t.m + logf(t.z) - t.picked; }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace dsrl_tail
