// Photometric input tail for Hopper (sm_90a): per-sample 3-tap gaussian
// blur (vertical, then horizontal, torchvision reflect padding), folded 3x3
// colour matrix + offset (grayscale-or-identity, 1/255, normalisation), and
// the cast to the compute dtype, in one pass.
//
// Replaces the Pallas TPU kernel `photometric_planar` / `_kernel` in
// dualsuperreslearningforsemseg_tpu/ops/pallas/augment_post.py (pallas_call
// at line 136), without its strip/halo machinery or its H % 8, W % 128 rule.
// Per output pixel (b, y, x) and channel c, with taps (t0, t1, t2):
//   v[x'] = t0 * img[y-1, x', c] + t1 * img[y, x', c] + t2 * img[y+1, x', c]
//   h_c   = t0 * v[x-1] + t1 * v[x] + t2 * v[x+1]
//   out_d = cmat[0, d] * h_0 + cmat[1, d] * h_1 + cmat[2, d] * h_2 + coff[d]
// where row -1 reads row 1 and row H reads row H-2 (columns alike).  Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction), in the order written, so the result equals the plain
// PyTorch version's elementwise ops bit for bit; identity taps (0, 1, 0)
// reproduce the unblurred image exactly.
//
// Layout: it reads the warped NHWC uint8 batch (B, H, W, 3) directly, which
// fuses away the transpose the JAX package makes before its kernel
// (data/augment.py:486), and writes the planar (B, 3, H, W) result in
// float32 or bfloat16.  One thread per output pixel, a block per 256
// columns of one row of one sample; the sample's 15 parameters (taps, cmat,
// coff) sit in shared memory.  The 3x3 neighbourhood of each pixel is read
// from global memory; neighbouring threads share it through L1.
//
// Bound on an H100 SXM (3.35 TB/s) at the stage-1 recipe (8 x 512 x 1024):
// it reads 12.6 MB of uint8 and writes 50.3 MB of float32 (25.2 MB of
// bfloat16): 19 us (11 us).  About 78 operations per pixel, 0.33 GOP, is
// 5 us at 67 TFLOP/s, so it is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 15;   // taps (3), cmat (3x3, [c][d]), coff (3)

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// t0 * a + t1 * b + t2 * c, each operation rounded on its own.
__device__ __forceinline__ float taps3(const float* t, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(t[0], a), __fmul_rn(t[1], b)), __fmul_rn(t[2], c));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
photometric_kernel(const uint8_t* __restrict__ img, const float* __restrict__ taps,
                   const float* __restrict__ cmat, const float* __restrict__ coff,
                   T* __restrict__ out, int height, int width) {
  __shared__ float s_prm[kParams];
  const int b = blockIdx.z, y = blockIdx.y;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (threadIdx.x < 3) s_prm[threadIdx.x] = taps[b * 3 + threadIdx.x];
  else if (threadIdx.x < 12) s_prm[threadIdx.x] = cmat[b * 9 + threadIdx.x - 3];
  else if (threadIdx.x < kParams) s_prm[threadIdx.x] = coff[b * 3 + threadIdx.x - 12];
  __syncthreads();
  if (x >= width) return;

  const float* t = s_prm;
  const float* m = s_prm + 3;   // m[c * 3 + d]
  const float* off = s_prm + 12;
  const int ym = y == 0 ? 1 : y - 1, yp = y == height - 1 ? height - 2 : y + 1;
  const int cols[3] = {x == 0 ? 1 : x - 1, x, x == width - 1 ? width - 2 : x + 1};
  const uint8_t* base = img + (long long)b * height * width * 3;
  const uint8_t* rows[3] = {base + (long long)ym * width * 3, base + (long long)y * width * 3,
                            base + (long long)yp * width * 3};
  float h[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int o = cols[k] * 3 + c;
      v[k] = taps3(t, (float)rows[0][o], (float)rows[1][o], (float)rows[2][o]);
    }
    h[c] = taps3(t, v[0], v[1], v[2]);
  }
  const long long plane = (long long)height * width;
  T* op = out + (long long)b * 3 * plane + (long long)y * width + x;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float s = __fadd_rn(__fmul_rn(m[0 * 3 + d], h[0]), __fmul_rn(m[1 * 3 + d], h[1]));
    s = __fadd_rn(__fadd_rn(s, __fmul_rn(m[2 * 3 + d], h[2])), off[d]);
    store(op + d * plane, s);
  }
}

}  // namespace

extern "C" {

// img (B, H, W, 3) uint8; taps (B, 3), cmat (B, 3, 3), coff (B, 3) float32;
// out (B, 3, H, W) float32 (out_dtype 0) or bfloat16 (1).  H, W >= 2.
// Launches on `stream`; returns cudaGetLastError() (0 = ok).
int dsrl_photometric(int out_dtype, const uint8_t* img, const float* taps, const float* cmat,
                     const float* coff, void* out, int batch, int height, int width,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((width + kThreads - 1) / kThreads, height, batch);
  if (out_dtype)
    photometric_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        img, taps, cmat, coff, static_cast<__nv_bfloat16*>(out), height, width);
  else
    photometric_kernel<float><<<grid, kThreads, 0, s>>>(img, taps, cmat, coff,
                                                        static_cast<float*>(out), height, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
