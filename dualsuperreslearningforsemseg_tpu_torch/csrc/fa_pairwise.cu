// All-pairs L1 reduction of the feature-affinity (FA) loss for Hopper
// (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// dualsuperreslearningforsemseg_tpu/ops/pallas/fa_pairwise.py (pallas_call
// at lines 116 and 145, `fa_allpairs_abs_sum_rows`), without their 8-row
// tiles or their N % 128 rule: any R >= 1 rows of any length 1 <= N < 2^24.
// For rows a[r, :], b[r, :] of length N:
//   forward   out[r]   = sum_{i,j} |a[r,i] - b[r,j]|
//   backward  da[r,i]  =  g[r] * sum_j sign(a[r,i] - b[r,j])
//             db[r,j]  = -g[r] * sum_i sign(a[r,i] - b[r,j])      (sign(0) = 0)
// The O(N^2) pair set is never written: each block stages one row's other
// operand in shared memory, 2048 values at a time, and each thread walks it
// against its own element.
//
// Forward: one block per (row, tile of 256 i), one thread per i.  A thread
// sums |a_i - b_j| in float32 over 32 consecutive j (four interleaved
// partial sums) and adds each 32-term sum into a float64 total; the block
// reduces its 256 totals in a fixed tree; a second pass, one thread per row,
// adds the row's tile partials in order and rounds once to float32.  No
// atomics: two launches give bit-identical sums.
//
// Backward: one block per (row, tile of 256, operand), one thread per
// element.  The sum of signs is an integer count (exact in float32 for
// N < 2^24); each gradient element is that count times g[r], one rounded
// product, as the JAX package computes it, so the result equals the plain
// PyTorch version bit for bit.  For db the thread counts sign(b_j - a_i),
// which is -sign(a_i - b_j) exactly.
//
// Bound on an H100 SXM: 3 operations a pair forward (subtract, absolute
// value, add) and 4 backward (two comparisons and an add, for each of da
// and db counted as 2), against 8 N bytes a row read and 4 (forward) or
// 8 N (backward) bytes a row written, so at N >= 64 it is bound by
// operations (67 TFLOP/s FP32): R = 304, N = 1024 is 0.96 G ops = 14 us.
// At the stage-3 recipe (R = 8, N = 256, 0.5 M pairs) it is bound by its
// two launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // elements of a tile, one per thread
constexpr int kChunk = 2048;    // other-operand values staged in shared memory at a time
constexpr int kInner = 32;      // terms summed in float32 before adding into float64

__device__ __forceinline__ void stage(float* s_dst, const float* src, int len) {
  __syncthreads();
  for (int k = threadIdx.x; k < len; k += kThreads) s_dst[k] = src[k];
  __syncthreads();
}

// |x - y_k| summed over len staged values, in float32 blocks of kInner
// added into a float64 total, in a fixed order.
__device__ __forceinline__ double abs_diff_sum(float x, const float* y, int len) {
  double acc = 0.0;
  int k = 0;
  for (; k + kInner <= len; k += kInner) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < kInner; ++u) s[u & 3] += fabsf(x - y[k + u]);
    acc += (double)((s[0] + s[1]) + (s[2] + s[3]));
  }
  float s = 0.f;
  for (; k < len; ++k) s += fabsf(x - y[k]);
  return acc + (double)s;
}

__global__ void __launch_bounds__(kThreads)
fa_forward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  double* __restrict__ partials, int n, int tiles) {
  __shared__ float s_b[kChunk];
  __shared__ double s_red[kThreads];
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int i = tile * kThreads + threadIdx.x;
  const bool live = i < n;
  const float* arow = a + (long long)row * n;
  const float* brow = b + (long long)row * n;
  const float ai = live ? arow[i] : 0.f;
  double acc = 0.0;
  for (int j0 = 0; j0 < n; j0 += kChunk) {
    const int len = min(kChunk, n - j0);
    stage(s_b, brow + j0, len);
    if (live) acc += abs_diff_sum(ai, s_b, len);
  }
  s_red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s_red[threadIdx.x] += s_red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = s_red[0];
}

__global__ void fa_rows_kernel(const double* __restrict__ partials, int tiles, int rows,
                               float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  double s = 0.0;
  for (int t = 0; t < tiles; ++t) s += partials[(long long)r * tiles + t];
  out[r] = (float)s;
}

// blockIdx.y = 0: da over tiles of a; 1: db over tiles of b.
__global__ void __launch_bounds__(kThreads)
fa_backward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ g, float* __restrict__ da, float* __restrict__ db,
                   int n, int tiles) {
  __shared__ float s_o[kChunk];
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const bool for_b = blockIdx.y == 1;
  const long long base = (long long)row * n;
  const float* self = (for_b ? b : a) + base;
  const float* other = (for_b ? a : b) + base;
  const int i = tile * kThreads + threadIdx.x;
  const bool live = i < n;
  const float x = live ? self[i] : 0.f;
  int count = 0;   // sum of sign(x - other_k)
  for (int j0 = 0; j0 < n; j0 += kChunk) {
    const int len = min(kChunk, n - j0);
    stage(s_o, other + j0, len);
    if (live) {
#pragma unroll 8
      for (int k = 0; k < len; ++k) {
        const float y = s_o[k];
        count += (int)(x > y) - (int)(x < y);
      }
    }
  }
  if (live) (for_b ? db : da)[base + i] = __fmul_rn((float)count, g[row]);
}

}  // namespace

extern "C" {

// Tiles of one row: the forward's float64 partials hold rows * tiles values.
int dsrl_fa_pairwise_tiles(int n) { return (n + kThreads - 1) / kThreads; }

// a, b (rows, n) float32; partials (rows * tiles) float64 scratch;
// out (rows,) float32.  Launches on `stream`; returns cudaGetLastError().
int dsrl_fa_pairwise_fwd(const float* a, const float* b, double* partials, float* out, int rows,
                         int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = dsrl_fa_pairwise_tiles(n);
  fa_forward_kernel<<<rows * tiles, kThreads, 0, s>>>(a, b, partials, n, tiles);
  int err = (int)cudaGetLastError();
  if (err) return err;
  fa_rows_kernel<<<(rows + 127) / 128, 128, 0, s>>>(partials, tiles, rows, out);
  return (int)cudaGetLastError();
}

// a, b (rows, n) float32; g (rows,) float32, the cotangent of out;
// da, db (rows, n) float32.  Launches on `stream`; returns cudaGetLastError().
int dsrl_fa_pairwise_bwd(const float* a, const float* b, const float* g, float* da, float* db,
                         int rows, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = dsrl_fa_pairwise_tiles(n);
  fa_backward_kernel<<<dim3(rows * tiles, 2), kThreads, 0, s>>>(a, b, g, da, db, n, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
