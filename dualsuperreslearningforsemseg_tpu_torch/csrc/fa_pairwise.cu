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
// The O(N^2) pair set is never written: a block stages the other operand
// in shared memory, 2048 values at a time, and each thread holds kE = 4
// elements of its own operand in registers and walks the staged values as
// float4 broadcasts, so one shared-memory load feeds 4 * kE pairs and the
// kE running sums are independent of each other.
//
// What bounds it on an H100 SXM: 3 operations a pair forward (subtract,
// absolute value, add) and 4 backward (two comparisons and their adds, for
// each of da and db), against 8 N bytes a row read, so from N ~ 64 on it is
// bound by operations at 67 TFLOP/s FP32: R = 304, N = 1024 is 0.96 G ops =
// 14 us forward and 19 us backward.  The forward issues 2 FP32 adds a pair
// (the absolute value is an operand modifier); the backward 2 comparisons
// (FSET, on the half-rate pipe) and 2 adds a pair and operand, and the
// comparisons are its limit: counting in integers (all on that pipe) runs
// 1.5x slower.  At the stage-3 recipe (R = 8, N = 256, 65 K pairs a row)
// the work is a few microseconds of launch latency: the forward is one
// launch, and the wrappers' host path is what a call costs.
//
// Forward: one thread-block cluster of C <= 8 blocks per row (the wrapper
// chooses C, for about 512 blocks on the card), launched with
// cudaLaunchKernelEx.  A row splits over its cluster in j: block k takes
// the k-th of C equal ranges of j and every i (at N = 1024 one block's
// threads already hold all of i); when N is small a block's threads split
// further into G <= 8 groups, each over its own part of every staged
// chunk, so that kThreads / G * kE covers the row's i.  A thread sums
// |a_i - b_j| in float32 over runs of 32 j (per element, four pairs at a
// time) and adds each run into its float64 total; a block reduces its
// totals in a fixed tree (warp shuffles, then warps in order); after
// cluster.sync() block 0 reads the other blocks' totals from their
// shared memory (distributed shared memory, in rank order), adds them and
// rounds once to float32.  No atomics and no scratch buffer: the order of
// every sum is fixed by (N, C), so two launches give bit-identical sums.
//
// Backward: one block per (row, tile of kThreads / G * kE elements,
// operand); blockIdx.y = 0 computes da, 1 computes db.  The sum of signs is
// an integer, kept as an integer-valued float32 (exact below 2^24 = the
// largest N); the G groups' partial counts add exactly in shared memory.
// Each gradient element is that count times g[r], one rounded product, as
// the JAX package computes it, so the result equals the plain PyTorch
// version bit for bit.  For db the thread counts sign(b_j - a_i), which is
// -sign(a_i - b_j) exactly.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kE = 4;           // elements of its own operand a thread holds
constexpr int kChunk = 2048;    // other-operand values staged in shared memory at a time
constexpr int kRunQuads = 8;    // float4s (32 values) summed in float32 before adding into float64
constexpr int kMaxGroups = 8;   // a group keeps at least a warp
constexpr int kMaxCluster = 8;  // the portable cluster size

// Groups a block splits into for rows of n: the most (a power of two, at
// most 8) whose threads still hold all n elements of a row.
__host__ __device__ __forceinline__ int groups_for(int n) {
  int g = 1;
  while (g < kMaxGroups && (kThreads / (2 * g)) * kE >= n) g *= 2;
  return g;
}

__host__ __device__ __forceinline__ int tile_for(int n) { return kThreads / groups_for(n) * kE; }

__device__ __forceinline__ void stage(float* s_dst, const float* src, int len) {
  __syncthreads();
  for (int k = threadIdx.x; k < len; k += kThreads) s_dst[k] = src[k];
  __syncthreads();
}

// Quads [q0, q_full) of a staged chunk of `len` values are whole; when the
// group's part ends the chunk, values [t0, len) are its ragged tail.
struct Part {
  int q0, q_full, t0, t1;
};

__device__ __forceinline__ Part part_of(int len, int group, int groups) {
  const int quads = (len + 3) / 4;
  const int q0 = quads * group / groups, q1 = quads * (group + 1) / groups;
  Part p;
  p.q0 = q0;
  p.q_full = min(q1, len / 4);
  const bool ends = q1 == quads;
  p.t0 = ends ? 4 * (len / 4) : 0;
  p.t1 = ends ? len : 0;
  return p;
}

__device__ __forceinline__ void abs_diff_quad(float (&s)[kE], const float (&x)[kE], float4 y) {
#pragma unroll
  for (int e = 0; e < kE; ++e)
    s[e] += (fabsf(x[e] - y.x) + fabsf(x[e] - y.y)) + (fabsf(x[e] - y.z) + fabsf(x[e] - y.w));
}

__device__ __forceinline__ void flush(double& acc, float (&s)[kE], const bool (&live)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    if (live[e]) acc += (double)s[e];
    s[e] = 0.f;
  }
}

// sum over a part of the staged values y of |x_e - y_k|, for each live
// element e, in float32 runs of kRunQuads quads added into float64.
__device__ __forceinline__ double abs_diff_part(const float (&x)[kE], const bool (&live)[kE],
                                                const float* y, Part p) {
  const float4* y4 = reinterpret_cast<const float4*>(y);
  double acc = 0.0;
  float s[kE] = {};
  int q = p.q0;
  for (; q + kRunQuads <= p.q_full; q += kRunQuads) {
#pragma unroll
    for (int k = 0; k < kRunQuads; ++k) abs_diff_quad(s, x, y4[q + k]);
    flush(acc, s, live);
  }
  for (; q < p.q_full; ++q) abs_diff_quad(s, x, y4[q]);
  for (int t = p.t0; t < p.t1; ++t) {
#pragma unroll
    for (int e = 0; e < kE; ++e) s[e] += fabsf(x[e] - y[t]);
  }
  flush(acc, s, live);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
fa_forward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int n) {
  __shared__ __align__(16) float s_b[kChunk];
  __shared__ double s_warp[kThreads / 32];
  __shared__ double s_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int row = blockIdx.x / blocks;
  const int groups = groups_for(n), per_group = kThreads / groups;
  const int group = threadIdx.x / per_group, lane = threadIdx.x % per_group;
  const int tile = per_group * kE;
  const float* arow = a + (long long)row * n;
  const float* brow = b + (long long)row * n;
  const int j_begin = (int)((long long)n * rank / blocks);
  const int j_end = (int)((long long)n * (rank + 1) / blocks);

  double acc = 0.0;
  for (int c0 = j_begin; c0 < j_end; c0 += kChunk) {
    const int len = min(kChunk, j_end - c0);
    stage(s_b, brow + c0, len);
    const Part p = part_of(len, group, groups);
    for (int i0 = lane * kE; i0 < n; i0 += tile) {
      float x[kE];
      bool live[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        live[e] = i0 + e < n;
        x[e] = live[e] ? arow[i0 + e] : 0.f;
      }
      acc += abs_diff_part(x, live, s_b, p);
    }
  }

  // Fixed-order reduction: the warp's tree, the warps in order, then the
  // cluster's blocks in rank order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += s_warp[w];
    s_total = t;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    double t = 0.0;
    for (int k = 0; k < blocks; ++k) t += *cluster.map_shared_rank(&s_total, k);
    out[row] = (float)t;
  }
  cluster.sync();   // the other blocks' shared memory stays until block 0 has read it
}

__device__ __forceinline__ float sign_of(float x, float y) {
  return (float)(x > y) - (float)(x < y);
}

__device__ __forceinline__ void sign_quad(float (&c)[kE], const float (&x)[kE], float4 y) {
#pragma unroll
  for (int e = 0; e < kE; ++e)
    c[e] += (sign_of(x[e], y.x) + sign_of(x[e], y.y)) + (sign_of(x[e], y.z) + sign_of(x[e], y.w));
}

// blockIdx.y = 0: da over tiles of a; 1: db over tiles of b.
__global__ void __launch_bounds__(kThreads)
fa_backward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ g, float* __restrict__ da, float* __restrict__ db,
                   int n, int tiles) {
  __shared__ __align__(16) float s_o[kChunk];
  __shared__ float s_count[kThreads * kE];
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const bool for_b = blockIdx.y == 1;
  const int groups = groups_for(n), per_group = kThreads / groups;
  const int group = threadIdx.x / per_group, lane = threadIdx.x % per_group;
  const long long base = (long long)row * n;
  const float* self = (for_b ? b : a) + base;
  const float* other = (for_b ? a : b) + base;
  const int i0 = tile * per_group * kE + lane * kE;
  float x[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) x[e] = i0 + e < n ? self[i0 + e] : 0.f;

  float c[kE] = {};   // sums of sign(x_e - other_k): integers, exact in float32
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int len = min(kChunk, n - c0);
    stage(s_o, other + c0, len);
    const Part p = part_of(len, group, groups);
    const float4* y4 = reinterpret_cast<const float4*>(s_o);
    int q = p.q0;
    for (; q + 4 <= p.q_full; q += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) sign_quad(c, x, y4[q + k]);
    }
    for (; q < p.q_full; ++q) sign_quad(c, x, y4[q]);
    for (int t = p.t0; t < p.t1; ++t) {
#pragma unroll
      for (int e = 0; e < kE; ++e) c[e] += sign_of(x[e], s_o[t]);
    }
  }
  if (groups > 1) {   // the groups' counts of the same elements, added exactly
#pragma unroll
    for (int e = 0; e < kE; ++e) s_count[threadIdx.x * kE + e] = c[e];
    __syncthreads();
    if (group == 0) {
      for (int k = 1; k < groups; ++k) {
#pragma unroll
        for (int e = 0; e < kE; ++e) c[e] += s_count[(k * per_group + lane) * kE + e];
      }
    }
  }
  if (group == 0) {
    float* dst = (for_b ? db : da) + base;
    const float gr = g[row];
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (i0 + e < n) dst[i0 + e] = __fmul_rn(c[e], gr);
  }
}

}  // namespace

extern "C" {

// Backward tiles of one row and operand (the backward grid is rows * tiles x 2).
int dsrl_fa_pairwise_tiles(int n) { return (n + tile_for(n) - 1) / tile_for(n); }

// The largest cluster the forward takes.
int dsrl_fa_pairwise_max_cluster() { return kMaxCluster; }

// a, b (rows, n) float32; out (rows,) float32.  One launch of rows clusters
// of `cluster` (1..8) blocks on `stream`; returns its cudaError_t.
int dsrl_fa_pairwise_fwd(const float* a, const float* b, float* out, int rows, int n, int cluster,
                         void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)rows * (unsigned)cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, fa_forward_kernel, a, b, out, n);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// a, b (rows, n) float32; g (rows,) float32, the cotangent of out;
// da, db (rows, n) float32.  Launches on `stream`; returns cudaGetLastError().
int dsrl_fa_pairwise_bwd(const float* a, const float* b, const float* g, float* da, float* db,
                         int rows, int n, void* stream) {
  const int tiles = dsrl_fa_pairwise_tiles(n);
  fa_backward_kernel<<<dim3(rows * tiles, 2), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, g, da, db, n, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
