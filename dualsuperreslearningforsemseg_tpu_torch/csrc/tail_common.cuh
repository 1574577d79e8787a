// Semantics and building blocks shared by the train tail (fused_tail.cu)
// and the eval tail (eval_tail.cu): the final ConvTranspose2d(C, C, 2, 2)
// + bias of the pre-tail pixels and the masked cross-entropy terms of their
// output pixels.  The JAX package shares `_ce_terms` and `_tile_logits_t`
// (ops/pallas/fused_tail.py:84-118) between its train and eval kernels for
// the same reason: the two computations must not drift apart.  Per output
// pixel with label `lab`:
//   valid  = lab != ignore
//   picked = logits[lab] for lab < C; 0 for a label in [C, 255) (an
//            out-of-range label adds its pixel's full logsumexp)
//   nll    = max + log(sum exp(logit - max)) - picked
//   onehot = (co == lab): all zero for a label >= C (the backward's
//            one-hot, fused_tail.py:164-170)
// Rounding rule of the logits, as in `_tile_logits_t`: for a bfloat16
// activation the weight is rounded to bfloat16 for every product; products
// and sums are float32 and the bias is added in float32.
//
// The logits: the consecutive pre-tail pixels of a warpgroup's tile as a
// (64 x 80) = (64 x K) . (K x 80) product on the tensor cores, one chain
// of sm_90a's asynchronous `wgmma` (`issue_logits_wgmma`), K = the C input
// channels padded with zeros, with its columns ordered so that each lane
// ends with whole output pixels in its accumulators (`col_pos`,
// `col_class`): no shared-memory round trip before the CE.  A float32
// activation takes three TF32 passes (3xTF32: a = hi + lo with hi =
// tf32(a), lo = tf32(a - hi); a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, float32
// accumulators), which keeps float32 accuracy; a bfloat16 activation one
// bfloat16 pass, which is the rounding rule above.  A comes from registers
// (the m16 fragments of each warp's 16 pixels, built from its (C, 16)
// slab), B from the weight table in shared memory, built once a block.
// All three tail kernels (K3, K1 forward and backward) walk their 64-pixel
// tiles the same way (`TailWalk`, at the end).  `mma.sync` (`mma_3xtf32`,
// `mma_bf16`) is left only for K1 backward's dW^T rows 64-79.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dsrl_tail {

constexpr int kC = 19;          // classes (Cityscapes); each wrapper checks it
constexpr int kN = 4 * kC;      // logits of one pre-tail pixel: 76
constexpr int kNPad = 80;       // ... padded to whole n8 tiles
constexpr int kWarpP = 16;      // pre-tail pixels of a warp's part of a tile (one m16 tile)
constexpr int kNT = kNPad / 8;  // n8 tiles of the logits

// Column n of the logits product is class col_class(n) = 2*(n / 8) + n % 2
// (19 is a zero column) of output position col_pos(n) = (n % 8) / 2 (kh*2 +
// kw).  The m16n8 accumulators of lane (g, t) (g = lane / 4, t = lane % 4)
// hold columns n8*8 + 2t + {0, 1} of rows g and g + 8, so after the logits
// product lane (g, t) holds the 19 logits of output position t of pixels g
// and g + 8 of its warp's 16: acc[co / 2][2*half + co % 2].
__host__ __device__ constexpr int col_pos(int n) { return (n % 8) / 2; }
__host__ __device__ constexpr int col_class(int n) { return 2 * (n / 8) + n % 2; }
constexpr int kSlabStride = 24; // row stride (elements) of a warp's (C, 16) activation slab

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// ---------------------------------------------------------------- CE terms

// The max of one output pixel's logits, NaN if any of them is NaN (PTX
// max.NaN): then nothing equals it, so `first_max` gives C-1 and the exp
// sum, hence the loss and its gradient, are NaN, as in JAX.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <typename Row>
__device__ __forceinline__ float row_max(const Row& l) {
  float m = l[0];
#pragma unroll
  for (int co = 1; co < kC; ++co) m = max_nan(m, l[co]);
  return m;
}

// The first class whose logit equals the max m, C-1 if none does (a NaN
// logit): argmax_lastdim's rule (metrics/device.py).
template <typename Row>
__device__ __forceinline__ int first_max(const Row& l, float m) {
  int arg = kC - 1;
#pragma unroll
  for (int co = kC - 1; co >= 0; --co)
    if (l[co] == m) arg = co;
  return arg;
}

// z = sum over classes, in order, of exp(l[co] - m); on return l[co] holds
// exp(l[co] - m), so the backward takes the softmax without a second exp.
template <typename Row>
__device__ __forceinline__ float exp_sum(Row& l, float m) {
  float z = 0.f;
#pragma unroll
  for (int co = 0; co < kC; ++co) {
    l[co] = expf(l[co] - m);
    z += l[co];
  }
  return z;
}

// logits[lab] for lab < C; 0 for a label in [C, 255).
template <typename Row>
__device__ __forceinline__ float picked_logit(const Row& l, int lab) {
  float picked = 0.f;
#pragma unroll
  for (int co = 0; co < kC; ++co)
    if (co == lab) picked = l[co];
  return picked;
}

__device__ __forceinline__ float ce_nll(float m, float z, float picked) { return m + logf(z) - picked; }

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

// ---------------------------------------------------------------- tensor cores

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 relative, both TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b, m16n8k8, TF32 inputs, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in three TF32 passes (small terms first).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// d += a . b, m16n8k16, bfloat16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where pre-tail pixel p lies: sample b, offset rem < hw in its planes.
// The kernels keep hw < 2^31 and step by less than 2^31 pixels, so a step
// is a 32-bit division.
struct PixelPos {
  long long b;
  unsigned rem;
};

__device__ __forceinline__ PixelPos pixel_pos(long long p, unsigned hw) {
  PixelPos r;
  r.b = p / hw;
  r.rem = (unsigned)(p - r.b * hw);
  return r;
}

__device__ __forceinline__ PixelPos advance(PixelPos s, unsigned d, unsigned hw) {
  const unsigned r = s.rem + d;
  if (r < hw) return {s.b, r};   // most steps stay in the sample: no division
  const unsigned q = r / hw;
  return {s.b + q, r - q * hw};
}

// Where element (channel ci, pixel p) of a warp's (C, 16) activation slab
// lies (in elements): row ci at stride kSlabStride (24 elements: the
// fragment loads hit distinct banks; rows stay 16-byte aligned).  K3 and
// K1 forward; K1 backward keeps its slabs in the tensor cores' layout
// (fused_tail.cu).  Every layout keeps the 16 bytes of one channel's
// pixels [16c / size, 16(c + 1) / size) together, and says how many
// elements one slab takes (`kElems`).
template <typename T> struct RowSlab {
  static constexpr int kElems = kC * kSlabStride;
  static __host__ __device__ constexpr int off(int ci, int p) { return ci * kSlabStride + p; }
};

// Starts loading the activation of one warp's pre-tail pixels [p0, p0 + 16)
// (p0 at `pos0`) as a (C, 16) slab laid out by `Layout`: 16-byte cp.async
// copies where 16 bytes of a channel plane lie in one sample and are
// aligned, else plain loads (a part that crosses a sample, an odd plane
// size, the ragged end).  Pixels >= npix are zero.  The caller commits the
// group and, after waiting for it, syncs the warp.
template <typename T, typename Layout = RowSlab<T>>
__device__ __forceinline__ void load_x_part(T* slab, const T* __restrict__ x, long long p0, PixelPos pos0,
                                            long long npix, unsigned hw, int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = kWarpP / V;
  for (int i = lane; i < kC * kChunks; i += 32) {
    const int ci = i / kChunks, c = i - ci * kChunks;
    const PixelPos ps = advance(pos0, c * V, hw);
    T* dst = slab + Layout::off(ci, c * V);
    const T* src = x + (ps.b * kC + ci) * (long long)hw + ps.rem;
    if (p0 + c * V + V <= npix && ps.rem + V <= hw && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float val = 0.f;
        if (p0 + c * V + v < npix) {
          const PixelPos pv = advance(pos0, c * V + v, hw);
          val = to_float(x[(pv.b * kC + ci) * (long long)hw + pv.rem]);
        }
        dst[v] = from_float<T>(val);
      }
    }
  }
}

// The common case of `load_x_part`, uniform over the warp: when the part
// lies in one sample and every channel's 16 pixels are whole aligned
// 16-byte chunks, starts their cp.async copies without per-chunk position
// checks and returns true; else loads nothing and returns false.
template <typename T, typename Layout = RowSlab<T>>
__device__ __forceinline__ bool load_x_part_whole(T* slab, const T* __restrict__ x, long long p0, PixelPos pos0,
                                                  long long npix, unsigned hw, int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = kWarpP / V;
  const T* part = x + pos0.b * kC * (long long)hw + pos0.rem;
  if (p0 + kWarpP > npix || pos0.rem + kWarpP > hw || hw % V != 0 ||
      (reinterpret_cast<uintptr_t>(part) & 15) != 0)
    return false;
  for (int i = lane; i < kC * kChunks; i += 32) {
    const int ci = i / kChunks, c = i - ci * kChunks;
    cp_async16(slab + Layout::off(ci, c * V), part + ci * (long long)hw + c * V);
  }
  return true;
}

// Where pre-tail pixel p (at `pos`) lives: its first label byte (the 2x2
// output block's top-left, also its first class-map byte) and its four
// labels (byte kh*2 + kw of `labels4`, read as two 2-byte pairs).  Pixels
// >= npix get labels 0 and offset 0; every caller masks them.
struct PixelInfo {
  long long out0;
  uint32_t labels4;
};

__device__ __forceinline__ PixelInfo pixel_info(const uint8_t* __restrict__ labels, long long p,
                                                PixelPos pos, long long npix, int width,
                                                unsigned hw) {
  PixelInfo info = {0, 0u};
  if (p < npix) {
    const unsigned h = pos.rem / (unsigned)width, w = pos.rem - h * (unsigned)width;
    info.out0 = pos.b * 4 * (long long)hw + 2LL * h * (2LL * width) + 2LL * w;
    const uint32_t row0 = *reinterpret_cast<const uint16_t*>(labels + info.out0);
    const uint32_t row1 = *reinterpret_cast<const uint16_t*>(labels + info.out0 + 2LL * width);
    info.labels4 = row0 | (row1 << 16);
  }
  return info;
}

// Element (ci, p) of a warp's slab as float; 0 for a padding channel ci >= C.
template <typename T>
__device__ __forceinline__ float slab_at(const T* slab, int ci, int p) {
  return ci < kC ? to_float(slab[ci * kSlabStride + p]) : 0.f;
}

// The A fragments of one k step of the logits product from a warp's slab,
// in the m16 layout of mma.sync and of wgmma's register A (rows = the
// warp's 16 pixels, g and g + 8 for lane (g, t)).  TF32 (k8 step at k0):
// columns k0 + t and k0 + t + 4, split into hi and lo.
template <typename T>
__device__ __forceinline__ void a_frag_tf32(const T* slab, int k0, int lane, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
  split_tf32(slab_at(slab, k0 + t, g), hi[0], lo[0]);
  split_tf32(slab_at(slab, k0 + t, g + 8), hi[1], lo[1]);
  split_tf32(slab_at(slab, k0 + t + 4, g), hi[2], lo[2]);
  split_tf32(slab_at(slab, k0 + t + 4, g + 8), hi[3], lo[3]);
}

// bfloat16 (k16 step at k0): columns k0 + 2t, + 1 and k0 + 2t + 8, + 9,
// packed in pairs.
template <typename T>
__device__ __forceinline__ void a_frag_bf16(const T* slab, int k0, int lane, uint32_t (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const int c0 = k0 + 2 * t, c1 = c0 + 8;
  a[0] = pack_bf16(slab_at(slab, c0, g), slab_at(slab, c0 + 1, g));
  a[1] = pack_bf16(slab_at(slab, c0, g + 8), slab_at(slab, c0 + 1, g + 8));
  a[2] = pack_bf16(slab_at(slab, c1, g), slab_at(slab, c1 + 1, g));
  a[3] = pack_bf16(slab_at(slab, c1, g + 8), slab_at(slab, c1 + 1, g + 8));
}

// ---------------------------------------------------------------- warpgroup tensor cores

// sm_90a's wgmma: the four warps of a warpgroup issue one asynchronous
// m64 product together, each with its 16 rows of A in registers (the
// fragments above) and its 16 rows of the (64 x 80) accumulators in the
// m16n8 layout above, so `LaneRow` and the CE helpers read them unchanged.
// B is read by the tensor cores from shared memory as 8 x 16-byte "core
// matrices" (8 columns n, 16 bytes along K) without swizzle, K-major (the
// only layout TF32 allows).  The logits' wgmma B table: per k step s (8
// TF32 or 16 bfloat16 rows of K) 10 groups of 8 columns, each two core
// matrices (the step's two 16-byte halves of K), at byte
//   s * kWgStep + (n / 8) * kWgSbo + half * kWgLbo + (n % 8) * 16 + (k in half) * size.
// Float32 x: two planes of TF32 words, hi then lo (3xTF32); bfloat16 x:
// one plane of bfloat16.
constexpr int kWgLbo = 128;               // K-adjacent core matrices (leading byte offset)
constexpr int kWgSbo = 256;               // N-adjacent 8-column groups (stride byte offset)
constexpr int kWgStep = kNT * kWgSbo;     // one k step: 2560 bytes
constexpr int kWgM = 64;                  // pre-tail pixels of a warpgroup's tile

template <typename T> struct WgTable {
  static constexpr int kSteps = sizeof(T) == 4 ? 3 : 2;        // K = 24 (TF32) or 32 (bf16)
  static constexpr int kPlane = kSteps * kWgStep;              // bytes
  static constexpr int kBytes = (sizeof(T) == 4 ? 2 : 1) * kPlane;
};

// A wgmma B table of `Steps` k steps and `Groups` groups of 8 columns in
// the layout above (a k step takes Groups * kWgSbo bytes): value(k, n)
// split into TF32 hi and lo planes (float32 x) or rounded to bfloat16.
// Filled by the whole block.
template <typename T, int Steps, int Groups, typename F>
__device__ __forceinline__ void fill_wg_table(uint32_t* tab, F value) {
  constexpr int kWords = Steps * Groups * kWgSbo / 4;
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) {
    // word i = (((s * Groups + n / 8) * 2 + half) * 8 + n % 8) * 4 + e
    const int e = i & 3, n = (i >> 6) % Groups * 8 + ((i >> 2) & 7), half = (i >> 5) & 1,
              s = (i >> 6) / Groups;
    if constexpr (sizeof(T) == 4) {
      split_tf32(value(8 * s + 4 * half + e, n), tab[i], tab[kWords + i]);
    } else {
      const int k = 16 * s + 8 * half + 2 * e;
      tab[i] = pack_bf16(value(k, n), value(k + 1, n));   // lower k at the lower address
    }
  }
}

// The logits' wgmma B table (W[ci, col_class(n), col_pos(n)], split or
// rounded as the products see it) and s_b[co] = bias[co] (s_b[19] = 0).
// The caller makes the stores visible to the tensor cores
// (`wg_fence_proxy`) and synchronises the block afterwards.
template <typename T>
__device__ __forceinline__ void load_wg_weights(uint32_t* tab, float* s_b, const float* __restrict__ weight,
                                                const float* __restrict__ bias) {
  fill_wg_table<T, WgTable<T>::kSteps, kNT>(tab, [&](int ci, int n) {
    const int co = col_class(n);
    return ci < kC && co < kC ? weight[(ci * kC + co) * 4 + col_pos(n)] : 0.f;
  });
  for (int co = threadIdx.x; co < kC + 1; co += blockDim.x) s_b[co] = co < kC ? bias[co] : 0.f;
}

// Generic-proxy stores to shared memory visible to wgmma's reads (the
// async proxy); before the barrier that publishes them.
__device__ __forceinline__ void wg_fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The matrix descriptor of a no-swizzle K-major operand at `smem`: start
// address, leading byte offset (K-adjacent core matrices) and stride byte
// offset (8-row groups along M or N), all in 16-byte units; base offset
// and layout type 0.
__device__ __forceinline__ uint64_t wg_desc(const void* smem, int lbo = kWgLbo, int sbo = kWgSbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across a
// wgmma's issue or wait (the tensor cores write them in between).
template <int NT>
__device__ __forceinline__ void wg_fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[nt][j])::"memory");
}

// d = a . B (scale_d 0) or d += a . B, m64n80k8, TF32, B at desc_b.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kNT][4], const uint32_t (&a)[4], uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The same, m64n80k16, bfloat16 (B not transposed: K-major).
__device__ __forceinline__ void wgmma_bf16(float (&d)[kNT][4], const uint32_t (&a)[4], uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The A fragments of a warp's part of a warpgroup tile, every k step:
// TF32 hi and lo (3 k8 steps) or bfloat16 (2 k16 steps).
template <typename T> struct WgA {
  uint32_t hi[WgTable<T>::kSteps][4];
  uint32_t lo[sizeof(T) == 4 ? WgTable<T>::kSteps : 1][4];
};

template <typename T>
__device__ __forceinline__ void load_wg_a(const T* slab, int lane, WgA<T>& a) {
#pragma unroll
  for (int s = 0; s < WgTable<T>::kSteps; ++s) {
    if constexpr (sizeof(T) == 4) a_frag_tf32(slab, 8 * s, lane, a.hi[s], a.lo[s]);
    else a_frag_bf16(slab, 16 * s, lane, a.hi[s]);
  }
}

// Issues the bias-free logits of the warpgroup's 64 pixels into d (every
// k step; three TF32 passes, small terms first, for a float32 x), without
// committing or waiting.  desc is the descriptor of the table's start;
// a descriptor's address field counts 16-byte units.  The caller fences
// (`wg_fence`) after writing a's or d's registers.
template <typename T>
__device__ __forceinline__ void issue_logits_wgmma(float (&d)[kNT][4], const WgA<T>& a, uint64_t desc) {
#pragma unroll
  for (int s = 0; s < WgTable<T>::kSteps; ++s) {
    const uint64_t hi = desc + (uint64_t)(s * kWgStep >> 4);
    if constexpr (sizeof(T) == 4) {
      const uint64_t lo = hi + (uint64_t)(WgTable<T>::kPlane >> 4);
      wgmma_tf32(d, a.lo[s], hi, s > 0);
      wgmma_tf32(d, a.hi[s], lo, 1);
      wgmma_tf32(d, a.hi[s], hi, 1);
    } else {
      wgmma_bf16(d, a.hi[s], hi, s > 0);
    }
  }
}

// This lane's output pixel of row `Half` (pixel g + 8*Half, position t)
// as a row of 19 logits addressed in place in the accumulators:
// acc[co / 2][2*Half + co % 2] (the CE helpers above take it like an
// array).
template <int Half>
struct LaneRow {
  float (&acc)[kNT][4];
  __device__ __forceinline__ float& operator[](int co) const { return acc[co / 2][2 * Half + co % 2]; }
};

// Adds the bias (float32) to this lane's output pixel of row `Half`.
template <int Half>
__device__ __forceinline__ LaneRow<Half> lane_logits(float (&acc)[kNT][4], const float* s_b) {
  const LaneRow<Half> l{acc};
#pragma unroll
  for (int co = 0; co < kC; ++co) l[co] += s_b[co];
  return l;
}

// ---------------------------------------------------------------- the warpgroup walk

// The walk of the three tail kernels over their tiles.  A persistent grid,
// one block an SM of `wgs` warpgroups (`persistent_grid`), walks tiles of
// kWgM = 64 consecutive pre-tail pixels, warpgroup i of the grid taking
// tiles i, i + all warpgroups, ...  Each warp of a warpgroup owns 16
// pixels of its tiles: it loads their (C, 16) slab (laid out by `Layout`)
// with cp.async two tiles ahead into a ring of two buffers, and their
// labels one tile ahead into registers (lanes l and l + 16 hold pixel l;
// a kernel shuffles them to the lanes that need them).  A kernel's step
// waits for its slab, issues the tile's products, requests the slab two
// tiles ahead into the buffer just read (`load_slab`), reads the next
// tile's pixels (`walk_pixel`) while the tensor cores run, finishes the
// tile and moves on (`advance_walk`).  The tile indices are uniform over
// the warpgroup (derived from a warp index shuffled from lane 0), so no
// wgmma sits in a branch the compiler cannot prove uniform.
template <typename T> struct TailWalk {
  const T* x;
  const uint8_t* labels;
  T* s_x;                    // the warp's two slabs
  const float* s_b;
  long long tile, ntiles, groups, p0, npix;
  PixelPos pos;              // of p0
  unsigned hw, stride;       // stride: pixels from one of the warpgroup's tiles to the next
  int width, ignore_label, lane, it;
  uint32_t labels4;          // lane l: the four labels of pixel p0 + l % 16 of this tile
};

// Sets a warp's walk at its warpgroup's first tile; `warp` is the warp's
// index in a block of `wgs` warpgroups.
template <typename T>
__device__ __forceinline__ void init_walk(TailWalk<T>& w, const T* x, const uint8_t* labels, T* s_x,
                                          const float* s_b, int height, int width, long long npix,
                                          int ignore_label, int wgs, int warp, int lane) {
  w.x = x;
  w.labels = labels;
  w.s_x = s_x;
  w.s_b = s_b;
  w.hw = (unsigned)height * (unsigned)width;
  w.ntiles = (npix + kWgM - 1) / kWgM;
  w.groups = (long long)gridDim.x * wgs;
  w.stride = (unsigned)w.groups * kWgM;
  w.tile = (long long)blockIdx.x * wgs + warp / 4;
  w.npix = npix;
  w.width = width;
  w.ignore_label = ignore_label;
  w.lane = lane;
  w.it = 0;
}

// Starts loading this warp's slab of the tile `ahead` tiles after w.tile.
template <typename T, typename Layout = RowSlab<T>>
__device__ __forceinline__ void load_slab(const TailWalk<T>& w, T* slab, unsigned ahead) {
  const long long p0 = w.p0 + (long long)ahead * w.stride;
  const PixelPos pos = advance(w.pos, ahead * w.stride, w.hw);
  if (!load_x_part_whole<T, Layout>(slab, w.x, p0, pos, w.npix, w.hw, w.lane))
    load_x_part<T, Layout>(slab, w.x, p0, pos, w.npix, w.hw, w.lane);
}

// Pixel p0 + lane % 16 (labels, class-map offset) of the tile `ahead`
// tiles after w.tile.
template <typename T>
__device__ __forceinline__ PixelInfo walk_pixel(const TailWalk<T>& w, unsigned ahead) {
  const int pl = w.lane & (kWarpP - 1);
  return pixel_info(w.labels, w.p0 + (long long)ahead * w.stride + pl,
                    advance(w.pos, ahead * w.stride + pl, w.hw), w.npix, w.width, w.hw);
}

// For a warpgroup that has a first tile (w.tile < w.ntiles): sets the
// warp's first pixel (w4: the warp's index in its warpgroup), requests the
// slabs of its first two tiles (two cp.async groups, the second empty
// without a second tile) and reads the first tile's pixels.
template <typename T, typename Layout = RowSlab<T>>
__device__ __forceinline__ PixelInfo start_walk(TailWalk<T>& w, int w4) {
  w.p0 = w.tile * kWgM + w4 * kWarpP;
  w.pos = pixel_pos(w.p0, w.hw);
  load_slab<T, Layout>(w, w.s_x, 0);
  cp_async_commit();
  if (w.tile + w.groups < w.ntiles) load_slab<T, Layout>(w, w.s_x + Layout::kElems, 1);
  cp_async_commit();
  const PixelInfo first = walk_pixel(w, 0);
  w.labels4 = first.labels4;
  return first;
}

// Moves the walk to its next tile, whose labels are `labels_next`.
template <typename T>
__device__ __forceinline__ void advance_walk(TailWalk<T>& w, uint32_t labels_next) {
  w.labels4 = labels_next;
  w.tile += w.groups;
  w.p0 += w.stride;
  w.pos = advance(w.pos, w.stride, w.hw);
  ++w.it;
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

}  // namespace dsrl_tail
