// Fused GLM value + gradient from a packed auxiliary block, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// photon_ml_torch/ops/packed_glm.py.
//
// Replaces six TPU kernels of the operand-form study behind
// photon_ml_tpu/ops/pallas_glm.py:
//
// - experiments/kernel_probe6.py (`kernel`/`fused`): labels | offsets |
//   weights packed as one [n, 3] f32 block, row i = (y_i, o_i, ws_i), read
//   as one 12-byte record per row; the sum of residuals optional.
// - experiments/kernel_probe7.py (`kernel`/`fused`): the same, with the
//   margin product and the gradient product each on the matrix unit or the
//   vector unit. Here a product runs either as f32 FMAs on the widened tile
//   ("fma": the function of the probe's `vpu` and `mxu_cast`) or as
//   warp-level tensor-core mma.sync on the staged tile with f32
//   accumulation ("mma": for a bf16 tile w and r are rounded to bf16 first,
//   the probe's `mxu`; for an f32 tile the operands are rounded to TF32).
// - experiments/kernel_probe5.py (`local_kernel`/`local_fused`): separate
//   y, ws and optional o columns, optional sum of residuals.
// - experiments/kernel_probe.py, kernel_probe2.py and kernel_probe3.py
//   (`make_kernel`/`fused`): the separate form with neither offsets nor the
//   sum of residuals, logistic loss, each product on the matrix or the
//   vector unit. Their bf16 products that promote an f32 operand (probe 1's
//   `mxu` margins with an f32 w) or cast the tile up (probe 3's `mxu_cast`)
//   compute f32 products on the widened tile: the "mma_tf32" unit, which
//   widens the staged bf16 tile to f32 (exactly) and runs m16n8k8 TF32
//   mma.sync with w and r rounded to TF32. Probes 2 and 3 also round w to
//   the tile's type before the kernel; the wrapper does the same.
//
// For X [n, d] (f32 or bf16), coefficients w [d] (f32), a margin shift s:
//
//   m_i = x_i . w + (o_i - s)          (l_i, dz_i) = loss(m_i, y_i)
//   value = sum_i ws_i l_i    grad = sum_i r_i x_i    rsum = sum_i r_i
//   with r_i = ws_i dz_i
//
// An absent input (o in the separate form) is not read and an absent output
// (rsum) is not written.
//
// Bound on an H100 (3.35 TB/s): the bytes of X read once plus 12 n bytes of
// aux over the memory rate: 0.080 ms at n = 2^17, d = 512 in f32, 0.040 ms
// in bf16. The arithmetic (4 n d flops) is far below either unit's peak, so
// the unit changes how many instructions a tile costs, not the bound.
//
// Design (that of csrc/fused_glm.cu, which this file does not change): the
// TPU kernel's serialized grid with a first-step initialisation becomes a
// persistent grid; a block stages tiles of kRows rows in shared memory with
// 16-byte cp.async copies, two buffers deep, computes the tile's margins
// and then its gradient contribution from the same staged tile, and owns
// one row of per-block partials in which every column belongs to one
// thread. A second kernel adds the partials in block order. No float
// atomics: repeated calls are bitwise equal. Ragged n and d are masked
// here; X is never copied or padded.
//
// mma.sync fragments (PTX ISA, m16n8k16 bf16 and m16n8k8 tf32): the margin
// product takes the tile as A [16 rows, k] and w replicated across the 8
// columns of B, each warp a strided share of the k chunks, the warps'
// partial margins added in warp order through shared memory. The gradient
// product takes the transposed tile as A [16 columns, 16 rows] and r
// replicated across B; a warp owns a strided share of the column chunks.
//
// One staged pass holds 2 * kRows * d * itemsize <= kStageBytesMax, i.e.
// d <= 1536 for f32 and d <= 3072 for bf16 at 16 rows a tile (half that at
// 32); wider blocks are refused (the separate-column kernel of
// csrc/fused_glm.cu takes them).
//
// The kernel allocates nothing. Every entry point returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Rows per staged tile: 16 unless the including file asks for another
// multiple of 16 (packed_glm_r32.cu builds the 32-row variant of this source).
#ifndef PACKED_GLM_ROWS
#define PACKED_GLM_ROWS 16
#endif
constexpr int kRows = PACKED_GLM_ROWS;
static_assert(kRows % 16 == 0 && kRows >= 16 && kRows <= 64, "tile rows: a multiple of 16");
// r[kRows] | per-warp value and rsum | per-warp partial margins [kWarps][kRows]
constexpr int kHeaderBytes = 4096;
static_assert((kRows + 2 * kWarps + kWarps * kRows) * 4 <= kHeaderBytes, "header too small");
constexpr int kStageBytesMax = 192 * 1024;

enum LossId { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };
// kMmaTf32 on an f32 tile is kMma (both TF32); on a bf16 tile it is the TF32
// product of the widened tile rather than the bf16 product.
enum UnitId { kFma = 0, kMma = 1, kMmaTf32 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The four losses of photon_ml_torch/ops/losses.py, in f32.
template <int LOSS>
__device__ __forceinline__ void loss_and_dz(float z, float y, float& l, float& dz) {
  if (LOSS == kLogistic) {
    l = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - y * z;
    dz = 1.f / (1.f + expf(-z)) - y;
  } else if (LOSS == kSquared) {
    const float diff = z - y;
    l = 0.5f * diff * diff;
    dz = diff;
  } else if (LOSS == kPoisson) {
    const float ez = expf(z);
    l = ez - y * z;
    dz = ez - y;
  } else {
    const float sgn = 2.f * y - 1.f;
    const float t = sgn * z;
    float dt;
    if (t <= 0.f) {
      l = 0.5f - t;
      dt = -1.f;
    } else if (t < 1.f) {
      l = 0.5f * ((1.f - t) * (1.f - t));
      dt = t - 1.f;
    } else {
      l = 0.f;
      dt = 0.f;
    }
    dz = sgn * dt;
  }
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return kHeaderBytes + 2 * (size_t)kRows * d * sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prior_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ int tile_rows(int64_t t, int64_t n) {
  const int64_t left = n - t * kRows;
  return (int)(left < kRows ? left : kRows);
}

// Start copying tile t of x into buf: 16-byte cp.async copies, then the
// sub-16-byte tail (only in a ragged last tile) with plain loads.
template <typename T>
__device__ __forceinline__ void stage_tile(T* buf, const T* x, int64_t t, int64_t n, int d,
                                           int tid) {
  const int64_t count = (int64_t)tile_rows(t, n) * d;
  const T* src = x + t * kRows * (int64_t)d;
  const int64_t vecs = count * (int64_t)sizeof(T) / 16;
  const char* src_b = reinterpret_cast<const char*>(src);
  char* dst_b = reinterpret_cast<char*>(buf);
  for (int64_t i = tid; i < vecs; i += kThreads) cp_async16(dst_b + i * 16, src_b + i * 16);
  for (int64_t i = vecs * 16 / (int64_t)sizeof(T) + tid; i < count; i += kThreads)
    buf[i] = src[i];
}

// ---- tensor-core fragments -------------------------------------------------

__device__ __forceinline__ void mma_bf16_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_m16n8k8(float (&c)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t out;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(out) : "f"(v));
  return out;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Tile element [row, col] as mma operand bits, 0 outside the tile's rows and
// the block's columns (a ragged tile's unused rows hold stale values).
__device__ __forceinline__ uint32_t tile_bits(const float* tile, int row, int col, int rows,
                                              int d) {
  return (row < rows && col < d) ? tf32_bits(tile[(int64_t)row * d + col]) : 0u;
}
__device__ __forceinline__ uint32_t tile_bits(const __nv_bfloat16* tile, int row, int col,
                                              int rows, int d) {
  return (row < rows && col < d) ? (uint32_t)__bfloat16_as_ushort(tile[(int64_t)row * d + col])
                                 : 0u;
}

// Tile element [row, col] as a TF32 operand: an f32 element rounds to TF32; a
// bf16 element widens to f32, which TF32 holds exactly (8 mantissa bits).
__device__ __forceinline__ uint32_t tf32_tile_bits(const float* tile, int row, int col, int rows,
                                                   int d) {
  return tile_bits(tile, row, col, rows, d);
}
__device__ __forceinline__ uint32_t tf32_tile_bits(const __nv_bfloat16* tile, int row, int col,
                                                   int rows, int d) {
  return (row < rows && col < d) ? __float_as_uint(__bfloat162float(tile[(int64_t)row * d + col]))
                                 : 0u;
}

// Partial margins of 16 tile rows (a row block of the tile: ``rows`` counts the
// valid ones from ``tile`` on) over this warp's share of the k chunks, left in
// part[0..15] (part is this warp's row of shared memory at that row block).
__device__ __forceinline__ void margins_mma(const __nv_bfloat16* tile, const float* __restrict__ w,
                                            int rows, int d, int warp, int lane, float* part) {
  const int g = lane >> 2, tig = lane & 3;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const int chunks = (d + 15) / 16;
  for (int ch = warp; ch < chunks; ch += kWarps) {
    const int k0 = ch * 16 + 2 * tig;
    uint32_t a[4], b[2];
    a[0] = tile_bits(tile, g, k0, rows, d) | (tile_bits(tile, g, k0 + 1, rows, d) << 16);
    a[1] = tile_bits(tile, g + 8, k0, rows, d) | (tile_bits(tile, g + 8, k0 + 1, rows, d) << 16);
    a[2] = tile_bits(tile, g, k0 + 8, rows, d) | (tile_bits(tile, g, k0 + 9, rows, d) << 16);
    a[3] = tile_bits(tile, g + 8, k0 + 8, rows, d) |
           (tile_bits(tile, g + 8, k0 + 9, rows, d) << 16);
    const uint32_t w0 = k0 < d ? bf16_bits(__ldg(w + k0)) : 0u;
    const uint32_t w1 = k0 + 1 < d ? bf16_bits(__ldg(w + k0 + 1)) : 0u;
    const uint32_t w8 = k0 + 8 < d ? bf16_bits(__ldg(w + k0 + 8)) : 0u;
    const uint32_t w9 = k0 + 9 < d ? bf16_bits(__ldg(w + k0 + 9)) : 0u;
    b[0] = w0 | (w1 << 16);
    b[1] = w8 | (w9 << 16);
    mma_bf16_m16n8k16(c, a, b);
  }
  if (tig == 0) {
    part[g] = c[0];
    part[g + 8] = c[2];
  }
}

// The TF32 margin product (an f32 tile, or a bf16 tile widened to f32).
template <typename T>
__device__ __forceinline__ void margins_tf32(const T* tile, const float* __restrict__ w, int rows,
                                             int d, int warp, int lane, float* part) {
  const int g = lane >> 2, tig = lane & 3;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const int chunks = (d + 7) / 8;
  for (int ch = warp; ch < chunks; ch += kWarps) {
    const int k0 = ch * 8 + tig;
    uint32_t a[4], b[2];
    a[0] = tf32_tile_bits(tile, g, k0, rows, d);
    a[1] = tf32_tile_bits(tile, g + 8, k0, rows, d);
    a[2] = tf32_tile_bits(tile, g, k0 + 4, rows, d);
    a[3] = tf32_tile_bits(tile, g + 8, k0 + 4, rows, d);
    b[0] = k0 < d ? tf32_bits(__ldg(w + k0)) : 0u;
    b[1] = k0 + 4 < d ? tf32_bits(__ldg(w + k0 + 4)) : 0u;
    mma_tf32_m16n8k8(c, a, b);
  }
  if (tig == 0) {
    part[g] = c[0];
    part[g + 8] = c[2];
  }
}

// gacc[col] += sum_i r[i] * tile[i, col] over all kRows tile rows and this
// warp's share of the column chunks; r holds 0 for a ragged tile's unused rows.
__device__ __forceinline__ void gradient_mma(const __nv_bfloat16* tile, const float* r, int rows,
                                             int d, int warp, int lane, float* gacc) {
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = 2 * tig;
  const int chunks = (d + 15) / 16;
  for (int ch = warp; ch < chunks; ch += kWarps) {
    const int c0 = ch * 16 + g;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int rb = 0; rb < kRows; rb += 16) {  // 16 tile rows are one k step
      uint32_t a[4], b[2];
      b[0] = bf16_bits(r[rb + k0]) | (bf16_bits(r[rb + k0 + 1]) << 16);
      b[1] = bf16_bits(r[rb + k0 + 8]) | (bf16_bits(r[rb + k0 + 9]) << 16);
      a[0] = tile_bits(tile, rb + k0, c0, rows, d) |
             (tile_bits(tile, rb + k0 + 1, c0, rows, d) << 16);
      a[1] = tile_bits(tile, rb + k0, c0 + 8, rows, d) |
             (tile_bits(tile, rb + k0 + 1, c0 + 8, rows, d) << 16);
      a[2] = tile_bits(tile, rb + k0 + 8, c0, rows, d) |
             (tile_bits(tile, rb + k0 + 9, c0, rows, d) << 16);
      a[3] = tile_bits(tile, rb + k0 + 8, c0 + 8, rows, d) |
             (tile_bits(tile, rb + k0 + 9, c0 + 8, rows, d) << 16);
      mma_bf16_m16n8k16(c, a, b);
    }
    if (tig == 0) {
      if (c0 < d) gacc[c0] += c[0];
      if (c0 + 8 < d) gacc[c0 + 8] += c[2];
    }
  }
}

// The TF32 gradient product (an f32 tile, or a bf16 tile widened to f32).
template <typename T>
__device__ __forceinline__ void gradient_tf32(const T* tile, const float* r, int rows, int d,
                                              int warp, int lane, float* gacc) {
  const int g = lane >> 2, tig = lane & 3;
  const int chunks = (d + 15) / 16;
  for (int ch = warp; ch < chunks; ch += kWarps) {
    const int c0 = ch * 16 + g;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int rb = 0; rb < kRows; rb += 8) {  // 8 tile rows are one k step
      uint32_t a[4], b[2];
      b[0] = tf32_bits(r[rb + tig]);
      b[1] = tf32_bits(r[rb + tig + 4]);
      a[0] = tf32_tile_bits(tile, rb + tig, c0, rows, d);
      a[1] = tf32_tile_bits(tile, rb + tig, c0 + 8, rows, d);
      a[2] = tf32_tile_bits(tile, rb + tig + 4, c0, rows, d);
      a[3] = tf32_tile_bits(tile, rb + tig + 4, c0 + 8, rows, d);
      mma_tf32_m16n8k8(c, a, b);
    }
    if (tig == 0) {
      if (c0 < d) gacc[c0] += c[0];
      if (c0 + 8 < d) gacc[c0 + 8] += c[2];
    }
  }
}

// ---- the partials kernel -----------------------------------------------------

// A product in bf16 mma.sync: the "mma" unit on a bf16 tile. Every other
// tensor-core product (an f32 tile, or "mma_tf32") runs in TF32.
template <typename T, int UNIT>
constexpr bool kBf16Mma = UNIT == kMma && sizeof(T) == 2;

// aux != nullptr: the packed form, row i = (y, o, ws). Otherwise the separate
// form: labels and weights, and offsets unless nullptr. part_rsum == nullptr:
// the sum of residuals is neither accumulated nor written.
template <int LOSS, typename T, int MUNIT, int GUNIT>
__global__ void __launch_bounds__(kThreads)
packed_glm_partials_kernel(const T* __restrict__ x, const float* __restrict__ aux,
                           const float* __restrict__ labels, const float* __restrict__ offsets,
                           const float* __restrict__ weights, const float* __restrict__ w,
                           const float* __restrict__ shift, int64_t n, int d,
                           float* __restrict__ part_value, float* __restrict__ part_rsum,
                           float* __restrict__ part_grad) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* r_s = reinterpret_cast<float*>(smem);           // [kRows]
  float* red_s = r_s + kRows;                            // [2 * kWarps]
  float* marg_s = red_s + 2 * kWarps;                    // [kWarps][kRows]
  T* tiles = reinterpret_cast<T*>(smem + kHeaderBytes);  // 2 x [kRows, d]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* gacc = part_grad + (int64_t)blockIdx.x * d;
  for (int c = tid; c < d; c += kThreads) gacc[c] = 0.f;
  const float s = shift != nullptr ? *shift : 0.f;
  const bool with_rsum = part_rsum != nullptr;
  // every lane of a warp holds the same sums
  float value_acc = 0.f;
  float rsum_acc = 0.f;

  const int64_t ntiles = (n + kRows - 1) / kRows;
  if ((int64_t)blockIdx.x < ntiles) stage_tile(tiles, x, blockIdx.x, n, d, tid);
  cp_async_commit();
  int k = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++k) {
    const int64_t row0 = t * kRows;
    const int rows = tile_rows(t, n);
    T* tile = tiles + (size_t)(k & 1) * kRows * d;
    // the next tile's copy goes into the other buffer, which every thread
    // left at the last barrier of the previous iteration
    const int64_t next = t + gridDim.x;
    if (next < ntiles) stage_tile(tiles + (size_t)((k + 1) & 1) * kRows * d, x, next, n, d, tid);
    cp_async_commit();
    cp_async_wait_prior_one();  // this thread's copies of tile t have landed
    __syncthreads();            // and everyone else's (and gacc is zeroed)

    if (MUNIT != kFma) {
#pragma unroll
      for (int rb = 0; rb < kRows; rb += 16) {
        if constexpr (kBf16Mma<T, MUNIT>)
          margins_mma(tile + (int64_t)rb * d, w, rows - rb, d, warp, lane,
                      marg_s + warp * kRows + rb);
        else
          margins_tf32(tile + (int64_t)rb * d, w, rows - rb, d, warp, lane,
                       marg_s + warp * kRows + rb);
      }
      __syncthreads();
    }
    for (int i = warp; i < kRows; i += kWarps) {
      float r = 0.f;
      if (i < rows) {  // warp-uniform
        float acc = 0.f;
        if (MUNIT != kFma) {
#pragma unroll
          for (int q = 0; q < kWarps; ++q) acc += marg_s[q * kRows + i];
        } else {
          const T* xr = tile + (int64_t)i * d;
#pragma unroll 4
          for (int c = lane; c < d; c += 32) acc += to_float(xr[c]) * __ldg(w + c);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        }
        const int64_t row = row0 + i;
        float y, o, wt;
        if (aux != nullptr) {
          const float* rec = aux + 3 * row;
          y = __ldg(rec);
          o = __ldg(rec + 1);
          wt = __ldg(rec + 2);
        } else {
          y = __ldg(labels + row);
          o = offsets != nullptr ? __ldg(offsets + row) : 0.f;
          wt = __ldg(weights + row);
        }
        const float m = acc + (o - s);
        float l, dz;
        loss_and_dz<LOSS>(m, y, l, dz);
        r = wt * dz;
        value_acc += wt * l;
        if (with_rsum) rsum_acc += r;
      }
      if (lane == 0) r_s[i] = r;
    }
    __syncthreads();

    if constexpr (kBf16Mma<T, GUNIT>) {
      gradient_mma(tile, r_s, rows, d, warp, lane, gacc);
    } else if constexpr (GUNIT != kFma) {
      gradient_tf32(tile, r_s, rows, d, warp, lane, gacc);
    } else {
      for (int c = tid; c < d; c += kThreads) {
        float g = 0.f;
#pragma unroll 8
        for (int i = 0; i < rows; ++i) g += r_s[i] * to_float(tile[(int64_t)i * d + c]);
        gacc[c] += g;
      }
    }
    __syncthreads();  // the next tile overwrites tile, r_s and marg_s
  }

  if (lane == 0) {
    red_s[warp] = value_acc;
    red_s[kWarps + warp] = rsum_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float v = 0.f, rs = 0.f;
    for (int q = 0; q < kWarps; ++q) {
      v += red_s[q];
      rs += red_s[kWarps + q];
    }
    part_value[blockIdx.x] = v;
    if (with_rsum) part_rsum[blockIdx.x] = rs;
  }
}

// Sums the per-block partials in a fixed order: a block owns 32 gradient
// columns, warp k sums partial rows k, k + kReduceWarps, ... of its lane's
// column, then warp 0 adds the warps' sums in warp order. Warp 0 of block 0
// also sums value and, unless absent, rsum.
constexpr int kReduceWarps = 32;

__global__ void __launch_bounds__(kReduceWarps * 32)
packed_glm_reduce_kernel(const float* __restrict__ part_value,
                         const float* __restrict__ part_rsum,
                         const float* __restrict__ part_grad, int blocks, int d,
                         float* __restrict__ value, float* __restrict__ rsum,
                         float* __restrict__ grad) {
  __shared__ float sums[kReduceWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float g = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kReduceWarps) g += part_grad[(int64_t)b * d + c];
  }
  sums[warp][lane] = g;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) t += sums[k][lane];
    grad[c] = t;
  }
  if (blockIdx.x == 0 && warp == 0) {
    const bool with_rsum = part_rsum != nullptr;
    float v = 0.f, rs = 0.f;
    for (int b = lane; b < blocks; b += 32) {
      v += part_value[b];
      if (with_rsum) rs += part_rsum[b];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    }
    if (lane == 0) {
      *value = v;
      if (with_rsum) *rsum = rs;
    }
  }
}

struct PartialsArgs {
  const void* x;
  const float* aux;
  const float* labels;
  const float* offsets;
  const float* weights;
  const float* w;
  const float* shift;
  int64_t n;
  int d;
  int blocks;
  float* part_value;
  float* part_rsum;
  float* part_grad;
};

struct KernelOps {
  cudaError_t (*launch)(const PartialsArgs&, cudaStream_t);
  cudaError_t (*occupancy)(int*, int);
};

template <int LOSS, typename T, int MUNIT, int GUNIT>
cudaError_t set_smem(size_t bytes) {
  return cudaFuncSetAttribute(packed_glm_partials_kernel<LOSS, T, MUNIT, GUNIT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int LOSS, typename T, int MUNIT, int GUNIT>
cudaError_t launch_partials(const PartialsArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(a.d);
  cudaError_t err = set_smem<LOSS, T, MUNIT, GUNIT>(bytes);
  if (err != cudaSuccess) return err;
  packed_glm_partials_kernel<LOSS, T, MUNIT, GUNIT><<<a.blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.x), a.aux, a.labels, a.offsets, a.weights, a.w, a.shift, a.n, a.d,
      a.part_value, a.part_rsum, a.part_grad);
  return cudaGetLastError();
}

template <int LOSS, typename T, int MUNIT, int GUNIT>
cudaError_t occupancy(int* blocks_per_sm, int d) {
  const size_t bytes = smem_bytes<T>(d);
  cudaError_t err = set_smem<LOSS, T, MUNIT, GUNIT>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, packed_glm_partials_kernel<LOSS, T, MUNIT, GUNIT>, kThreads, bytes);
}

template <int LOSS, typename T, int MUNIT, int GUNIT>
KernelOps ops_of() {
  return {launch_partials<LOSS, T, MUNIT, GUNIT>, occupancy<LOSS, T, MUNIT, GUNIT>};
}

// Units kFma, kMma and, on a bf16 tile with the logistic loss (the only loss
// of the probes that use it), kMmaTf32; on an f32 tile the caller has already
// mapped kMmaTf32 to kMma: both are TF32 there.
template <int LOSS, typename T>
constexpr bool kHasMmaTf32 = sizeof(T) == 2 && LOSS == kLogistic;

template <int LOSS, typename T, int MUNIT>
KernelOps ops_for_grad_unit(int gunit) {
  if (gunit == kFma) return ops_of<LOSS, T, MUNIT, kFma>();
  if (gunit == kMma) return ops_of<LOSS, T, MUNIT, kMma>();
  if constexpr (kHasMmaTf32<LOSS, T>) {
    if (gunit == kMmaTf32) return ops_of<LOSS, T, MUNIT, kMmaTf32>();
  }
  return {nullptr, nullptr};
}

template <int LOSS, typename T>
KernelOps ops_for_units(int munit, int gunit) {
  if (sizeof(T) == 4) {
    if (munit == kMmaTf32) munit = kMma;
    if (gunit == kMmaTf32) gunit = kMma;
  }
  if (munit == kFma) return ops_for_grad_unit<LOSS, T, kFma>(gunit);
  if (munit == kMma) return ops_for_grad_unit<LOSS, T, kMma>(gunit);
  if constexpr (kHasMmaTf32<LOSS, T>) {
    if (munit == kMmaTf32) return ops_for_grad_unit<LOSS, T, kMmaTf32>(gunit);
  }
  return {nullptr, nullptr};
}

template <typename T>
KernelOps ops_for_loss(int loss, int munit, int gunit) {
  switch (loss) {
    case kLogistic: return ops_for_units<kLogistic, T>(munit, gunit);
    case kSquared: return ops_for_units<kSquared, T>(munit, gunit);
    case kPoisson: return ops_for_units<kPoisson, T>(munit, gunit);
    case kSmoothedHinge: return ops_for_units<kSmoothedHinge, T>(munit, gunit);
    default: return {nullptr, nullptr};
  }
}

int max_staged_d(int itemsize) { return kStageBytesMax / (2 * kRows * itemsize); }

KernelOps select_ops(int loss, int is_bf16, int munit, int gunit, int d) {
  if (d < 1 || d > max_staged_d(is_bf16 ? 2 : 4)) return {nullptr, nullptr};
  return is_bf16 ? ops_for_loss<__nv_bfloat16>(loss, munit, gunit)
                 : ops_for_loss<float>(loss, munit, gunit);
}

}  // namespace

extern "C" {

// Largest d the kernel takes, for a 4-byte (f32) or 2-byte (bf16) feature type.
int packed_glm_max_staged_d(int itemsize) { return max_staged_d(itemsize); }

// Grid size of the partials kernel for this variant and shape on the current
// device: as many blocks as can be resident at once, at most one per tile
// and at least one. Written to *blocks.
int packed_glm_grid_blocks(int loss, int is_bf16, int munit, int gunit, long long n, int d,
                           int* blocks) {
  const KernelOps ops = select_ops(loss, is_bf16, munit, gunit, d);
  if (ops.occupancy == nullptr) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = ops.occupancy(&per_sm, d);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (n + kRows - 1) / kRows;
  long long b = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (b > ntiles) b = ntiles;
  *blocks = b < 1 ? 1 : (int)b;
  return (int)cudaSuccess;
}

// Per-block partials: part_value[blocks], part_rsum[blocks] (or null),
// part_grad[blocks, d]. aux [n, 3] selects the packed form; with aux null the
// separate labels/weights (and offsets, or null) are read. x must be
// contiguous and 16-byte aligned.
int packed_glm_partials(int loss, int is_bf16, int munit, int gunit, const void* x,
                        const void* aux, const void* labels, const void* offsets,
                        const void* weights, const void* w, const void* shift, long long n, int d,
                        int blocks, void* part_value, void* part_rsum, void* part_grad,
                        void* stream) {
  const KernelOps ops = select_ops(loss, is_bf16, munit, gunit, d);
  if (ops.launch == nullptr) return (int)cudaErrorInvalidValue;
  if (aux == nullptr && (labels == nullptr || weights == nullptr))
    return (int)cudaErrorInvalidValue;
  const PartialsArgs args{x,
                          static_cast<const float*>(aux),
                          static_cast<const float*>(labels),
                          static_cast<const float*>(offsets),
                          static_cast<const float*>(weights),
                          static_cast<const float*>(w),
                          static_cast<const float*>(shift),
                          (int64_t)n,
                          d,
                          blocks,
                          static_cast<float*>(part_value),
                          static_cast<float*>(part_rsum),
                          static_cast<float*>(part_grad)};
  return (int)ops.launch(args, static_cast<cudaStream_t>(stream));
}

// value[1], grad[d] and, unless part_rsum is null, rsum[1] from the partials,
// summed in block order.
int packed_glm_reduce(const void* part_value, const void* part_rsum, const void* part_grad,
                      int blocks, int d, void* value, void* rsum, void* grad, void* stream) {
  const int grid = d > 0 ? (d + 31) / 32 : 1;
  packed_glm_reduce_kernel<<<grid, kReduceWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_value), static_cast<const float*>(part_rsum),
      static_cast<const float*>(part_grad), blocks, d, static_cast<float*>(value),
      static_cast<float*>(rsum), static_cast<float*>(grad));
  return (int)cudaGetLastError();
}

}  // extern "C"
