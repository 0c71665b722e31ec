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
// in bf16. The arithmetic (4 n d flops, about 2 flops a byte in bf16) is
// far below either unit's peak, so the unit changes how many instructions a
// tile costs, not the bound.
//
// Design. A persistent grid; a block walks its tiles of kRows rows in
// strided order and owns one row of per-block partials; a second kernel adds
// the partials in a fixed order (glm_tile.cuh, `reduce_partials_kernel`,
// shared with B1). No float atomics: repeated calls are bitwise equal. X is
// never copied or padded in device memory.
//
// - Staging (the helpers in csrc/glm_tile.cuh, shared with B1 in
//   csrc/fused_glm.cu): a ring of 2-4 stages in shared memory (as many as fit in
//   kRingBytes, so that two blocks share an SM; two when both products are
//   on the FMA unit, which leans on more resident blocks), filled with cp.async
//   (16-byte copies where a row's bytes allow, else 8, 4, or plain 2-byte
//   copies for a bf16 row of odd d). A staged row has the pitch
//   round_up(d, 16) + 8 elements: the 8 extra elements shift successive rows
//   by an odd number of 16-byte bank groups (bf16) or by 8 banks (f32), so
//   every fragment load below is free of bank conflicts. The columns
//   [d, round_up(d, 16)) are zeroed once per block and the rows past a
//   ragged tile's end are zeroed when it is staged, so the inner loops carry
//   no bounds checks. One barrier per tile hands a stage from its copies to
//   its readers, a second one hands the margins to the loss.
// - Margins: on the tensor cores each warp takes the 16-column chunks ch =
//   warp, warp + 8, ... of every 16-row block of the tile; bf16 A fragments
//   come from one ldmatrix.x4 each, TF32 fragments from 8-byte (f32) or
//   4-byte (bf16, widened) vector loads, with the k order inside a chunk
//   permuted so that each lane's two k values are adjacent (a dot product
//   may take its terms in any fixed order). w's B fragments (bf16 pairs in
//   fragment order, or TF32 bits) are built in shared memory once per block.
//   The warps' partial margins meet in shared memory (double-buffered by
//   tile parity) and every warp adds them in warp order. On the FMA unit a
//   warp takes whole rows.
// - Loss: every warp evaluates the loss of the tile's rows, one row a lane,
//   so the residuals reach the gradient's B fragments by warp shuffles with
//   no further barrier; warp 0 alone keeps the value and residual sums.
// - Gradient: each warp owns the same column chunks for the whole kernel and
//   carries their C fragments in registers across all its tiles (bf16 A
//   fragments by ldmatrix.x4.trans, TF32 ones by vector loads with the
//   column order inside a chunk permuted); on the FMA unit each thread owns
//   the columns tid, tid + 256, ... in registers. The block's partial row is
//   written once, at the end.
//
// mma.sync shapes (PTX ISA): m16n8k16 bf16 and m16n8k8 tf32, f32
// accumulation. The margin product takes the tile as A [16 rows, k] and w
// replicated across the 8 columns of B; the gradient product takes the
// transposed tile as A [16 columns, rows] and r replicated across B.
//
// Width: the gradient registers hold kMaxChunks chunks a warp, so d <=
// kWarps * kMaxChunks * 16 = 1536; two stages must fit in kStageBytesMax,
// which at 32 rows a tile holds f32 rows up to d = 784. Wider blocks are
// refused (the separate-column kernel of csrc/fused_glm.cu takes them).
//
// The kernel allocates nothing. Every entry point returns
// cudaGetLastError() (0 on success).

#include "glm_tile.cuh"

namespace {

using namespace glm_tile;

// Rows per staged tile: 16 unless the including file asks for 32
// (packed_glm_r32.cu builds the 32-row variant of this source).
#ifndef PACKED_GLM_ROWS
#define PACKED_GLM_ROWS 16
#endif
constexpr int kRows = PACKED_GLM_ROWS;
static_assert(kRows == 16 || kRows == 32, "tile rows: 16 or 32 (one row a lane in the loss)");
// Gradient column chunks of 16 a warp holds in registers, and the FMA
// gradient's columns a thread holds: both cover d <= kMaxD.
constexpr int kMaxChunks = 12;
constexpr int kMaxD = kWarps * kMaxChunks * 16;
constexpr int kMaxFmaCols = kMaxD / kThreads;
// Two stages of the widest row must fit here; more stages only while the
// ring stays within kRingBytes (two blocks to an SM).
constexpr int kStageBytesMax = 200 * 1024;
constexpr int kRingBytes = 104 * 1024;
constexpr int kMaxStages = 4;

// kMmaTf32 on an f32 tile is kMma (both TF32); on a bf16 tile it is the TF32
// product of the widened tile rather than the bf16 product.
enum UnitId { kFma = 0, kMma = 1, kMmaTf32 = 2 };

// ---- shared-memory geometry (host and device) --------------------------------

// marg[2][kWarps][kRows] f32 | w fragments (round_up(d, 16) x 4 bytes) | stages
__host__ __device__ constexpr size_t marg_bytes() { return 2 * kWarps * kRows * 4; }
__host__ __device__ constexpr size_t wfrag_bytes(int d) { return (size_t)round_up(d, 16) * 4; }
__host__ __device__ constexpr size_t stage_bytes(int d, int itemsize) {
  return (size_t)kRows * pitch_of(d) * itemsize;
}

// Two stages when both products are on the FMA unit, which reads w and the
// aux columns through L1, the other part of the SM's 256 KB: the ring of up
// to four read 0.0806 ms against 0.0761 at [2^17, 512] bf16, and 0.0625
// against 0.0598 at [2^17, 256] f32 (H100 80GB HBM3 at 700 W,
// dev/torch_kernel_ab.py on that variant of this source).
int stages_for(int d, int itemsize, bool fma_only) {
  if (fma_only) return 2;
  const int fit = (int)(kRingBytes / stage_bytes(d, itemsize));
  return fit < 2 ? 2 : (fit > kMaxStages ? kMaxStages : fit);
}

size_t smem_bytes(int d, int itemsize, bool fma_only) {
  return marg_bytes() + wfrag_bytes(d) +
         stages_for(d, itemsize, fma_only) * stage_bytes(d, itemsize);
}

int max_staged_d(int itemsize) {
  const int by_smem = (kStageBytesMax / (2 * kRows * itemsize) - 8) / 16 * 16;
  return by_smem < kMaxD ? by_smem : kMaxD;
}

// ---- staging -------------------------------------------------------------------

__device__ __forceinline__ int tile_rows(int64_t t, int64_t n) {
  const int64_t left = n - t * kRows;
  return (int)(left < kRows ? left : kRows);
}

// Start staging tile t of x: its rows at pitch `pitch`, and zeros in the
// rows past a ragged tile's end (the pad columns were zeroed at the start).
template <typename T>
__device__ __forceinline__ void stage_tile(T* buf, const T* __restrict__ x, int64_t t, int64_t n,
                                           int d, int pitch, int tid) {
  stage_rows(buf, x + t * kRows * (int64_t)d, tile_rows(t, n), kRows, d, pitch, tid);
}

// ---- tensor-core fragments -------------------------------------------------------

__device__ __forceinline__ void mma_bf16_m16n8k16(float (&c)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_m16n8k8(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane l gives the address of row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* smem_row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* smem_row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t out;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(out) : "f"(v));
  return out;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// Two adjacent tile elements as TF32 operands: f32 rounds to TF32; bf16
// widens to f32, which TF32 holds exactly (8 mantissa bits).
__device__ __forceinline__ void tf32_pair(const float* p, uint32_t& lo, uint32_t& hi) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  lo = tf32_bits(v.x);
  hi = tf32_bits(v.y);
}
__device__ __forceinline__ void tf32_pair(const __nv_bfloat16* p, uint32_t& lo, uint32_t& hi) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  lo = v << 16;
  hi = v & 0xffff0000u;
}

// A product in bf16 mma.sync: the "mma" unit on a bf16 tile. Every other
// tensor-core product (an f32 tile, or "mma_tf32") runs in TF32.
template <typename T, int UNIT>
constexpr bool kBf16Mma = UNIT == kMma && sizeof(T) == 2;
template <typename T, int UNIT>
constexpr bool kTf32 = UNIT != kFma && !kBf16Mma<T, UNIT>;

// w's margin-product B fragments for the whole block, zero past d: bf16
// pairs in fragment order (chunk ch, lane tig: k = 16 ch + 2 tig, +1 and
// +8, +9) for the bf16 product, TF32 bits in k order for the TF32 one.
template <typename T, int MUNIT>
__device__ __forceinline__ void build_w_fragments(uint32_t* wf, const float* __restrict__ w, int d,
                                                  int tid) {
  const int padded = round_up(d, 16);
  auto wk = [&](int k) { return k < d ? __ldg(w + k) : 0.f; };
  if constexpr (kBf16Mma<T, MUNIT>) {
    for (int i = tid; i < padded / 4; i += kThreads) {
      const int k = (i >> 2) * 16 + 2 * (i & 3);
      wf[2 * i] = bf16_pair(wk(k), wk(k + 1));
      wf[2 * i + 1] = bf16_pair(wk(k + 8), wk(k + 9));
    }
  } else if constexpr (kTf32<T, MUNIT>) {
    for (int k = tid; k < padded; k += kThreads) wf[k] = tf32_bits(wk(k));
  }
}

// This warp's partial margins of the tile's rows over its k chunks, in
// c[m][0] (row 16 m + g) and c[m][2] (row 16 m + g + 8).
template <typename T, int MUNIT>
__device__ __forceinline__ void margins_mma(const T* tile, int pitch, const uint32_t* wf, int nch,
                                            int warp, int lane, float (&c)[kRows / 16][4]) {
  const int g = lane >> 2, tig = lane & 3;
  for (int ch = warp; ch < nch; ch += kWarps) {
    if constexpr (kBf16Mma<T, MUNIT>) {
      const uint2 b = reinterpret_cast<const uint2*>(wf)[ch * 4 + tig];
      const int q = lane >> 3;
      const T* row = tile + ((q & 1) * 8 + (lane & 7)) * pitch + ch * 16 + (q >> 1) * 8;
#pragma unroll
      for (int m = 0; m < kRows / 16; ++m) {
        uint32_t a[4];
        ldmatrix_x4(a, row + m * 16 * pitch);
        mma_bf16_m16n8k16(c[m], a, b.x, b.y);
      }
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // logical k tig, tig + 4 of the m16n8k8 step are columns k0 + 2 tig, +1
        const int k0 = ch * 16 + s * 8 + 2 * tig;
        const uint2 b = *reinterpret_cast<const uint2*>(wf + k0);
#pragma unroll
        for (int m = 0; m < kRows / 16; ++m) {
          uint32_t a[4];
          tf32_pair(tile + (m * 16 + g) * pitch + k0, a[0], a[2]);
          tf32_pair(tile + (m * 16 + g + 8) * pitch + k0, a[1], a[3]);
          mma_tf32_m16n8k8(c[m], a, b.x, b.y);
        }
      }
    }
  }
}

// The gradient product's B fragments of one tile from r (lane i holds row
// i's residual): bf16 pairs of rows 2 tig, +1 and +8, +9 for each 16-row k
// step, or TF32 bits for each 8-row k step (rows tig, tig + 4 for an f32
// tile; 2 tig, 2 tig + 1 for a widened bf16 tile).
template <typename T, int GUNIT>
__device__ __forceinline__ void gradient_b(float r, int tig, uint32_t (&b)[kRows / 8][2]) {
  if constexpr (kBf16Mma<T, GUNIT>) {
#pragma unroll
    for (int k = 0; k < kRows / 16; ++k) {
      const int r0 = 16 * k + 2 * tig;
      b[k][0] = bf16_pair(__shfl_sync(kFull, r, r0), __shfl_sync(kFull, r, r0 + 1));
      b[k][1] = bf16_pair(__shfl_sync(kFull, r, r0 + 8), __shfl_sync(kFull, r, r0 + 9));
    }
  } else {
    const int lo = sizeof(T) == 4 ? tig : 2 * tig, hi = sizeof(T) == 4 ? tig + 4 : 2 * tig + 1;
#pragma unroll
    for (int k = 0; k < kRows / 8; ++k) {
      b[k][0] = tf32_bits(__shfl_sync(kFull, r, 8 * k + lo));
      b[k][1] = tf32_bits(__shfl_sync(kFull, r, 8 * k + hi));
    }
  }
}

// c += (the tile's columns of chunk ch)' r for this warp's chunk ch. C rows
// are columns 16 ch + g, + 8 (bf16) or 16 ch + 2 g, + 1 (TF32).
template <typename T, int GUNIT>
__device__ __forceinline__ void gradient_mma(const T* tile, int pitch, int ch, int lane,
                                             const uint32_t (&b)[kRows / 8][2], float (&c)[4]) {
  if constexpr (kBf16Mma<T, GUNIT>) {
    const int q = lane >> 3;
    const T* row = tile + ((q >> 1) * 8 + (lane & 7)) * pitch + ch * 16 + (q & 1) * 8;
#pragma unroll
    for (int k = 0; k < kRows / 16; ++k) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, row + k * 16 * pitch);
      mma_bf16_m16n8k16(c, a, b[k][0], b[k][1]);
    }
  } else {
    const int g = lane >> 2, tig = lane & 3;
    const int lo = sizeof(T) == 4 ? tig : 2 * tig, hi = sizeof(T) == 4 ? tig + 4 : 2 * tig + 1;
    const T* col = tile + ch * 16 + 2 * g;
#pragma unroll
    for (int k = 0; k < kRows / 8; ++k) {
      uint32_t a[4];
      tf32_pair(col + (8 * k + lo) * pitch, a[0], a[1]);
      tf32_pair(col + (8 * k + hi) * pitch, a[2], a[3]);
      mma_tf32_m16n8k8(c, a, b[k][0], b[k][1]);
    }
  }
}

// ---- the partials kernel -----------------------------------------------------

// aux != nullptr: the packed form, row i = (y, o, ws). Otherwise the separate
// form: labels and weights, and offsets unless nullptr. part_rsum == nullptr:
// the sum of residuals is neither accumulated nor written.
// Two blocks to an SM where the registers allow it; the 32-row build's
// TF32 fragments need more than half of them.
template <int LOSS, typename T, int MUNIT, int GUNIT>
__global__ void __launch_bounds__(kThreads, kRows == 16 ? 2 : 1)
packed_glm_partials_kernel(const T* __restrict__ x, const float* __restrict__ aux,
                           const float* __restrict__ labels, const float* __restrict__ offsets,
                           const float* __restrict__ weights, const float* __restrict__ w,
                           const float* __restrict__ shift, int64_t n, int d, int stages,
                           float* __restrict__ part_value, float* __restrict__ part_rsum,
                           float* __restrict__ part_grad) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* marg_s = reinterpret_cast<float*>(smem);  // [2][kWarps][kRows]
  uint32_t* wf_s = reinterpret_cast<uint32_t*>(smem + marg_bytes());
  T* ring = reinterpret_cast<T*>(smem + marg_bytes() + wfrag_bytes(d));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tig = lane & 3;
  const int pitch = pitch_of(d);
  const int nch = (d + 15) / 16;
  const int stage_elems = kRows * pitch;
  const float s = shift != nullptr ? *shift : 0.f;
  const bool with_rsum = part_rsum != nullptr;
  const int64_t ntiles = (n + kRows - 1) / kRows;

  // zero the pad columns [d, round_up(d, 16)) of every staged row, once
  zero_pad_columns(ring, stages * kRows, d, pitch, tid);
  build_w_fragments<T, MUNIT>(wf_s, w, d, tid);
  for (int k = 0; k < stages - 1; ++k) {
    const int64_t t = blockIdx.x + (int64_t)k * gridDim.x;
    if (t < ntiles) stage_tile(ring + k * stage_elems, x, t, n, d, pitch, tid);
    cp_async_commit();
  }

  // the gradient, in registers for the whole kernel
  float cg[kBf16Mma<T, GUNIT> || kTf32<T, GUNIT> ? kMaxChunks : 1][4] = {};
  float gf[GUNIT == kFma ? kMaxFmaCols : 1] = {};
  // lanes of warp 0 keep the value and residual sums of their rows
  float value_acc = 0.f, rsum_acc = 0.f;

  int slot = 0;
  int parity = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    cp_async_wait(stages - 2);  // this thread's copies of tile t have landed
    __syncthreads();            // everyone's, and every warp is done with the last tile
    {
      // refill the stage that the last tile used
      const int64_t ahead = t + (int64_t)(stages - 1) * gridDim.x;
      const int ahead_slot = slot == 0 ? stages - 1 : slot - 1;
      if (ahead < ntiles) stage_tile(ring + ahead_slot * stage_elems, x, ahead, n, d, pitch, tid);
      cp_async_commit();
    }
    const T* tile = ring + slot * stage_elems;
    const int64_t row0 = t * kRows;
    const int rows = tile_rows(t, n);

    // this lane's row: its aux, loaded while the margins are computed
    float y = 0.f, o = 0.f, wt = 0.f;
    const bool mine = lane < rows;
    if (mine) {
      const int64_t row = row0 + lane;
      if (aux != nullptr) {
        y = __ldg(aux + 3 * row);
        o = __ldg(aux + 3 * row + 1);
        wt = __ldg(aux + 3 * row + 2);
      } else {
        y = __ldg(labels + row);
        o = offsets != nullptr ? __ldg(offsets + row) : 0.f;
        wt = __ldg(weights + row);
      }
    }

    float* marg = marg_s + parity * kWarps * kRows;
    if constexpr (MUNIT != kFma) {
      float c[kRows / 16][4] = {};
      margins_mma<T, MUNIT>(tile, pitch, wf_s, nch, warp, lane, c);
      if (tig == 0) {
#pragma unroll
        for (int m = 0; m < kRows / 16; ++m) {
          marg[warp * kRows + m * 16 + (lane >> 2)] = c[m][0];
          marg[warp * kRows + m * 16 + (lane >> 2) + 8] = c[m][2];
        }
      }
    } else {
      for (int i = warp; i < rows; i += kWarps) {  // warp-uniform
        const T* xr = tile + i * pitch;
        float acc = 0.f;
#pragma unroll 4
        for (int col = lane; col < d; col += 32) acc += to_float(xr[col]) * __ldg(w + col);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
        if (lane == 0) marg[i] = acc;
      }
    }
    __syncthreads();  // the margins are in marg

    float r = 0.f;
    if (mine) {
      float m = 0.f;
      if constexpr (MUNIT != kFma) {
#pragma unroll
        for (int q = 0; q < kWarps; ++q) m += marg[q * kRows + lane];
      } else {
        m = marg[lane];
      }
      float l, dz;
      loss_and_dz<LOSS>(m + (o - s), y, l, dz);
      r = wt * dz;
      if (warp == 0) {
        value_acc += wt * l;
        if (with_rsum) rsum_acc += r;
      }
    }

    if constexpr (GUNIT != kFma) {
      uint32_t b[kRows / 8][2];
      gradient_b<T, GUNIT>(r, tig, b);
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int ch = warp + j * kWarps;
        if (ch < nch) gradient_mma<T, GUNIT>(tile, pitch, ch, lane, b, cg[j]);
      }
    } else {
      float rr[kRows];  // rows past a ragged end are zero, and so is their r
#pragma unroll
      for (int i = 0; i < kRows; ++i) rr[i] = __shfl_sync(kFull, r, i);
#pragma unroll
      for (int j = 0; j < kMaxFmaCols; ++j) {
        const int col = tid + j * kThreads;
        if (col < d) {
          float acc = gf[j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc += rr[i] * to_float(tile[i * pitch + col]);
          gf[j] = acc;
        }
      }
    }
    if (++slot == stages) slot = 0;
    parity ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::);

  float* pg = part_grad + (int64_t)blockIdx.x * d;
  if constexpr (GUNIT != kFma) {
    const int g = lane >> 2;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int ch = warp + j * kWarps;
      if (ch < nch && tig == 0) {
        const int c0 = kBf16Mma<T, GUNIT> ? ch * 16 + g : ch * 16 + 2 * g;
        const int c1 = kBf16Mma<T, GUNIT> ? c0 + 8 : c0 + 1;
        if (c0 < d) pg[c0] = cg[j][0];
        if (c1 < d) pg[c1] = cg[j][2];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxFmaCols; ++j) {
      const int col = tid + j * kThreads;
      if (col < d) pg[col] = gf[j];
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      value_acc += __shfl_xor_sync(kFull, value_acc, off);
      rsum_acc += __shfl_xor_sync(kFull, rsum_acc, off);
    }
    if (lane == 0) {
      part_value[blockIdx.x] = value_acc;
      if (with_rsum) part_rsum[blockIdx.x] = rsum_acc;
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

template <int MUNIT, int GUNIT>
constexpr bool kFmaOnly = MUNIT == kFma && GUNIT == kFma;

template <int LOSS, typename T, int MUNIT, int GUNIT>
cudaError_t launch_partials(const PartialsArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.d, sizeof(T), kFmaOnly<MUNIT, GUNIT>);
  cudaError_t err = set_smem<LOSS, T, MUNIT, GUNIT>(bytes);
  if (err != cudaSuccess) return err;
  packed_glm_partials_kernel<LOSS, T, MUNIT, GUNIT><<<a.blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.x), a.aux, a.labels, a.offsets, a.weights, a.w, a.shift, a.n, a.d,
      stages_for(a.d, sizeof(T), kFmaOnly<MUNIT, GUNIT>), a.part_value, a.part_rsum,
      a.part_grad);
  return cudaGetLastError();
}

template <int LOSS, typename T, int MUNIT, int GUNIT>
cudaError_t occupancy(int* blocks_per_sm, int d) {
  const size_t bytes = smem_bytes(d, sizeof(T), kFmaOnly<MUNIT, GUNIT>);
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
// summed in the fixed order of glm_tile.cuh's reduce_partials_kernel.
int packed_glm_reduce(const void* part_value, const void* part_rsum, const void* part_grad,
                      int blocks, int d, void* value, void* rsum, void* grad, void* stream) {
  return (int)launch_reduce(static_cast<const float*>(part_value),
                            static_cast<const float*>(part_rsum),
                            static_cast<const float*>(part_grad), blocks, d,
                            static_cast<float*>(value), static_cast<float*>(rsum),
                            static_cast<float*>(grad), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
