// Fused GLM value + gradient in one pass over the feature block, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// photon_ml_torch/ops/fused_glm.py.
//
// Replaces the TPU kernel photon_ml_tpu/ops/pallas_glm.py (`_kernel`, the
// body, and `_fused_padded`, its pallas_call). For X [n, d] (f32 or bf16),
// labels y, offsets o, weights ws [n] (f32), effective coefficients w [d]
// (f32) and an optional margin shift s (one f32 on the device):
//
//   m_i = x_i . w + (o_i - s)          (l_i, dz_i) = loss(m_i, y_i)
//   value = sum_i ws_i l_i    grad = sum_i r_i x_i    rsum = sum_i r_i
//   with r_i = ws_i dz_i
//
// The wrapper folds normalization and L2 in around these three outputs.
// Every product is an f32 FMA on the widened tile with f32 w and r (no
// tensor cores: TF32 or bf16 rounding of w and r would be another function).
//
// Bound on an H100 (3.35 TB/s): the bytes of X, read once, plus 12 n bytes
// of y/o/ws and 4 d of w, over the memory rate; at n = 2^18, d = 512, f32
// that is 0.16 ms. The arithmetic (4 n d flops) is ~30x below the f32 peak.
//
// Design (the staging and the losses are csrc/glm_tile.cuh, shared with the
// packed-aux kernel of csrc/packed_glm.cu):
//
// - A persistent grid; a block walks its tiles of R rows (a power of two up
//   to 16, from the tile plan) in strided order. X crosses device
//   memory once: a ring of 2-4 stages in shared memory, filled with
//   cp.async, holds the block's next tiles while it computes on this one. A
//   staged row has the pitch round_up(d, 16) + 8 elements; the pad columns
//   are zeroed once per block and the rows past a ragged tile's end when it
//   is staged, so the inner loops read whole 16-byte vectors (4 f32 or 8
//   bf16) with no bounds checks. A row of 8 or 4 bytes' alignment is copied
//   with cp.async of that size. bf16 rows of odd d (2-byte alignment, no
//   cp.async) are staged raw instead: the tile's contiguous span, by 16-byte
//   copies of the granules that hold it, laid out at the pitch in a work
//   tile (one more barrier a tile). w is staged once per block, zero past d.
// - Margins: 8 / R warps a row (one when R >= 8), each lane a 16-byte vector
//   of the row and of w at a time; the warps' partial margins meet in shared
//   memory. One barrier hands a stage from its copies to its readers, a
//   second hands the margins to the loss.
// - Loss: every warp evaluates the loss of the tile's rows, one row a lane,
//   so the residuals reach the gradient by warp shuffles with no third
//   barrier; warp 0 alone keeps the value and residual sums.
// - Gradient: the block's threads are P row phases of 256 / P threads (P the
//   plan's `phases`); a thread owns the column vectors c, c + 256 / P, ...
//   (at most KV of them, a template parameter) for the whole kernel and adds
//   the tile rows p, p + P, ... into f32 registers. At the end the phases are
//   added in order through shared memory and the block's partial row is
//   written once. No device-memory traffic per tile beyond X and the columns.
// - The plan (`tile_plan` below, chosen from d and the type): R is the
//   largest up to 16 that lets two stages (and a work tile) fit in 96 KB
//   (two blocks to an SM), the stages 2-4, as many as keep about 48 KB of a
//   block's tiles in flight, P the most phases (up to R) that leave every
//   column vector a thread. At [2^18, 512] a sweep of plans
//   (dev/torch_kernel_ab.py, H100 80GB HBM3 at 700 W) put two stages of 16
//   rows first in f32 and bf16, and 32-row tiles (a variant of this source)
//   behind them. One pass covers d <= 8192 (KV = 8 vectors of 4 f32 or 4 of 8
//   bf16, 32 registers); wider blocks take the two-pass kernel below, which
//   reads each row tile twice (the second read from L2 while the tile is
//   there) and adds the gradient into the block's partial row per tile.
// - The reduction is deterministic and uses no float atomics: each block
//   owns one partial row (value, rsum, grad[d]), the rows, phases and
//   vectors of a block are added in a fixed order, and a second kernel sums
//   the partials in a fixed order (glm_tile.cuh, `reduce_partials_kernel`,
//   shared with the packed kernel). Repeated calls on the same inputs give
//   bitwise-equal results, which the solvers' line searches rely on.
//
// The kernel allocates nothing; the wrapper passes outputs and partials.
// Every entry point returns cudaGetLastError() (0 on success).

#include "glm_tile.cuh"

namespace {

using namespace glm_tile;

constexpr int kMaxRows = 16;
constexpr int kMaxStages = 4;
// Widest block of one pass: KV * vector * 256 threads.
constexpr int kMaxOnePassD = 8192;
// Largest dynamic shared memory a plan may ask for (the card allows 227 KB).
constexpr int kSmemMax = 200 * 1024;

// Elements in one 16-byte vector of the tile.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// ---- shared-memory geometry of the one-pass kernel (host and device) -----------

// w (round_up(d, 16) f32) | margins [2][kMaxRows] f32 | stages (and, for a
// width whose rows are not 4-byte multiples, one work tile) of
// stage_bytes each: the tile's rows at the pitch, + 32 bytes of slack for a
// raw span
__host__ __device__ constexpr size_t w_bytes(int d) { return (size_t)round_up(d, 16) * 4; }
constexpr size_t kMargBytes = 2 * kMaxRows * 4;
__host__ __device__ constexpr int stage_bytes(int d, int itemsize, int rows) {
  return rows * pitch_of(d) * itemsize + 32;
}
// Rows that are not 4-byte multiples (bf16 of odd d) are staged raw (the
// tile's contiguous span, 16-byte copies) and laid out at the pitch in a
// work tile; other rows are copied to the pitch with cp.async of 16, 8 or 4
// bytes.
__host__ __device__ constexpr bool staged_raw(int d, int itemsize) {
  return (d * itemsize) % 4 != 0;
}
size_t smem_bytes(int d, int itemsize, int rows, int stages) {
  return w_bytes(d) + kMargBytes +
         (size_t)(stages + staged_raw(d, itemsize)) * stage_bytes(d, itemsize, rows);
}

// How the partials kernel walks X: `rows` a staged tile (0: the two-pass
// kernel), `stages` in the ring, the gradient's row `phases`, the 16-byte
// column `vectors` a thread owns, and the dynamic shared memory it takes.
struct TilePlan {
  int rows, stages, phases, vectors;
  size_t smem;
};

// The ring's share of shared memory that leaves two blocks to an SM, and the
// bytes of a block's tiles a plan keeps in flight (at least two stages).
constexpr int kRingBytes = 96 * 1024;
constexpr int kInFlightBytes = 48 * 1024;

// The plan for a block d wide of itemsize-byte features: the two-pass kernel
// past kMaxOnePassD; else the most rows a tile (16, halved down to 1) whose
// two stages (and work tile, if staged raw) fit in kRingBytes, or, failing
// that, in what kSmemMax leaves; 2-4 stages, as many as keep about
// kInFlightBytes in flight and fit there; and the most row phases (up to the
// rows) that leave every column vector a thread. A build with
// -DFUSED_GLM_PLAN_ROWS=R -DFUSED_GLM_PLAN_STAGES=S -DFUSED_GLM_PLAN_PHASES=P
// takes (R, S, P) at every one-pass width instead (dev/torch_kernel_ab.py
// sweeps plans so).
TilePlan tile_plan(int d, int itemsize) {
  if (d < 1 || d > kMaxOnePassD) return {0, 0, 0, 0, 0};
  const int raw = staged_raw(d, itemsize) ? 1 : 0;
  int rows = kMaxRows;
  while (rows > 1 && (2 + raw) * stage_bytes(d, itemsize, rows) > kRingBytes) rows /= 2;
  const int stage = stage_bytes(d, itemsize, rows);
  const long long budget = (2 + raw) * stage <= kRingBytes
                               ? kRingBytes
                               : (long long)kSmemMax - (long long)(w_bytes(d) + kMargBytes);
  long long stages = budget / stage - raw;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages > kInFlightBytes / stage) stages = kInFlightBytes / stage;
  if (stages < 2) stages = 2;
  const int nvec = round_up(d, 16) * itemsize / 16;
  int phases = 1;
  while (phases < rows && kThreads / (2 * phases) >= nvec) phases *= 2;
#ifdef FUSED_GLM_PLAN_ROWS
  rows = FUSED_GLM_PLAN_ROWS, stages = FUSED_GLM_PLAN_STAGES, phases = FUSED_GLM_PLAN_PHASES;
#endif
  const int cthreads = kThreads / phases;
  return {rows, (int)stages, phases, (nvec + cthreads - 1) / cthreads,
          smem_bytes(d, itemsize, rows, (int)stages)};
}

// A 16-byte vector of the tile (or of w) widened to f32.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(u[k] << 16);
    v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}
// Where w[k] sits in shared memory: in order for an f32 tile; for a bf16
// tile (8 elements a vector) the first and the second four of each vector's
// eight in two halves, so that a lane's two 16-byte loads of w are each
// conflict-free across the warp.
template <int VEC>
__device__ __forceinline__ int w_slot(int k, int padded) {
  if constexpr (VEC == 4) {
    return k;
  } else {
    return ((k & 7) >> 2) * (padded / 2) + (k >> 3) * 4 + (k & 3);
  }
}
// The w vector that goes with tile vector v (4 or 8 f32).
template <int VEC>
__device__ __forceinline__ void load_w(const float* w_s, int v, int padded, float (&wv)[VEC]) {
  if constexpr (VEC == 4) {
    load_vec(w_s + 4 * v, wv);
  } else {
    float a[4], b[4];
    load_vec(w_s + 4 * v, a);
    load_vec(w_s + padded / 2 + 4 * v, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) wv[e] = a[e], wv[4 + e] = b[e];
  }
}

// Start staging tile t into a ring slot: its rows at the pitch, or, raw,
// the 16-byte granules that hold its contiguous span.
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* slot, const T* __restrict__ x,
                                           int64_t t, int64_t n, int rows, int d, int pitch,
                                           bool raw, int tid) {
  const int64_t row0 = t * rows;
  const int64_t left = n - row0;
  const int valid = (int)(left < rows ? left : rows);
  const T* src = x + row0 * d;
  if (raw) {
    const uintptr_t start = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a0 = start & ~(uintptr_t)15;
    const uintptr_t a1 = (start + (uintptr_t)valid * d * sizeof(T) + 15) & ~(uintptr_t)15;
    const int granules = (int)((a1 - a0) / 16);
    for (int k = tid; k < granules; k += kThreads)
      cp_async<16>(slot + k * 16, reinterpret_cast<const void*>(a0 + (uintptr_t)k * 16));
  } else {
    stage_rows(reinterpret_cast<T*>(slot), src, valid, rows, d, pitch, tid);
  }
}

// Lay a raw-staged tile out at the pitch in `work`: each 16-byte vector of a
// row is cut from the two granules it straddles (the span starts `delta`
// bytes into its first granule), the elements past d and the rows past
// `valid` are zero.
template <typename T>
__device__ __forceinline__ void lay_out(T* work, const unsigned char* slot, int delta, int valid,
                                        int rows, int d, int pitch, int tid) {
  constexpr int VEC = kVec<T>;
  const int nv = round_up(d, 16) / VEC;
  for (int q = tid; q < rows * nv; q += kThreads) {
    const int i = q / nv, v = q - i * nv;
    const int j0 = v * VEC;
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    if (i < valid) {
      const int src = delta + (i * d + j0) * (int)sizeof(T);
      const uint4* g = reinterpret_cast<const uint4*>(slot + (src & ~15));
      const uint4 a = g[0], b = g[1];
      const uint32_t wv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      const int qw = (src & 15) >> 2, bits = (src & 3) * 8;
      uint32_t sel[5];
#pragma unroll
      for (int k = 0; k < 5; ++k)
        sel[k] = qw == 0 ? wv[k] : (qw == 1 ? wv[k + 1] : (qw == 2 ? wv[k + 2] : wv[k + 3]));
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = __funnelshift_r(sel[k], sel[k + 1], bits);
      if (j0 + VEC > d) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (j0 + e >= d) {
            if constexpr (VEC == 4)
              o[e] = 0u;
            else
              o[e >> 1] &= (e & 1) ? 0x0000ffffu : 0xffff0000u;
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(work + i * pitch + j0) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int LOSS, typename T, int KV>
__global__ void __launch_bounds__(kThreads, 2)
fused_glm_partials_kernel(const T* __restrict__ x, const float* __restrict__ labels,
                          const float* __restrict__ offsets,
                          const float* __restrict__ weights,
                          const float* __restrict__ w, const float* __restrict__ shift,
                          int64_t n, int d, int rows, int stages, int phases,
                          float* __restrict__ part_value, float* __restrict__ part_rsum,
                          float* __restrict__ part_grad) {
  constexpr int VEC = kVec<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* marg_s = reinterpret_cast<float*>(smem + w_bytes(d));  // [2][kMaxRows]
  unsigned char* ring_b = smem + w_bytes(d) + kMargBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int padded = round_up(d, 16);
  const int pitch = pitch_of(d);
  const int nvec = padded / VEC;
  const bool raw = staged_raw(d, sizeof(T));
  const int slot_bytes = stage_bytes(d, sizeof(T), rows);
  T* work = reinterpret_cast<T*>(ring_b + stages * slot_bytes);  // raw staging only
  const float s = shift != nullptr ? *shift : 0.f;
  const int64_t ntiles = (n + rows - 1) / rows;
  // margins: wpr warps a row, rows row0 = warp / wpr, + kWarps / wpr, ...
  const int wpr = rows >= kWarps ? 1 : kWarps / rows;
  const int sub = warp % wpr;
  // gradient: phase p of `phases`, column vectors cv, cv + cthreads, ...
  const int cthreads = kThreads / phases;
  const int p = tid / cthreads, cv = tid - p * cthreads;

  for (int k = tid; k < padded; k += kThreads)
    w_s[w_slot<VEC>(k, padded)] = k < d ? __ldg(w + k) : 0.f;
  if (!raw) {  // a raw tile's pad columns are written by lay_out
    for (int k = 0; k < stages; ++k)
      zero_pad_columns(reinterpret_cast<T*>(ring_b + k * slot_bytes), rows, d, pitch, tid);
  }
  for (int k = 0; k < stages - 1; ++k) {
    const int64_t t = blockIdx.x + (int64_t)k * gridDim.x;
    if (t < ntiles) stage_tile(ring_b + k * slot_bytes, x, t, n, rows, d, pitch, raw, tid);
    cp_async_commit();
  }

  float acc[KV][VEC] = {};
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
      if (ahead < ntiles)
        stage_tile(ring_b + ahead_slot * slot_bytes, x, ahead, n, rows, d, pitch, raw, tid);
      cp_async_commit();
    }

    const unsigned char* slot_b = ring_b + slot * slot_bytes;
    const int64_t row0 = t * rows;
    const int64_t left = n - row0;
    const int valid = (int)(left < rows ? left : rows);
    const T* tile = reinterpret_cast<const T*>(slot_b);
    if (raw) {
      const int delta = (int)(reinterpret_cast<uintptr_t>(x + row0 * d) & 15);
      lay_out(work, slot_b, delta, valid, rows, d, pitch, tid);
      __syncthreads();  // the work tile is laid out
      tile = work;
    }
    // this lane's row: its label, offset and weight, loaded during the margins
    float y = 0.f, o = 0.f, wt = 0.f;
    const bool mine = lane < valid;
    if (mine) {
      y = __ldg(labels + row0 + lane);
      o = __ldg(offsets + row0 + lane);
      wt = __ldg(weights + row0 + lane);
    }

    float* marg = marg_s + parity * kMaxRows;
    for (int i = warp / wpr; i < valid; i += kWarps / wpr) {  // warp-uniform
      const T* xr = tile + i * pitch;
      float mv[VEC] = {};  // one chain per vector element, added in element order
#pragma unroll 4
      for (int v = sub * 32 + lane; v < nvec; v += 32 * wpr) {
        float xv[VEC], wv[VEC];
        load_vec(xr + v * VEC, xv);
        load_w<VEC>(w_s, v, padded, wv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) mv[e] = fmaf(xv[e], wv[e], mv[e]);
      }
      float m = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) m += mv[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m += __shfl_xor_sync(kFull, m, off);
      if (lane == 0) marg[i * wpr + sub] = m;
    }
    __syncthreads();  // the margins are in marg

    float r = 0.f;
    if (mine) {
      float m = 0.f;
      for (int q = 0; q < wpr; ++q) m += marg[lane * wpr + q];
      float l, dz;
      loss_and_dz<LOSS>(m + (o - s), y, l, dz);
      r = wt * dz;
      if (warp == 0) {
        value_acc += wt * l;
        rsum_acc += r;
      }
    }

#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const float ri = __shfl_sync(kFull, r, i);  // zero past the tile's valid rows
      if (i < valid && (i & (phases - 1)) == p) {
        const T* xr = tile + i * pitch;
#pragma unroll
        for (int j = 0; j < KV; ++j) {
          const int v = cv + j * cthreads;
          if (v < nvec) {
            float xv[VEC];
            load_vec(xr + v * VEC, xv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(ri, xv[e], acc[j][e]);
          }
        }
      }
    }
    if (++slot == stages) slot = 0;
    parity ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::);

  float* pg = part_grad + (int64_t)blockIdx.x * d;
  if (phases == 1) {
#pragma unroll
    for (int j = 0; j < KV; ++j) {
      const int v = cv + j * cthreads;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (v * VEC + e < d) pg[v * VEC + e] = acc[j][e];
    }
  } else {
    // the phases' sums meet in the ring's space, added in phase order
    __syncthreads();
    float* g_s = reinterpret_cast<float*>(ring_b);  // [phases][padded]
#pragma unroll
    for (int j = 0; j < KV; ++j) {
      const int v = cv + j * cthreads;
      if (v < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) g_s[p * padded + v * VEC + e] = acc[j][e];
      }
    }
    __syncthreads();
    for (int c = tid; c < d; c += kThreads) {
      float g = 0.f;
      for (int q = 0; q < phases; ++q) g += g_s[q * padded + c];
      pg[c] = g;
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
      part_rsum[blockIdx.x] = rsum_acc;
    }
  }
}

// ---- the two-pass kernel for d > kMaxOnePassD --------------------------------------

constexpr int kWideRows = 16;

// Tiles of 16 rows read straight from device memory: the margins a warp a
// row, then each thread's columns of the tile (the second read of the tile
// hits L2), added into the block's partial row.
template <int LOSS, typename T>
__global__ void __launch_bounds__(kThreads)
fused_glm_wide_kernel(const T* __restrict__ x, const float* __restrict__ labels,
                      const float* __restrict__ offsets, const float* __restrict__ weights,
                      const float* __restrict__ w, const float* __restrict__ shift, int64_t n,
                      int d, float* __restrict__ part_value, float* __restrict__ part_rsum,
                      float* __restrict__ part_grad) {
  __shared__ float r_s[kWideRows];
  __shared__ float red_s[2 * kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* gacc = part_grad + (int64_t)blockIdx.x * d;
  for (int c = tid; c < d; c += kThreads) gacc[c] = 0.f;
  const float s = shift != nullptr ? *shift : 0.f;
  // every lane of a warp holds the same sums (xor-butterfly reduction)
  float value_acc = 0.f;
  float rsum_acc = 0.f;

  const int64_t ntiles = (n + kWideRows - 1) / kWideRows;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t row0 = t * kWideRows;
    const int64_t left = n - row0;
    const int rows = (int)(left < kWideRows ? left : kWideRows);
    const T* xt = x + row0 * d;
    for (int i = warp; i < kWideRows; i += kWarps) {
      float r = 0.f;
      if (i < rows) {  // warp-uniform
        const T* xr = xt + (int64_t)i * d;
        float acc = 0.f;
#pragma unroll 4
        for (int c = lane; c < d; c += 32) acc += to_float(xr[c]) * __ldg(w + c);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
        const int64_t row = row0 + i;
        const float m = acc + (__ldg(offsets + row) - s);
        float l, dz;
        loss_and_dz<LOSS>(m, __ldg(labels + row), l, dz);
        const float wt = __ldg(weights + row);
        r = wt * dz;
        value_acc += wt * l;
        rsum_acc += r;
      }
      if (lane == 0) r_s[i] = r;
    }
    __syncthreads();
    for (int c = tid; c < d; c += kThreads) {
      float g = 0.f;
#pragma unroll 8
      for (int i = 0; i < rows; ++i) g += r_s[i] * to_float(xt[(int64_t)i * d + c]);
      gacc[c] += g;
    }
    __syncthreads();  // the next tile overwrites r_s
  }

  if (lane == 0) {
    red_s[warp] = value_acc;
    red_s[kWarps + warp] = rsum_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float v = 0.f, rs = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      v += red_s[k];
      rs += red_s[kWarps + k];
    }
    part_value[blockIdx.x] = v;
    part_rsum[blockIdx.x] = rs;
  }
}

// ---- dispatch ------------------------------------------------------------------------

struct PartialsArgs {
  const void* x;
  const float* labels;
  const float* offsets;
  const float* weights;
  const float* w;
  const float* shift;
  int64_t n;
  int d;
  int rows;  // 0: the two-pass kernel
  int stages;
  int phases;
  int blocks;
  float* part_value;
  float* part_rsum;
  float* part_grad;
};

struct KernelOps {
  cudaError_t (*launch)(const PartialsArgs&, cudaStream_t);
  cudaError_t (*occupancy)(int*, const PartialsArgs&);
};

template <int LOSS, typename T, int KV>
cudaError_t launch_one_pass(const PartialsArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.d, sizeof(T), a.rows, a.stages);
  cudaError_t err = cudaFuncSetAttribute(fused_glm_partials_kernel<LOSS, T, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  fused_glm_partials_kernel<LOSS, T, KV><<<a.blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.x), a.labels, a.offsets, a.weights, a.w, a.shift, a.n, a.d,
      a.rows, a.stages, a.phases, a.part_value, a.part_rsum, a.part_grad);
  return cudaGetLastError();
}

template <int LOSS, typename T, int KV>
cudaError_t occupancy_one_pass(int* blocks_per_sm, const PartialsArgs& a) {
  const size_t bytes = smem_bytes(a.d, sizeof(T), a.rows, a.stages);
  cudaError_t err = cudaFuncSetAttribute(fused_glm_partials_kernel<LOSS, T, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_glm_partials_kernel<LOSS, T, KV>, kThreads, bytes);
}

template <int LOSS, typename T>
cudaError_t launch_wide(const PartialsArgs& a, cudaStream_t stream) {
  fused_glm_wide_kernel<LOSS, T><<<a.blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), a.labels, a.offsets, a.weights, a.w, a.shift, a.n, a.d,
      a.part_value, a.part_rsum, a.part_grad);
  return cudaGetLastError();
}

template <int LOSS, typename T>
cudaError_t occupancy_wide(int* blocks_per_sm, const PartialsArgs&) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_glm_wide_kernel<LOSS, T>, kThreads, 0);
}

// Column vectors a thread owns at most: 1, 2, 4 or 8 (f32), 1, 2 or 4 (bf16).
template <typename T>
constexpr int kMaxKv = kMaxOnePassD / (kThreads * kVec<T>);

template <int LOSS, typename T>
KernelOps ops_for_type(const PartialsArgs& a) {
  if (a.rows == 0) return {launch_wide<LOSS, T>, occupancy_wide<LOSS, T>};
  const int nvec = round_up(a.d, 16) / kVec<T>;
  const int cthreads = kThreads / a.phases;
  const int kv = (nvec + cthreads - 1) / cthreads;
#define PHOTON_KV(KV)                                                                 \
  if constexpr (KV <= kMaxKv<T>) {                                                    \
    if (kv <= KV) return {launch_one_pass<LOSS, T, KV>, occupancy_one_pass<LOSS, T, KV>}; \
  }
  PHOTON_KV(1)
  PHOTON_KV(2)
  PHOTON_KV(4)
  PHOTON_KV(8)
#undef PHOTON_KV
  return {nullptr, nullptr};
}

template <typename T>
KernelOps ops_for_loss(const PartialsArgs& a, int loss) {
  switch (loss) {
    case kLogistic: return ops_for_type<kLogistic, T>(a);
    case kSquared: return ops_for_type<kSquared, T>(a);
    case kPoisson: return ops_for_type<kPoisson, T>(a);
    case kSmoothedHinge: return ops_for_type<kSmoothedHinge, T>(a);
    default: return {nullptr, nullptr};
  }
}

// The kernel for this loss, feature type and plan, or nulls where the plan
// is not one the kernel takes: rows 0 (two-pass) or a power of two up to 16
// with 2-4 stages whose shared memory fits kSmemMax, and phases a power of
// two up to rows (a -DFUSED_GLM_PLAN_* build may ask for others).
KernelOps select_ops(int loss, int is_bf16, const PartialsArgs& a) {
  if (a.d < 1) return {nullptr, nullptr};
  if (a.rows != 0) {
    const bool pow2 = (a.rows & (a.rows - 1)) == 0 && (a.phases & (a.phases - 1)) == 0;
    if (!pow2 || a.rows > kMaxRows || a.phases < 1 || a.phases > a.rows || a.stages < 2 ||
        a.stages > kMaxStages || a.d > kMaxOnePassD ||
        smem_bytes(a.d, is_bf16 ? 2 : 4, a.rows, a.stages) > (size_t)kSmemMax)
      return {nullptr, nullptr};
  }
  return is_bf16 ? ops_for_loss<__nv_bfloat16>(a, loss) : ops_for_loss<float>(a, loss);
}

// The arguments of one call, its tile plan filled in from (d, type).
PartialsArgs with_plan(int is_bf16, int64_t n, int d) {
  const TilePlan plan = tile_plan(d, is_bf16 ? 2 : 4);
  PartialsArgs a{};
  a.n = n, a.d = d, a.rows = plan.rows, a.stages = plan.stages, a.phases = plan.phases;
  return a;
}

}  // namespace

extern "C" {

// The tile plan for a block d wide (f32, or bf16 with is_bf16): rows a tile
// (0: the two-pass kernel), stages, row phases, column vectors a thread and
// dynamic shared memory in bytes, written to plan[0..4].
int fused_glm_tile_plan(int is_bf16, int d, int* plan) {
  const TilePlan p = tile_plan(d, is_bf16 ? 2 : 4);
  plan[0] = p.rows, plan[1] = p.stages, plan[2] = p.phases, plan[3] = p.vectors;
  plan[4] = (int)p.smem;
  return (int)cudaSuccess;
}

// Grid size of the partials kernel for this loss, feature type and shape on
// the current device: as many blocks as can be resident at once, at most one
// per tile and at least one. Written to *blocks.
int fused_glm_grid_blocks(int loss, int is_bf16, long long n, int d, int* blocks) {
  const PartialsArgs a = with_plan(is_bf16, n, d);
  const KernelOps ops = select_ops(loss, is_bf16, a);
  if (ops.occupancy == nullptr) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = ops.occupancy(&per_sm, a);
  if (err != cudaSuccess) return (int)err;
  const int tile = a.rows == 0 ? kWideRows : a.rows;
  const long long ntiles = (n + tile - 1) / tile;
  long long b = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (b > ntiles) b = ntiles;
  *blocks = b < 1 ? 1 : (int)b;
  return (int)cudaSuccess;
}

// Per-block partials: part_value[blocks], part_rsum[blocks],
// part_grad[blocks, d], under the tile plan of (d, type). x must be
// contiguous and 16-byte aligned.
int fused_glm_partials(int loss, int is_bf16, const void* x, const void* labels,
                       const void* offsets, const void* weights, const void* w,
                       const void* shift, long long n, int d, int blocks, void* part_value,
                       void* part_rsum, void* part_grad, void* stream) {
  PartialsArgs args = with_plan(is_bf16, n, d);
  args.x = x;
  args.labels = static_cast<const float*>(labels);
  args.offsets = static_cast<const float*>(offsets);
  args.weights = static_cast<const float*>(weights);
  args.w = static_cast<const float*>(w);
  args.shift = static_cast<const float*>(shift);
  args.blocks = blocks;
  args.part_value = static_cast<float*>(part_value);
  args.part_rsum = static_cast<float*>(part_rsum);
  args.part_grad = static_cast<float*>(part_grad);
  const KernelOps ops = select_ops(loss, is_bf16, args);
  if (ops.launch == nullptr) return (int)cudaErrorInvalidValue;
  return (int)ops.launch(args, static_cast<cudaStream_t>(stream));
}

// value[1], rsum[1], grad[d] from the partials, summed in the fixed order of
// glm_tile.cuh's reduce_partials_kernel.
int fused_glm_reduce(const void* part_value, const void* part_rsum, const void* part_grad,
                     int blocks, int d, void* value, void* rsum, void* grad, void* stream) {
  return (int)launch_reduce(static_cast<const float*>(part_value),
                            static_cast<const float*>(part_rsum),
                            static_cast<const float*>(part_grad), blocks, d,
                            static_cast<float*>(value), static_cast<float*>(rsum),
                            static_cast<float*>(grad), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
