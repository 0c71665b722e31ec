// Helpers shared by the two fused GLM value+gradient kernels for Hopper
// (sm_90a): csrc/fused_glm.cu (B1, separate label/offset/weight columns) and
// csrc/packed_glm.cu (the packed-aux kernel). Both stage row tiles of X in a
// cp.async ring in shared memory at a padded pitch, evaluate the same four
// losses in f32, and write one row of partials a block, which one more
// kernel sums in a fixed order; this header holds that staging, the losses,
// and the ordered reduction.
//
// Everything here is inline device code or constexpr geometry; each .cu
// that includes it builds its own copy into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace glm_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum LossId { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The four losses of photon_ml_torch/ops/losses.py, in f32.
template <int LOSS>
__device__ __forceinline__ void loss_and_dz(float z, float y, float& l, float& dz) {
  if (LOSS == kLogistic) {
    // softplus(z) = max(z, 0) + log1p(exp(-|z|)), stable for every z
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

// ---- shared-memory geometry (host and device) --------------------------------

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
// Elements of one staged row: round_up(d, 16) + 8. The 8 extra elements shift
// successive rows by an odd number of 16-byte bank groups (bf16) or by 8
// banks (f32); a row's start stays 16-byte aligned.
__host__ __device__ constexpr int pitch_of(int d) { return round_up(d, 16) + 8; }

// ---- staging -------------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem_src),
                 "n"(BYTES));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most `pending` (0-2) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

// Copy each of `rows` rows to its pitched place in chunks of BYTES (a
// divisor of the row's bytes; x and every row start are aligned).
template <int BYTES>
__device__ __forceinline__ void copy_rows(char* dst, const char* src, int rows, int row_bytes,
                                          int pitch_bytes, int tid) {
  const int per_row = row_bytes / BYTES;
  for (int v = tid; v < rows * per_row; v += kThreads) {
    const int i = v / per_row, j = v - i * per_row;
    cp_async<BYTES>(dst + i * pitch_bytes + j * BYTES, src + (int64_t)i * row_bytes + j * BYTES);
  }
}

// Start staging the `rows` rows of X at src (row-major, d wide) into buf at
// pitch `pitch`, and write zeros in buf's rows [rows, tile_rows) (a ragged
// last tile). The pad columns [d, round_up(d, 16)) are the caller's to zero,
// once: no copy touches them.
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* __restrict__ src, int rows,
                                           int tile_rows, int d, int pitch, int tid) {
  const int row_bytes = d * (int)sizeof(T);
  const int pitch_bytes = pitch * (int)sizeof(T);
  const char* s = reinterpret_cast<const char*>(src);
  char* dst = reinterpret_cast<char*>(buf);
  if (row_bytes % 16 == 0) {
    copy_rows<16>(dst, s, rows, row_bytes, pitch_bytes, tid);
  } else if (row_bytes % 8 == 0) {
    copy_rows<8>(dst, s, rows, row_bytes, pitch_bytes, tid);
  } else if (row_bytes % 4 == 0) {
    copy_rows<4>(dst, s, rows, row_bytes, pitch_bytes, tid);
  } else {
    // A bf16 row of odd d: plain 2-byte copies. Only the packed kernel comes
    // here. B1 (fused_glm.cu `stage_tile`) stages such a tile's raw span with
    // 16-byte copies and lays it out in a work tile, the faster of the two at
    // [2^17, 4099] (PERF.md). The packed kernel keeps these copies: the work
    // tile is a third tile of shared memory that its geometry (`stages_for`,
    // `max_staged_d` and their mirror in ops/packed_glm.py) does not hold -- at
    // 32 rows a tile, bf16 rows of d near 1536 take 3 x 98.8 KB against the
    // kernel's 200 KB -- and no measured path runs it at an odd bf16 width.
    for (int v = tid; v < rows * d; v += kThreads) {
      const int i = v / d, j = v - i * d;
      buf[i * pitch + j] = src[(int64_t)i * d + j];
    }
  }
  if (rows < tile_rows) {
    uint4* z = reinterpret_cast<uint4*>(dst + rows * pitch_bytes);
    for (int v = tid; v < (tile_rows - rows) * pitch_bytes / 16; v += kThreads)
      z[v] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Zero the pad columns [d, round_up(d, 16)) of `rows` staged rows at pitch
// `pitch` (all the ring's rows, once per block).
template <typename T>
__device__ __forceinline__ void zero_pad_columns(T* ring, int rows, int d, int pitch, int tid) {
  const int padw = round_up(d, 16) - d;
  for (int v = tid; v < rows * padw; v += kThreads) {
    const int row = v / padw;
    const int at = row * pitch + d + (v - row * padw);
    if constexpr (sizeof(T) == 2)
      reinterpret_cast<uint16_t*>(ring)[at] = 0;
    else
      reinterpret_cast<uint32_t*>(ring)[at] = 0u;
  }
}

// ---- the ordered reduction of the per-block partials ------------------------------
//
// A partials grid writes part_value [blocks], part_rsum [blocks] (or null),
// part_grad [blocks, d], one row a block. reduce_partials_kernel sums them
// in one fixed order: column c of the gradient is split into 32 strided
// sums S_k = part_grad[k][c] + part_grad[k + 32][c] + ... (k < 32, warp k of
// the column's block, each added from 0 in block order), and grad[c] = S_0 +
// S_1 + ... + S_31, added from 0 by warp 0; value and rsum are summed by the
// 32 lanes of block 0's warp 0, lane l adding blocks l, l + 32, ... from 0,
// then a xor butterfly of offsets 16, 8, 4, 2, 1. No float atomics: two
// calls on the same inputs are bitwise equal. Each library's reduce entry
// point launches it through launch_reduce, after its partials kernel.
//
// Tried and dropped (PERF.md, Findings): the sums in the partials
// kernel's own tail after a grid-wide barrier (a cooperative launch; the
// grid is one wave), whose barrier alone cost about as much as this launch;
// this kernel as a programmatic dependent launch of the partials kernel,
// which saved nothing.

constexpr int kReduceWarps = 32;

// A block owns 32 gradient columns: warp k sums partial rows k, k +
// kReduceWarps, ... of its lane's column (coalesced 128-byte rows), then warp
// 0 adds the warps' sums in warp order. Warp 0 of block 0 also sums value
// and, unless absent, rsum.
__global__ void __launch_bounds__(kReduceWarps * 32)
reduce_partials_kernel(const float* __restrict__ part_value, const float* __restrict__ part_rsum,
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
      v += __shfl_xor_sync(kFull, v, off);
      rs += __shfl_xor_sync(kFull, rs, off);
    }
    if (lane == 0) {
      *value = v;
      if (with_rsum) *rsum = rs;
    }
  }
}

// value[1], rsum[1] (or null with part_rsum), grad[d] from the partials of
// `blocks` blocks, on `stream`.
inline cudaError_t launch_reduce(const float* part_value, const float* part_rsum,
                                 const float* part_grad, int blocks, int d, float* value,
                                 float* rsum, float* grad, cudaStream_t stream) {
  const int grid = d > 0 ? (d + 31) / 32 : 1;
  reduce_partials_kernel<<<grid, kReduceWarps * 32, 0, stream>>>(
      part_value, part_rsum, part_grad, blocks, d, value, rsum, grad);
  return cudaGetLastError();
}

}  // namespace glm_tile
