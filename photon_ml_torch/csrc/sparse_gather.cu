// Row-segmented sparse gather-sum for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by photon_ml_torch/ops/sparse_gather.py.
//
// Replaces the TPU kernels G1 and G2: `pallas_gather_sum` in
// experiments/sparse_gather_probe.py (body `gather_kernel`) and in
// experiments/sparse_gather_probe2.py (the same sum with w read as
// [d/128, 128] at (j >> 7, j & 127), which is the address j). Both sum
// vals[k] * w[idx[k]] over one segment in f32. Here the sum is segmented by
// row, which is what a sparse GLM margin needs:
//
//   out[i] = sum_{l < L} ev[i, l] * w[ec[i, l]]                 (ELL block)
//          + sum_{row_ptr[i] <= k < row_ptr[i+1]} tv[k] * w[tc[k]]  (flat tail)
//
// values f32 or bf16, columns int32, w f32, out f32 [n]; accumulation in f32.
// G1 and G2 are the case of one row holding all nnz entries.
//
// Bound on an H100 (3.35 TB/s): the kernel must read every stored entry once
// (value + 4-byte column), write 4 n bytes, read row_ptr (4 (n+1)) and read
// each distinct column of w once (4 bytes each):
//   bytes = nnz (sizeof(val) + 4) + 4 n + 4 (n + 1) + 4 distinct(cols)
// (row_ptr only where there is a tail). At n = 2^19, L = 36, d = 10^7, f32,
// that is about 151 MB of entries, 2 MB of out and at most 40 MB of w, near
// 0.06 ms; chip_smoke.py computes it from each run's inputs, distinct
// columns counted. Two flops per entry put the arithmetic far below
// the f32 peak. w itself (40 MB at d = 10^7) fits in the 50 MB L2 cache, so
// the random reads of w can mostly hit L2 once it is warm; each of them
// still costs a 32-byte sector for 4 useful bytes, which is why a gather of
// random columns runs well short of the bound.
//
// What the design does about that bound (simple and right first):
// - Entries are read once and coalesced: one warp per row, its 32 lanes
//   stride the row's L ELL entries and then its tail entries, so a warp reads
//   contiguous values and columns. w is read through the read-only path
//   (__ldg).
// - No float atomics: each lane keeps its own f32 sum, and the warp adds the
//   32 lane sums by a shuffle tree in a fixed order. Two calls on the same
//   inputs are bitwise equal, which the solvers' line searches rely on.
// - A row longer than kChunk tail entries (G1's one segment of 2^24 entries)
//   is not left to one warp's serial loop: the wrapper passes a chunk plan,
//   a first kernel gives each chunk its own warp and writes one partial per
//   chunk, and the row kernel adds a row's partials in chunk order (as B1's
//   reduce adds its partials in block order). Rows with no chunks in the
//   plan (every row of kChunk entries or fewer) read their entries directly.
// - Many short rows and no ELL block (the transpose X'r of a sparse batch:
//   one row per column, about two entries each at d = 10^7) would leave a
//   warp per row nearly idle and latency-bound, so there one thread takes a
//   row and adds its entries in order (gather_segments_kernel); a long row
//   still goes through its chunk partials. The wrapper picks this kernel
//   when the rows hold fewer than 32 entries on average.
// Later work, not done here: wider loads of the ELL rows (several rows per
// warp when L is small; L = 36 leaves 28 lanes idle on the second stride),
// L2 residency control for w, and rows sorted by length.
//
// The kernels allocate nothing; the wrapper passes outputs and partials.
// Every entry point returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kChunk = 2048;  // entries of one chunk of a long row
constexpr long long kMaxBlocks = 1 << 20;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sum of the 32 lanes' values in a fixed order; the result is in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_down_sync(kFull, v, offset);
  return v;
}

// This lane's share of sum_{k in [begin, end)} vals[k] * w[cols[k]].
template <typename V>
__device__ __forceinline__ float lane_dot(const V* __restrict__ vals,
                                          const int* __restrict__ cols,
                                          const float* __restrict__ w, long long begin,
                                          long long end, int lane, float acc) {
  for (long long k = begin + lane; k < end; k += 32)
    acc = fmaf(to_float(vals[k]), __ldg(w + __ldg(cols + k)), acc);
  return acc;
}

// One partial per chunk of a long tail row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_chunks_kernel(const V* __restrict__ tv, const int* __restrict__ tc,
                     const int* __restrict__ row_ptr, const int* __restrict__ chunk_row,
                     const int* __restrict__ chunk_ptr, const float* __restrict__ w,
                     long long num_chunks, float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long c = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); c < num_chunks;
       c += warps) {
    const int row = chunk_row[c];
    const long long begin = (long long)row_ptr[row] + (c - chunk_ptr[row]) * (long long)kChunk;
    const long long row_end = row_ptr[row + 1];
    const long long end = begin + kChunk < row_end ? begin + kChunk : row_end;
    const float s = warp_sum(lane_dot(tv, tc, w, begin, end, lane, 0.f));
    if (lane == 0) partials[c] = s;
  }
}

// One warp per row: the ELL entries, then the tail entries (or, with a
// chunk plan, the row's chunk partials in order).
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ ev, const int* __restrict__ ec, int width,
                   const V* __restrict__ tv, const int* __restrict__ tc,
                   const int* __restrict__ row_ptr, const float* __restrict__ partials,
                   const int* __restrict__ chunk_ptr, const float* __restrict__ w, long long n,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); row < n;
       row += warps) {
    float acc = 0.f;
    if (width > 0) acc = lane_dot(ev, ec, w, row * width, (row + 1) * width, lane, acc);
    if (partials != nullptr && chunk_ptr[row + 1] > chunk_ptr[row]) {
      for (int c = chunk_ptr[row] + lane; c < chunk_ptr[row + 1]; c += 32) acc += partials[c];
    } else if (row_ptr != nullptr) {
      acc = lane_dot(tv, tc, w, row_ptr[row], row_ptr[row + 1], lane, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc;
  }
}

// One thread per tail row, its entries (or its chunk partials) in order.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_segments_kernel(const V* __restrict__ tv, const int* __restrict__ tc,
                       const int* __restrict__ row_ptr, const float* __restrict__ partials,
                       const int* __restrict__ chunk_ptr, const float* __restrict__ w,
                       long long n, float* __restrict__ out) {
  const long long threads = (long long)gridDim.x * kThreads;
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x; row < n; row += threads) {
    float acc = 0.f;
    if (partials != nullptr && chunk_ptr[row + 1] > chunk_ptr[row]) {
      for (int c = chunk_ptr[row]; c < chunk_ptr[row + 1]; ++c) acc += partials[c];
    } else {
      const int end = row_ptr[row + 1];
      for (int k = row_ptr[row]; k < end; ++k)
        acc = fmaf(to_float(tv[k]), __ldg(w + __ldg(tc + k)), acc);
    }
    out[row] = acc;
  }
}

int blocks_for(long long items) {
  long long b = (items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

extern "C" {

// Entries of one chunk of a long row (the wrapper checks it against its own).
int sparse_gather_chunk() { return kChunk; }

// out[n] = ELL row sums (ev/ec [n, width], width may be 0 with null arrays)
// + tail row sums (tv/tc with row_ptr [n+1], or null). With partials and
// chunk_ptr non-null, a row with chunks takes its chunk partials instead.
int sparse_gather_rows(int is_bf16, const void* ev, const void* ec, int width, const void* tv,
                       const void* tc, const void* row_ptr, const void* partials,
                       const void* chunk_ptr, const void* w, long long n, void* out,
                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = blocks_for(n);
  if (is_bf16) {
    gather_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)ev, (const int*)ec, width, (const __nv_bfloat16*)tv,
        (const int*)tc, (const int*)row_ptr, (const float*)partials, (const int*)chunk_ptr,
        (const float*)w, n, (float*)out);
  } else {
    gather_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)ev, (const int*)ec, width, (const float*)tv, (const int*)tc,
        (const int*)row_ptr, (const float*)partials, (const int*)chunk_ptr, (const float*)w, n,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

// out[n] = tail row sums (tv/tc with row_ptr [n+1]), one thread per row; with
// partials and chunk_ptr non-null, a row with chunks sums its partials.
int sparse_gather_segments(int is_bf16, const void* tv, const void* tc, const void* row_ptr,
                           const void* partials, const void* chunk_ptr, const void* w,
                           long long n, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  long long b = (n + kThreads - 1) / kThreads;
  const int blocks = b < 1 ? 1 : (b > kMaxBlocks ? (int)kMaxBlocks : (int)b);
  if (is_bf16) {
    gather_segments_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)tv, (const int*)tc, (const int*)row_ptr, (const float*)partials,
        (const int*)chunk_ptr, (const float*)w, n, (float*)out);
  } else {
    gather_segments_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)tv, (const int*)tc, (const int*)row_ptr, (const float*)partials,
        (const int*)chunk_ptr, (const float*)w, n, (float*)out);
  }
  return (int)cudaGetLastError();
}

// partials[num_chunks]: one sum per chunk of the chunk plan.
int sparse_gather_chunks(int is_bf16, const void* tv, const void* tc, const void* row_ptr,
                         const void* chunk_row, const void* chunk_ptr, const void* w,
                         long long num_chunks, void* partials, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = blocks_for(num_chunks);
  if (is_bf16) {
    gather_chunks_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)tv, (const int*)tc, (const int*)row_ptr, (const int*)chunk_row,
        (const int*)chunk_ptr, (const float*)w, num_chunks, (float*)partials);
  } else {
    gather_chunks_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)tv, (const int*)tc, (const int*)row_ptr, (const int*)chunk_row,
        (const int*)chunk_ptr, (const float*)w, num_chunks, (float*)partials);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
