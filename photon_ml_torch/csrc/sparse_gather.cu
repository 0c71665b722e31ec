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
// What the design does about that bound:
// - ELL rows (the margins of every ELL batch): a group of G lanes per row
//   (32 / G rows a warp). Each lane of a group takes the row's vectors of
//   VEC consecutive entries j, j + G, ... (VEC = 4, 2 or 1, the widest that
//   every row's start allows: at L = 36 that is 16-byte column and f32
//   value loads, 8-byte bf16 value loads), so a warp reads its rows' bytes
//   once, in contiguous runs. G = 4, 8 or 16, the fewest lanes that cover a
//   row's vectors in one step (the wrapper's ell_plan): 16 at L = 36. A lane
//   issues all the column and value loads of up to kBatch vectors, then all
//   their w[col] loads, then the FMAs. The entries are read with the
//   streaming hint (ld.global.cs); w through the read-only path (__ldg).
// - What bounds it (H100 80GB HBM3 at 700 W, n = 2^19 rows of 36 random
//   columns, dev/torch_kernel_ab.py): not the loads in flight but w's
//   footprint in L2. At d = 10^7 (w 40 MB) every plan reads 0.25-0.28 ms in
//   f32; at d = 2^22 (16 MB) the same rows read about 0.17. Each of the
//   18.9M gathers costs a 32-byte L2 sector, and a w that does not stay in
//   L2 costs DRAM sectors as well. Tried and dropped (a variant of this
//   source built by that script with --other-flags): an access-policy
//   window marking w persisting, the set-aside at its maximum, read 0.313
//   ms against 0.281 without; an L2::evict_last hint on the w loads 0.297
//   against 0.283.
// - No float atomics: each lane adds its entries in order, the group adds
//   its lanes by log2(G) xor-shuffle steps, and a warp stores its rows'
//   sums with one coalesced store. Two calls on the same inputs are bitwise
//   equal, which the solvers' line searches rely on.
// - A flat tail (the hybrid layout's rows past the ELL width, or a batch
//   with no ELL block) is summed by the whole warp, one of the warp's rows
//   at a time, rows with no tail skipped; with no ELL block the wrapper
//   passes G = 32, one row a warp.
// - A row longer than kChunk tail entries (G1's one segment of 2^24 entries,
//   a planted column of a transpose) is not left to one warp's serial loop.
//   The wrapper passes a compact chunk plan: the R long rows in order
//   (long_rows [R]) and where each row's chunks start (long_chunk_ptr
//   [R+1]); a kernel knows a row is long from its own pointers (e - b >
//   kChunk), so nothing [n]-sized is read for chunks. The chunk kernel
//   (gather_chunks_kernel) gives each chunk of kChunk entries a block of
//   kChunkThreads threads, 32 entries a thread: 16-byte vector loads of the
//   chunk's columns and values (a scalar head up to the first aligned
//   entry, since a chunk starts wherever its row does), a batch of 16
//   entries' loads issued before their gathers, as the ELL rows do; the
//   block finds its row by a warp-wide search of the plan (32 probes a
//   step). The consumer (the row kernel or the segment kernel) finds the
//   row in the plan the same way and adds its partials with the whole warp,
//   strided by lane, then by a xor butterfly. (A long row's sum therefore
//   differs in its last bits from the warp-a-chunk design before it; rows
//   of kChunk entries or fewer, and every batch with no long row, sum
//   bitwise as before.) Rows of kChunk entries or fewer read their entries
//   directly; a batch with no long row runs kernels built without
//   the chunk code (the CHUNKED template flag).
// - What bounds the chunk kernel (H100 80GB HBM3 at 700 W,
//   dev/torch_kernel_ab.py): the rate of random gathers from L2, as for the
//   rows and the transpose. The 1101 chunks (2.25M entries) of the planted
//   transpose read 0.019 ms, about 118 G gathers/s, where a warp a chunk
//   (64 entries a lane, one at a time) read 0.022; G1's 16.8M gathers 0.148
//   against 0.147. The planted transpose (0.204 -> 0.179 ms) gained mostly
//   from a plan with no [d+1] chunk pointers, which the segment kernel read
//   for every staged run (40 MB at d = 10^7).
// - Many short rows and no ELL block (the transpose X'r of a sparse batch:
//   one row per column, about two entries each at d = 10^7, most columns
//   empty at d = 10^8): load by entry, add by row (gather_segments_kernel).
//   A warp owns a run of 32 consecutive rows, reads their row pointers
//   coalesced, and reads the run's entries once with coalesced loads, 64 at
//   a time, gathering w at each; the (value, w) pairs go to shared memory,
//   and each lane adds its own row's pairs in entry order with fmaf from 0
//   -- the operations, in the order, of one thread walking its row, so the
//   sums are bitwise those of a thread per row. A row with chunks takes the
//   sum of its partials and its entries are not staged. An empty row costs its
//   pointers and its output. The wrapper picks this kernel when the rows
//   hold fewer than 32 entries on average.
// - What bounds the transpose (H100 80GB HBM3 at 700 W, dev/torch_kernel_ab.py,
//   the 18.9M entries of a [2^19, 36] ELL block at d = 10^7): the random
//   gathers of r, a 32-byte L2 sector each for 4 useful bytes. This kernel
//   and a thread per row both read about 0.18 ms there (cuSPARSE 0.20); the
//   same entries gathering r from 64 KB read 0.11 and 0.09. The runs win
//   where a warp's rows differ in length (a Zipf tail at d = 10^7: 0.15
//   against 0.24), where a thread per row waits for the longest of 32.
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

// Vectors of ELL entries a lane loads before it gathers their w.
constexpr int kBatch = 4;

// The low and the high bf16 of a 32-bit word, widened to f32.
__device__ __forceinline__ float bf16_lo(unsigned bits) { return __uint_as_float(bits << 16); }
__device__ __forceinline__ float bf16_hi(unsigned bits) {
  return __uint_as_float(bits & 0xffff0000u);
}

// VEC consecutive entries (values and columns) with streaming vector loads.
template <int VEC>
__device__ __forceinline__ void load_entries(const float* vals, const int* cols, float (&x)[VEC],
                                             int (&c)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 ci = __ldcs(reinterpret_cast<const int4*>(cols));
    const float4 xv = __ldcs(reinterpret_cast<const float4*>(vals));
    c[0] = ci.x, c[1] = ci.y, c[2] = ci.z, c[3] = ci.w;
    x[0] = xv.x, x[1] = xv.y, x[2] = xv.z, x[3] = xv.w;
  } else if constexpr (VEC == 2) {
    const int2 ci = __ldcs(reinterpret_cast<const int2*>(cols));
    const float2 xv = __ldcs(reinterpret_cast<const float2*>(vals));
    c[0] = ci.x, c[1] = ci.y;
    x[0] = xv.x, x[1] = xv.y;
  } else {
    c[0] = __ldcs(cols);
    x[0] = __ldcs(vals);
  }
}
template <int VEC>
__device__ __forceinline__ void load_entries(const __nv_bfloat16* vals, const int* cols,
                                             float (&x)[VEC], int (&c)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 ci = __ldcs(reinterpret_cast<const int4*>(cols));
    const uint2 xv = __ldcs(reinterpret_cast<const uint2*>(vals));
    c[0] = ci.x, c[1] = ci.y, c[2] = ci.z, c[3] = ci.w;
    x[0] = bf16_lo(xv.x), x[1] = bf16_hi(xv.x), x[2] = bf16_lo(xv.y), x[3] = bf16_hi(xv.y);
  } else if constexpr (VEC == 2) {
    const int2 ci = __ldcs(reinterpret_cast<const int2*>(cols));
    const unsigned xv = __ldcs(reinterpret_cast<const unsigned*>(vals));
    c[0] = ci.x, c[1] = ci.y;
    x[0] = bf16_lo(xv), x[1] = bf16_hi(xv);
  } else {
    c[0] = __ldcs(cols);
    x[0] = bf16_lo(__ldcs(reinterpret_cast<const unsigned short*>(vals)));
  }
}

// Threads of the chunk kernel's block (one block a chunk), and the vectors
// of VEC entries each thread loads in its one batch. -DGATHER_CHUNK_THREADS
// (a multiple of 32 up to 512) builds another count, for a same-run
// comparison (dev/torch_kernel_ab.py --other-flags); the count fixes the
// order of a chunk's sum.
#ifndef GATHER_CHUNK_THREADS
#define GATHER_CHUNK_THREADS 64
#endif
constexpr int kChunkThreads = GATHER_CHUNK_THREADS;
static_assert(kChunkThreads % 32 == 0 && kChunkThreads <= 512, "GATHER_CHUNK_THREADS");
template <int VEC>
constexpr int kChunkVecs = kChunk / (VEC * kChunkThreads);

// The last index i < size with a[i] <= key, where a ascends and a[0] <= key:
// the warp probes 32 evenly spaced entries a step (two steps for R <= 1024).
// Every lane passes the same key and gets the same index.
__device__ __forceinline__ int warp_find(const int* __restrict__ a, int size, long long key,
                                         int lane) {
  int lo = 0, hi = size;  // the answer is in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const int at = lo + lane * step;
    // lane 0 probes lo, which holds: at least one bit is set
    const unsigned le = __ballot_sync(kFull, at < hi && __ldg(a + at) <= key);
    lo += (31 - __clz(le)) * step;
    hi = lo + step < hi ? lo + step : hi;
  }
  return lo;
}

// The sum of long row `row`'s chunk partials (the chunk kernel's partials
// and the plan it ran on), in every lane: lane l adds partials l, l + 32,
// ... of the row from 0, then a xor butterfly adds the lanes. Warp-uniform.
// (The consumers take the plan as separate __restrict__ arguments, not a
// struct: through a struct's pointers their other loads lose the read-only
// path.)
__device__ __forceinline__ float row_partials(const float* __restrict__ partials,
                                              const int* __restrict__ long_rows,
                                              const int* __restrict__ long_chunk_ptr,
                                              int num_long, long long row, int lane) {
  const int r = warp_find(long_rows, num_long, row, lane);
  const int c0 = __ldg(long_chunk_ptr + r), c1 = __ldg(long_chunk_ptr + r + 1);
  float t = 0.f;
  for (int c = c0 + lane; c < c1; c += 32) t += partials[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  return t;
}

// Thread t's share of one chunk [begin, end) (at most kChunk entries), in
// this order: with VEC = 4, the head entry begin + t if t is below the
// entries before the first index that is a multiple of 4; then the
// vectors t, t + kChunkThreads, ... of 4 entries from there, in batches of
// 16 entries (a batch's loads first, then its gathers, then its FMAs); then
// the tail entry past the last whole vector, if any. With VEC = 1 (arrays
// not 16-byte aligned) the entries t, t + kChunkThreads, ... in the same
// batches.
template <typename V, int VEC>
__device__ __forceinline__ float chunk_dot(const V* __restrict__ vals, const int* __restrict__ cols,
                                           const float* __restrict__ w, long long begin,
                                           long long end, int t) {
  constexpr int NV = kChunkVecs<VEC>;
  constexpr int NB = NV < 16 / VEC ? NV : 16 / VEC;  // vectors a batch: 16 entries
  float acc = 0.f;
  long long a = begin;
  if constexpr (VEC > 1) {
    const long long head = (VEC - (begin & (VEC - 1))) & (VEC - 1);
    if (t < head && begin + t < end)
      acc = fmaf(to_float(vals[begin + t]), __ldg(w + __ldg(cols + begin + t)), acc);
    a = begin + head < end ? begin + head : end;
  }
  const int nv = (int)((end - a) / VEC);
#pragma unroll
  for (int b0 = 0; b0 < NV; b0 += NB) {
    float x[NB][VEC], wv[NB][VEC];
    int c[NB][VEC];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int v = t + (b0 + b) * kChunkThreads;
      if (v < nv) load_entries<VEC>(vals + a + (long long)v * VEC, cols + a + (long long)v * VEC,
                                    x[b], c[b]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        wv[b][e] = t + (b0 + b) * kChunkThreads < nv ? __ldg(w + c[b][e]) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (t + (b0 + b) * kChunkThreads < nv) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc = fmaf(x[b][e], wv[b][e], acc);
      }
    }
  }
  if constexpr (VEC > 1) {
    const long long k = a + (long long)nv * VEC + t;
    if (t < VEC && k < end) acc = fmaf(to_float(vals[k]), __ldg(w + __ldg(cols + k)), acc);
  }
  return acc;
}

// One partial per chunk of the long rows, a block a chunk: chunk c of the
// plan is chunk c - long_chunk_ptr[r] of row long_rows[r], for the last r
// with long_chunk_ptr[r] <= c. The partial is each thread's chunk_dot, the
// lanes of a warp added by a xor butterfly, the warps added in warp order.
template <typename V, int VEC>
__global__ void __launch_bounds__(kChunkThreads)
gather_chunks_kernel(const V* __restrict__ tv, const int* __restrict__ tc,
                     const int* __restrict__ row_ptr, const int* __restrict__ long_rows,
                     const int* __restrict__ long_chunk_ptr, int num_long,
                     const float* __restrict__ w, long long num_chunks,
                     float* __restrict__ partials) {
  __shared__ float warp_s[kChunkThreads / 32];
  const int t = threadIdx.x, lane = t & 31;
  for (long long c = blockIdx.x; c < num_chunks; c += gridDim.x) {
    const int r = warp_find(long_chunk_ptr, num_long, c, lane);
    const int row = __ldg(long_rows + r);
    const long long begin =
        __ldg(row_ptr + row) + (c - __ldg(long_chunk_ptr + r)) * (long long)kChunk;
    const long long row_end = __ldg(row_ptr + row + 1);
    const long long end = begin + kChunk < row_end ? begin + kChunk : row_end;
    float acc = chunk_dot<V, VEC>(tv, tc, w, begin, end, t);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) warp_s[t >> 5] = acc;
    __syncthreads();
    if (t == 0) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kChunkThreads / 32; ++q) s += warp_s[q];
      partials[c] = s;
    }
    __syncthreads();  // the next chunk overwrites warp_s
  }
}

// Lane j's share of one ELL row of nvec vectors: vectors j, j + G, ... in
// order, kBatch at a time (loads, then gathers, then FMAs).
template <typename V, int G, int VEC>
__device__ __forceinline__ float ell_lane_dot(const V* __restrict__ vals,
                                              const int* __restrict__ cols, int nvec,
                                              const float* __restrict__ w, int j) {
  float acc = 0.f;
  for (int v0 = j; v0 < nvec; v0 += G * kBatch) {
    float x[kBatch][VEC], wv[kBatch][VEC];
    int c[kBatch][VEC];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int v = v0 + b * G;
      if (v < nvec) load_entries<VEC>(vals + v * VEC, cols + v * VEC, x[b], c[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) wv[b][e] = v0 + b * G < nvec ? __ldg(w + c[b][e]) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (v0 + b * G < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc = fmaf(x[b][e], wv[b][e], acc);
      }
    }
  }
  return acc;
}

// Rows of 32 / G a warp: each row's ELL entries by its group of G lanes,
// then each row's tail entries (or, for a long row with a chunk plan, the
// sum of its chunk partials) by the whole warp. CHUNKED: a chunk plan is
// given; without one the kernel holds no code for it (compiled in, the
// plan's search changed the register allocation of the rest, and the ELL
// rows ran 1-3% slower).
template <typename V, int G, int VEC, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ ev, const int* __restrict__ ec, int width,
                   const V* __restrict__ tv, const int* __restrict__ tc,
                   const int* __restrict__ row_ptr, const float* __restrict__ partials,
                   const int* __restrict__ long_rows, const int* __restrict__ long_chunk_ptr,
                   int num_long, const float* __restrict__ w, long long n,
                   float* __restrict__ out) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int q = lane / G, j = lane % G;
  const int nvec = width / VEC;
  const long long step = (long long)gridDim.x * kWarpsPerBlock * kRowsPerWarp;
  const long long first = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  for (long long base = first * kRowsPerWarp; base < n; base += step) {
    const long long row = base + q;
    float acc = 0.f;
    if (nvec > 0 && row < n)
      acc = ell_lane_dot<V, G, VEC>(ev + row * width, ec + row * width, nvec, w, j);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (row_ptr != nullptr) {
      // lane k < kRowsPerWarp holds the tail bounds of row base + k and, for
      // a long row of the chunk plan, the range of its chunk partials
      int tb = 0, te = 0, cb = 0, ce = 0;
      if (lane < kRowsPerWarp && base + lane < n) {
        tb = row_ptr[base + lane];
        te = row_ptr[base + lane + 1];
      }
      if constexpr (CHUNKED) {
        for (unsigned todo = __ballot_sync(kFull, te - tb > kChunk); todo != 0;
             todo &= todo - 1) {
          const int k = __ffs(todo) - 1;
          const int r = warp_find(long_rows, num_long, base + k, lane);
          if (lane == k) cb = __ldg(long_chunk_ptr + r), ce = __ldg(long_chunk_ptr + r + 1);
        }
      }
      for (unsigned todo = __ballot_sync(kFull, te > tb); todo != 0; todo &= todo - 1) {
        const int k = __ffs(todo) - 1;
        int c0 = 0, c1 = 0;
        if constexpr (CHUNKED) c0 = __shfl_sync(kFull, cb, k), c1 = __shfl_sync(kFull, ce, k);
        float t = 0.f;
        if (c1 > c0) {
          for (int c = c0 + lane; c < c1; c += 32) t += partials[c];
        } else {
          t = lane_dot(tv, tc, w, __shfl_sync(kFull, tb, k), __shfl_sync(kFull, te, k), lane, 0.f);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
        if (q == k) acc += t;
      }
    }
    if (j == 0 && row < n) out[row] = acc;
  }
}

// Columns of one run (a warp's lanes) and entries a warp stages at a time
// in the segment kernel.
constexpr int kRunSegments = 32;
constexpr int kPiece = 64;

// Short segments (the transpose X'r: one segment a column, about two
// entries each at d = 10^7): a warp owns a run of 32 consecutive segments,
// lane l segment c0 + l. The warp loads the run's entries once, coalesced,
// kPiece at a time, gathers w at each entry's index, and stages the
// (value, w) pairs in shared memory; then each lane adds its own segment's
// pairs in entry order with fmaf from 0, carrying its sum across pieces. A
// long segment (more than kChunk entries, with a chunk plan) takes the sum
// of its chunk partials, added by the whole warp (row_partials), and its
// entries are skipped: the run is staged as the stretches of segments
// between such lanes. A run whose segments hold at most one entry each
// (most runs of a d = 10^8 tail) is not staged: each lane adds its own
// entry. The kernel is latency-bound, so it keeps to 32 registers a thread
// (eight blocks, a full SM, resident). CHUNKED: a chunk plan is given (as
// in the row kernel, without one the kernel holds no code for it).
template <typename V, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, 8)
gather_segments_kernel(const V* __restrict__ tv, const int* __restrict__ tc,
                       const int* __restrict__ seg_ptr, const float* __restrict__ partials,
                       const int* __restrict__ long_rows, const int* __restrict__ long_chunk_ptr,
                       int num_long, const float* __restrict__ w, long long n,
                       float* __restrict__ out) {
  __shared__ float vals_s[kWarpsPerBlock][kPiece];
  __shared__ float w_s[kWarpsPerBlock][kPiece];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* const sv = vals_s[warp];
  float* const sw = w_s[warp];
  // n < 2^31 (the wrapper checks it): segment indices fit in 32 bits
  const unsigned nu = (unsigned)n;
  const int runs = (int)((n + kRunSegments - 1) / kRunSegments);
  const int warps = gridDim.x * kWarpsPerBlock;
  for (int run = blockIdx.x * kWarpsPerBlock + warp; run < runs; run += warps) {
    const unsigned seg = (unsigned)run * kRunSegments + lane;
    // past the last segment: an empty range at the end of the entries
    const int b = seg_ptr[seg < nu ? seg : nu];
    const int e = seg_ptr[seg < nu ? seg + 1 : nu];
    if (__all_sync(kFull, e - b <= 1)) {
      // no segment of the run holds two entries (a chunked one holds more
      // than kChunk): each lane adds its own entry, if any, without staging
      float acc = 0.f;
      if (e > b) acc = fmaf(to_float(tv[b]), __ldg(w + __ldg(tc + b)), 0.f);
      if (seg < nu) out[seg] = acc;
      continue;
    }
    const unsigned skip = CHUNKED ? __ballot_sync(kFull, e - b > kChunk) : 0u;
    float acc = 0.f;
    if constexpr (CHUNKED) {
      for (unsigned todo = skip; todo != 0; todo &= todo - 1) {
        const int k = __ffs(todo) - 1;
        const float t = row_partials(partials, long_rows, long_chunk_ptr, num_long,
                                     (long long)run * kRunSegments + k, lane);
        if (lane == k) acc = t;
      }
    }
    // Stage and add the stretch of lanes [lo, hi), which holds no chunked lane.
    auto stretch = [&](int lo, int hi) {
      const int sb = __shfl_sync(kFull, b, lo), se = __shfl_sync(kFull, e, hi - 1);
      const bool mine = lane >= lo && lane < hi;
      for (int p = sb; p < se; p += kPiece) {
        float x[kPiece / 32], wx[kPiece / 32];
        int c[kPiece / 32];
#pragma unroll
        for (int j = 0; j < kPiece / 32; ++j) {
          const int k = p + j * 32 + lane;
          if (k < se) {
            x[j] = to_float(tv[k]);
            c[j] = __ldg(tc + k);
          }
        }
#pragma unroll
        for (int j = 0; j < kPiece / 32; ++j)
          if (p + j * 32 + lane < se) wx[j] = __ldg(w + c[j]);
#pragma unroll
        for (int j = 0; j < kPiece / 32; ++j) {
          if (p + j * 32 + lane < se) {
            sv[j * 32 + lane] = x[j];
            sw[j * 32 + lane] = wx[j];
          }
        }
        __syncwarp();
        if (mine) {
          const int kb = b > p ? b : p, ke = e < p + kPiece ? e : p + kPiece;
#pragma unroll 4
          for (int k = kb; k < ke; ++k) acc = fmaf(sv[k - p], sw[k - p], acc);
        }
        __syncwarp();
      }
    };
    if (skip == 0) {
      stretch(0, kRunSegments);
    } else {
      for (int lo = 0; lo < kRunSegments;) {
        // the stretch [lo, hi): lanes up to the next chunked one
        const unsigned ahead = skip >> lo;
        const int hi = ahead ? lo + __ffs(ahead) - 1 : kRunSegments;
        if (hi > lo) stretch(lo, hi);
        lo = hi + 1;
      }
    }
    if (seg < nu) out[seg] = acc;
  }
}

int blocks_for(long long items) {
  long long b = (items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

// What the consumers read of the chunk plan: the chunk kernel's partials
// (null: no row is long, or no plan was given) and the long rows with where
// their chunks start.
struct Chunks {
  const void* partials;
  const void* long_rows;
  const void* long_chunk_ptr;
  int num_long;
};

template <typename V, int G, int VEC>
cudaError_t launch_rows(const void* ev, const void* ec, int width, const void* tv, const void* tc,
                        const void* row_ptr, const Chunks& ch, const void* w, long long n,
                        void* out, cudaStream_t s) {
  const int blocks = blocks_for((n + 32 / G - 1) / (32 / G));
  if (ch.partials != nullptr) {
    gather_rows_kernel<V, G, VEC, true><<<blocks, kThreads, 0, s>>>(
        (const V*)ev, (const int*)ec, width, (const V*)tv, (const int*)tc, (const int*)row_ptr,
        (const float*)ch.partials, (const int*)ch.long_rows, (const int*)ch.long_chunk_ptr,
        ch.num_long, (const float*)w, n, (float*)out);
  } else {
    gather_rows_kernel<V, G, VEC, false><<<blocks, kThreads, 0, s>>>(
        (const V*)ev, (const int*)ec, width, (const V*)tv, (const int*)tc, (const int*)row_ptr,
        nullptr, nullptr, nullptr, 0, (const float*)w, n, (float*)out);
  }
  return cudaGetLastError();
}

// The row kernel for G lanes a row and VEC entries a vector: G in {4, 8,
// 16} with VEC in {4, 2, 1}, or G = 32 (no ELL block) with VEC = 1.
template <typename V>
cudaError_t rows_for(int lanes, int vec, const void* ev, const void* ec, int width, const void* tv,
                     const void* tc, const void* row_ptr, const Chunks& chunks, const void* w,
                     long long n, void* out, cudaStream_t s) {
#define PHOTON_ROWS(G, VEC)         \
  if (lanes == G && vec == VEC)     \
    return launch_rows<V, G, VEC>(ev, ec, width, tv, tc, row_ptr, chunks, w, n, out, s);
  PHOTON_ROWS(4, 4)
  PHOTON_ROWS(4, 2)
  PHOTON_ROWS(4, 1)
  PHOTON_ROWS(8, 4)
  PHOTON_ROWS(8, 2)
  PHOTON_ROWS(8, 1)
  PHOTON_ROWS(16, 4)
  PHOTON_ROWS(16, 2)
  PHOTON_ROWS(16, 1)
  PHOTON_ROWS(32, 1)
#undef PHOTON_ROWS
  return cudaErrorInvalidValue;
}

template <typename V>
cudaError_t launch_segments(const void* tv, const void* tc, const void* row_ptr,
                            const Chunks& ch, const void* w, long long n, void* out,
                            cudaStream_t s) {
  const int blocks = blocks_for((n + kRunSegments - 1) / kRunSegments);
  if (ch.partials != nullptr) {
    gather_segments_kernel<V, true><<<blocks, kThreads, 0, s>>>(
        (const V*)tv, (const int*)tc, (const int*)row_ptr, (const float*)ch.partials,
        (const int*)ch.long_rows, (const int*)ch.long_chunk_ptr, ch.num_long, (const float*)w, n,
        (float*)out);
  } else {
    gather_segments_kernel<V, false><<<blocks, kThreads, 0, s>>>(
        (const V*)tv, (const int*)tc, (const int*)row_ptr, nullptr, nullptr, nullptr, 0,
        (const float*)w, n, (float*)out);
  }
  return cudaGetLastError();
}

template <typename V, int VEC>
cudaError_t launch_chunks(const void* tv, const void* tc, const void* row_ptr,
                          const void* long_rows, const void* long_chunk_ptr, int num_long,
                          const void* w, long long num_chunks, void* partials, cudaStream_t s) {
  const int blocks = (int)(num_chunks < kMaxBlocks ? num_chunks : kMaxBlocks);
  gather_chunks_kernel<V, VEC><<<blocks, kChunkThreads, 0, s>>>(
      (const V*)tv, (const int*)tc, (const int*)row_ptr, (const int*)long_rows,
      (const int*)long_chunk_ptr, num_long, (const float*)w, num_chunks, (float*)partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Entries of one chunk of a long row (the wrapper checks it against its own).
int sparse_gather_chunk() { return kChunk; }

// The segment kernel's rows a run and entries a piece, as 1000 * rows + entries.
int sparse_gather_segment_run() { return kRunSegments * 1000 + kPiece; }

// out[n] = ELL row sums (ev/ec [n, width], width may be 0 with null arrays)
// + tail row sums (tv/tc with row_ptr [n+1], or null). With partials non-null
// (from sparse_gather_chunks over the plan long_rows [num_long],
// long_chunk_ptr [num_long + 1]), a row of more than kChunk tail entries
// takes the sum of its chunk partials instead of its entries.
// lanes (4, 8 or 16; 32 when width is 0) share a row's ELL entries, read vec
// (4, 2 or 1, dividing width, each row's start aligned to it) at a time.
int sparse_gather_rows(int is_bf16, int lanes, int vec, const void* ev, const void* ec, int width,
                       const void* tv, const void* tc, const void* row_ptr, const void* partials,
                       const void* long_rows, const void* long_chunk_ptr, int num_long,
                       const void* w, long long n, void* out, void* stream) {
  if (width % vec != 0 || (width == 0) != (lanes == 32)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Chunks chunks{partials, long_rows, long_chunk_ptr, num_long};
  return (int)(is_bf16 ? rows_for<__nv_bfloat16>(lanes, vec, ev, ec, width, tv, tc, row_ptr,
                                                 chunks, w, n, out, s)
                       : rows_for<float>(lanes, vec, ev, ec, width, tv, tc, row_ptr, chunks, w,
                                         n, out, s));
}

// out[n] = tail row sums (tv/tc with row_ptr [n+1]) of short rows, a warp a
// run of 32 rows whose entries it stages; with partials non-null, a long
// row sums its chunk partials (as in sparse_gather_rows).
int sparse_gather_segments(int is_bf16, const void* tv, const void* tc, const void* row_ptr,
                           const void* partials, const void* long_rows,
                           const void* long_chunk_ptr, int num_long, const void* w, long long n,
                           void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Chunks chunks{partials, long_rows, long_chunk_ptr, num_long};
  return (int)(is_bf16 ? launch_segments<__nv_bfloat16>(tv, tc, row_ptr, chunks, w, n, out, s)
                       : launch_segments<float>(tv, tc, row_ptr, chunks, w, n, out, s));
}

// partials[num_chunks]: one sum per chunk of the plan long_rows [num_long],
// long_chunk_ptr [num_long + 1] (num_chunks = long_chunk_ptr[num_long]).
// vec 4 reads 16-byte vectors (tc 16-byte aligned, tv aligned to 4 values);
// vec 1 reads one entry at a time.
int sparse_gather_chunks(int is_bf16, int vec, const void* tv, const void* tc,
                         const void* row_ptr, const void* long_rows, const void* long_chunk_ptr,
                         int num_long, const void* w, long long num_chunks, void* partials,
                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_chunks < 1 || num_long < 1) return (int)cudaErrorInvalidValue;
#define PHOTON_CHUNKS(V, VEC)                                                             \
  return (int)launch_chunks<V, VEC>(tv, tc, row_ptr, long_rows, long_chunk_ptr, num_long, w, \
                                    num_chunks, partials, s);
  if (vec == 4) {
    if (is_bf16) PHOTON_CHUNKS(__nv_bfloat16, 4)
    PHOTON_CHUNKS(float, 4)
  }
  if (vec == 1) {
    if (is_bf16) PHOTON_CHUNKS(__nv_bfloat16, 1)
    PHOTON_CHUNKS(float, 1)
  }
#undef PHOTON_CHUNKS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
