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
// - A row longer than kChunk tail entries (G1's one segment of 2^24 entries)
//   is not left to one warp's serial loop: the wrapper passes a chunk plan,
//   a first kernel gives each chunk its own warp and writes one partial per
//   chunk, and the row kernel adds a row's partials in chunk order (as B1's
//   reduce adds its partials in block order). Rows with no chunks in the
//   plan (every row of kChunk entries or fewer) read their entries directly.
// - Many short rows and no ELL block (the transpose X'r of a sparse batch:
//   one row per column, about two entries each at d = 10^7, most columns
//   empty at d = 10^8): load by entry, add by row (gather_segments_kernel).
//   A warp owns a run of 32 consecutive rows, reads their row pointers
//   coalesced, and reads the run's entries once with coalesced loads, 64 at
//   a time, gathering w at each; the (value, w) pairs go to shared memory,
//   and each lane adds its own row's pairs in entry order with fmaf from 0
//   -- the operations, in the order, of one thread walking its row, so the
//   sums are bitwise those of a thread per row. A row with chunks adds its
//   partials in order and its entries are not staged. An empty row costs its
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
// then each row's tail entries (or, with a chunk plan, its chunk partials
// in order) by the whole warp.
template <typename V, int G, int VEC>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ ev, const int* __restrict__ ec, int width,
                   const V* __restrict__ tv, const int* __restrict__ tc,
                   const int* __restrict__ row_ptr, const float* __restrict__ partials,
                   const int* __restrict__ chunk_ptr, const float* __restrict__ w, long long n,
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
      // lane k < kRowsPerWarp holds the tail bounds of row base + k
      int tb = 0, te = 0, cb = 0, ce = 0;
      if (lane < kRowsPerWarp && base + lane < n) {
        tb = row_ptr[base + lane];
        te = row_ptr[base + lane + 1];
        if (partials != nullptr) {
          cb = chunk_ptr[base + lane];
          ce = chunk_ptr[base + lane + 1];
        }
      }
      for (unsigned todo = __ballot_sync(kFull, te > tb); todo != 0; todo &= todo - 1) {
        const int k = __ffs(todo) - 1;
        const int c0 = __shfl_sync(kFull, cb, k), c1 = __shfl_sync(kFull, ce, k);
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
// segment with chunks (more than kChunk entries) adds its chunk partials in
// order instead, and its entries are skipped: the run is staged as the
// stretches of segments between such lanes. A run whose segments hold at
// most one entry each (most runs of a d = 10^8 tail) is not staged: each
// lane adds its own entry. The kernel is latency-bound, so it keeps to 32
// registers a thread (eight blocks, a full SM, resident).
template <typename V>
__global__ void __launch_bounds__(kThreads, 8)
gather_segments_kernel(const V* __restrict__ tv, const int* __restrict__ tc,
                       const int* __restrict__ seg_ptr, const float* __restrict__ partials,
                       const int* __restrict__ chunk_ptr, const float* __restrict__ w,
                       long long n, float* __restrict__ out) {
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
    const bool chunked =
        partials != nullptr && seg < nu && chunk_ptr[seg + 1] > chunk_ptr[seg];
    float acc = 0.f;
    if (chunked) {
      for (int c = chunk_ptr[seg]; c < chunk_ptr[seg + 1]; ++c) acc += partials[c];
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
    const unsigned skip = __ballot_sync(kFull, chunked);
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

template <typename V, int G, int VEC>
cudaError_t launch_rows(const void* ev, const void* ec, int width, const void* tv, const void* tc,
                        const void* row_ptr, const void* partials, const void* chunk_ptr,
                        const void* w, long long n, void* out, cudaStream_t s) {
  gather_rows_kernel<V, G, VEC><<<blocks_for((n + 32 / G - 1) / (32 / G)), kThreads, 0, s>>>(
      (const V*)ev, (const int*)ec, width, (const V*)tv, (const int*)tc, (const int*)row_ptr,
      (const float*)partials, (const int*)chunk_ptr, (const float*)w, n, (float*)out);
  return cudaGetLastError();
}

// The row kernel for G lanes a row and VEC entries a vector: G in {4, 8,
// 16} with VEC in {4, 2, 1}, or G = 32 (no ELL block) with VEC = 1.
template <typename V>
cudaError_t rows_for(int lanes, int vec, const void* ev, const void* ec, int width, const void* tv,
                     const void* tc, const void* row_ptr, const void* partials,
                     const void* chunk_ptr, const void* w, long long n, void* out,
                     cudaStream_t s) {
#define PHOTON_ROWS(G, VEC)                                                                     \
  if (lanes == G && vec == VEC)                                                                 \
    return launch_rows<V, G, VEC>(ev, ec, width, tv, tc, row_ptr, partials, chunk_ptr, w, n, out, \
                                  s);
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

}  // namespace

extern "C" {

// Entries of one chunk of a long row (the wrapper checks it against its own).
int sparse_gather_chunk() { return kChunk; }

// The segment kernel's rows a run and entries a piece, as 1000 * rows + entries.
int sparse_gather_segment_run() { return kRunSegments * 1000 + kPiece; }

// out[n] = ELL row sums (ev/ec [n, width], width may be 0 with null arrays)
// + tail row sums (tv/tc with row_ptr [n+1], or null). With partials and
// chunk_ptr non-null, a row with chunks takes its chunk partials instead.
// lanes (4, 8 or 16; 32 when width is 0) share a row's ELL entries, read vec
// (4, 2 or 1, dividing width, each row's start aligned to it) at a time.
int sparse_gather_rows(int is_bf16, int lanes, int vec, const void* ev, const void* ec, int width,
                       const void* tv, const void* tc, const void* row_ptr, const void* partials,
                       const void* chunk_ptr, const void* w, long long n, void* out,
                       void* stream) {
  if (width % vec != 0 || (width == 0) != (lanes == 32)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? rows_for<__nv_bfloat16>(lanes, vec, ev, ec, width, tv, tc, row_ptr,
                                                 partials, chunk_ptr, w, n, out, s)
                       : rows_for<float>(lanes, vec, ev, ec, width, tv, tc, row_ptr, partials,
                                         chunk_ptr, w, n, out, s));
}

// out[n] = tail row sums (tv/tc with row_ptr [n+1]) of short rows, a warp a
// run of 32 rows whose entries it stages; with partials and chunk_ptr
// non-null, a row with chunks sums its partials.
int sparse_gather_segments(int is_bf16, const void* tv, const void* tc, const void* row_ptr,
                           const void* partials, const void* chunk_ptr, const void* w,
                           long long n, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = blocks_for((n + kRunSegments - 1) / kRunSegments);
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
