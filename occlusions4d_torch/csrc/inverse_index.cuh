// Deterministic inverse index and per-key sums, shared by csrc/interp_bwd.cu,
// csrc/gather.cu and csrc/attn_bwd.cu (included, compiled into each library).
//
// A list of entries e (a neighbour list, or the rows of a gather) each names
// one key row b M + ki[b, n, j]. Two stages, no float atomics, the same bits
// on every call, nothing of M's size in shared memory:
//  1. The inverse index: for every key, its entries in ascending order. A
//     stable counting sort: each block sorts one tile of kTile entries by the
//     unique composite (key, position in the tile) in shared memory (bitonic
//     network), which gives every entry its rank among the tile's entries of
//     its key and each (key, tile) its count; a per-key scan over the tiles
//     and one scan over the keys turn the counts into offsets; a placement
//     pass writes perm[offsets[key] + tile base + rank] = e.
//  2. Per-key sums of one row per entry: the sorted entries are cut into
//     chunks of kChunk. A block walks its chunk in order, threads over the
//     columns, adding each entry's row (times its weight, where the rows
//     carry one) for each run of one key. A run that lies wholly in the
//     chunk is written to out; the run a chunk starts with, if its key
//     began in an earlier chunk, goes to the chunk's head slot, and the run
//     it ends with, if its key goes on past the chunk, to its tail slot. A
//     last pass adds, for every key cut across chunks, its first chunk's
//     tail and the later chunks' heads in chunk order, and zeroes the keys
//     no entry names. A key held by many entries is spread over many blocks
//     instead of making one block long.
//     In the bf16 compute mode (RND) each entry's row is rounded to bf16
//     before it is added (the TPU kernels' _mm2 rounds the rows of the
//     transposed one-hot product) and each key's finished f32 sum is
//     rounded to bf16 (stored as f32), as the TPU VJPs cast the sum to the
//     operand's bf16 dtype; with ACCUM the caller rounds after its last sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace o4d_index {

constexpr int kTile = 2048;         // entries per counting-sort tile (< 2^16).
constexpr int kSortThreads = 1024;  // one compare-exchange pair per thread.
constexpr int kScanThreads = 1024;
constexpr int kChunk = 64;          // sorted entries per summing block.
constexpr int kSumThreads = 128;
constexpr int kCols = 4;            // columns per thread and pass: C <= 512 in one.

// The entries of a (B, N, >= k) neighbour grid ki (row stride KS), keys
// b M + ki[b, n, j]. n-major: e = (b N + n) k + j (a neighbour list);
// j-major: e = (b k + j) N + n (the rows of a (B, k, N, C) gather).
struct Entries {
  const int* ki;
  int N, M, KS, k;
  bool jmajor;
};

__device__ __forceinline__ int entry_key(const Entries& x, int e) {
  if (x.jmajor) {
    const int bj = e / x.N, n = e - bj * x.N, b = bj / x.k, j = bj - b * x.k;
    return b * x.M + x.ki[((size_t)b * x.N + n) * x.KS + j];
  }
  const int bn = e / x.k, j = e - bn * x.k;
  return (bn / x.N) * x.M + x.ki[(size_t)bn * x.KS + j];
}

// x rounded to bf16 (to nearest even) and back.
__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kSortThreads)
    index_tile_kernel(Entries x, int* __restrict__ cnt, int* __restrict__ lrank,
                      int total, int T) {
  __shared__ unsigned long long s[kTile];
  __shared__ int head[kTile];
  const int t = blockIdx.x, base = t * kTile;
  const int n_in = min(kTile, total - base);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x)
    s[i] = i < n_in ? ((unsigned long long)entry_key(x, base + i) << 16) | (unsigned)i
                    : ~0ull;  // padding sorts last.
  __syncthreads();
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kTile / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  // head[p]: the position where p's key run starts (an inclusive max-scan of
  // the run starts).
  for (int p = threadIdx.x; p < kTile; p += blockDim.x)
    head[p] = (p == 0 || (s[p - 1] >> 16) != (s[p] >> 16)) ? p : 0;
  __syncthreads();
  for (int off = 1; off < kTile; off <<= 1) {
    int v[kTile / kSortThreads];
#pragma unroll
    for (int u = 0; u < kTile / kSortThreads; ++u) {
      const int p = threadIdx.x + u * kSortThreads;
      v[u] = p >= off ? max(head[p], head[p - off]) : head[p];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kTile / kSortThreads; ++u)
      head[threadIdx.x + u * kSortThreads] = v[u];
    __syncthreads();
  }
  for (int p = threadIdx.x; p < n_in; p += blockDim.x) {
    const unsigned long long v = s[p];
    lrank[base + (int)(v & 0xffffu)] = p - head[p];
    if (p == n_in - 1 || (s[p + 1] >> 16) != (v >> 16))
      cnt[(size_t)(v >> 16) * T + t] = p - head[p] + 1;
  }
}

// One warp per key: cnt[key, :] -> its exclusive scan over the tiles, and
// the key's total.
__global__ void index_key_scan_kernel(int* __restrict__ cnt, int* __restrict__ keytot,
                                      int keys, int T) {
  const int key = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (key >= keys) return;
  int* c = cnt + (size_t)key * T;
  int run = 0;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const int v = t < T ? c[t] : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (t < T) c[t] = run + x - v;
    run += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) keytot[key] = run;
}

// One block: offsets[key] = sum of keytot over the keys before it;
// offsets[keys] = the total.
__global__ void __launch_bounds__(kScanThreads)
    index_offsets_kernel(const int* __restrict__ keytot, int* __restrict__ offsets,
                         int keys) {
  __shared__ int wsum[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int i0 = 0; i0 < keys; i0 += kScanThreads) {
    const int i = i0 + threadIdx.x;
    const int v = i < keys ? keytot[i] : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = wsum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    const int incl = x + (warp > 0 ? wsum[warp - 1] : 0);
    if (i < keys) offsets[i] = carry + incl - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry += incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[keys] = carry;
}

__global__ void index_place_kernel(Entries x, const int* __restrict__ cnt,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ lrank, int* __restrict__ perm,
                                   int total, int T) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int key = entry_key(x, e);
  perm[offsets[key] + cnt[(size_t)key * T + e / kTile] + lrank[e]] = e;
}

inline int n_tiles(long long total) { return (int)((total + kTile - 1) / kTile); }
inline int n_chunks(long long total) { return (int)((total + kChunk - 1) / kChunk); }

// int32 workspace of build(): offsets (keys + 1), perm (total), then scratch.
inline long long index_ints(long long total, long long keys) {
  return (keys + 1) + total + keys + total + keys * n_tiles(total);
}

// f32 workspace of the chunked sums: head and tail slots of C floats.
inline long long sum_floats(long long total, int C) { return 2LL * n_chunks(total) * C; }

// The inverse index of `total` entries over `keys` keys into iws: offsets at
// iws[0 : keys + 1], perm at iws[keys + 1 : keys + 1 + total].
inline cudaError_t build(const Entries& x, int total, int keys, int* iws,
                         cudaStream_t s) {
  const int T = n_tiles(total);
  int* offsets = iws;
  int* perm = offsets + keys + 1;
  int* keytot = perm + total;
  int* lrank = keytot + keys;
  int* cnt = lrank + total;
  cudaError_t err;
  if (total > 0) {
    err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)keys * T, s);
    if (err != cudaSuccess) return err;
    index_tile_kernel<<<T, kSortThreads, 0, s>>>(x, cnt, lrank, total, T);
    index_key_scan_kernel<<<(keys + 7) / 8, 256, 0, s>>>(cnt, keytot, keys, T);
  } else {
    err = cudaMemsetAsync(keytot, 0, sizeof(int) * (size_t)keys, s);
    if (err != cudaSuccess) return err;
  }
  index_offsets_kernel<<<1, kScanThreads, 0, s>>>(keytot, offsets, keys);
  if (total > 0)
    index_place_kernel<<<(total + 255) / 256, 256, 0, s>>>(x, cnt, offsets, lrank, perm,
                                                           total, T);
  return cudaGetLastError();
}

// Per-key sums of ROWS's rows in entry order. ROWS provides a per-entry
// record `Entry` (formed once per entry by `entry(e, &w)`) and `value(entry,
// col)`, the entry's row at column col < C. With ROWS::kWeighted each row is
// scaled by the weight w that entry() set, as w * value + acc (one fused
// multiply-add); without, entry() leaves w alone and rows are added as they
// are. With ACCUM the sums are added to out instead of stored (a key no
// entry names is then left as it is). RND: the bf16 mode, each row
// (w * value, rounded once) rounded to bf16 before it is added, each stored
// sum rounded to bf16 (not with ACCUM).
template <class ROWS, bool ACCUM, bool RND>
__global__ void __launch_bounds__(kSumThreads)
    sum_kernel(ROWS rows, Entries x, const int* __restrict__ perm,
               const int* __restrict__ offsets, float* __restrict__ out,
               float* __restrict__ head, float* __restrict__ tail, int total, int C) {
  __shared__ typename ROWS::Entry esh[kChunk];
  __shared__ float wsh[ROWS::kWeighted ? kChunk : 1];
  __shared__ int ksh[kChunk];
  const int c = blockIdx.x, lo = c * kChunk, hi = lo + kChunk;
  const int cnt = min(kChunk, total - lo);
  const int tid = threadIdx.x;
  if (tid < cnt) {
    const int e = perm[lo + tid];
    float w = 1.f;
    esh[tid] = rows.entry(e, &w);
    if (ROWS::kWeighted) wsh[tid] = w;
    ksh[tid] = entry_key(x, e);
  }
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += kSumThreads * kCols) {
    float acc[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[t] = 0.f;
    int key = ksh[0];
    // Writes the finished run of `key` (block-uniform branch).
    auto flush = [&]() {
      const int s = offsets[key], f = offsets[key + 1];
      const bool whole = s >= lo && f <= hi;
      float* dst = whole ? out + (size_t)key * C
                   : s < lo ? head + (size_t)c * C
                            : tail + (size_t)c * C;
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int col = c0 + tid + t * kSumThreads;
        if (col < C)
          dst[col] = (ACCUM && whole)         ? dst[col] + acc[t]
                     : (RND && !ACCUM && whole) ? to_bf16(acc[t])
                                                : acc[t];
        acc[t] = 0.f;
      }
    };
    for (int i0 = 0; i0 < cnt; i0 += 4) {
      float v[4][kCols];  // four entries' loads in flight before their adds.
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // The entry read once, outside the predicated loads: its row is then
        // addressed by constant offsets (c0 + tid + t kSumThreads).
        const typename ROWS::Entry en = esh[min(i0 + u, cnt - 1)];
        const bool live = i0 + u < cnt;
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int col = c0 + tid + t * kSumThreads;
          v[u][t] = (live && col < C) ? rows.value(en, col) : 0.f;
          if (RND && !ROWS::kWeighted) v[u][t] = to_bf16(v[u][t]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // in entry order.
        if (i0 + u >= cnt) break;
        if (ksh[i0 + u] != key) {
          flush();
          key = ksh[i0 + u];
        }
        if (ROWS::kWeighted && RND) {
          const float w = wsh[i0 + u];
#pragma unroll
          for (int t = 0; t < kCols; ++t) acc[t] += to_bf16(__fmul_rn(w, v[u][t]));
        } else if (ROWS::kWeighted) {
          const float w = wsh[i0 + u];
#pragma unroll
          for (int t = 0; t < kCols; ++t) acc[t] += w * v[u][t];
        } else {
#pragma unroll
          for (int t = 0; t < kCols; ++t) acc[t] += v[u][t];
        }
      }
    }
    flush();
  }
}

// Per key: zeros when no entry names it (left as is with ACCUM); the sum of
// its chunk partials, in chunk order, when its run is cut across chunks
// (RND: rounded to bf16, not with ACCUM).
template <bool ACCUM, bool RND>
__global__ void __launch_bounds__(kSumThreads)
    finish_kernel(const int* __restrict__ offsets, const float* __restrict__ head,
                  const float* __restrict__ tail, float* __restrict__ out, int C) {
  const int key = blockIdx.x;
  const int s = offsets[key], f = offsets[key + 1];
  float* dst = out + (size_t)key * C;
  if (f == s) {
    if (!ACCUM)
      for (int col = threadIdx.x; col < C; col += blockDim.x) dst[col] = 0.f;
    return;
  }
  const int cs = s / kChunk, ce = (f - 1) / kChunk;
  if (cs == ce) return;
  for (int col = threadIdx.x; col < C; col += blockDim.x) {
    float acc = tail[(size_t)cs * C + col];
    for (int ch = cs + 1; ch <= ce; ++ch) acc += head[(size_t)ch * C + col];
    dst[col] = ACCUM ? dst[col] + acc : RND ? to_bf16(acc) : acc;
  }
}

// out (keys, C) = the per-key sums of rows over the index that build() left
// in iws; fws holds sum_floats(total, C) floats. RND: the bf16 mode.
template <class ROWS, bool ACCUM, bool RND = false>
cudaError_t sum(const ROWS& rows, const Entries& x, const int* iws, float* fws,
                float* out, int total, int keys, int C, cudaStream_t s) {
  const int* offsets = iws;
  const int* perm = offsets + keys + 1;
  float* head = fws;
  float* tail = head + (size_t)n_chunks(total) * C;
  if (total > 0)
    sum_kernel<ROWS, ACCUM, RND><<<n_chunks(total), kSumThreads, 0, s>>>(
        rows, x, perm, offsets, out, head, tail, total, C);
  finish_kernel<ACCUM, RND><<<keys, kSumThreads, 0, s>>>(offsets, head, tail, out, C);
  return cudaGetLastError();
}

}  // namespace o4d_index
