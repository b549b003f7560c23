// Backward of the inverse-distance kNN interpolation for Hopper. Replaces
// occlusions4d_tpu/ops/pallas_attention.py::_interp_bwd_kernel (:661), in its
// use_idx form (neighbours and squared distances from knn_extract).
//
// Function: the gradient of out_n = sum_j w_nj f[ki_nj] / sum_j w_nj with
// respect to the key features only (the weights are functions of positions,
// which carry no gradient):
//   w_nj      = 1 / (sqrt(max(kd_nj, 0)) + eps)
//   dfeats[m] = sum_n sum_{j<k} [ki_nj = m] (w_nj / sum_i w_ni) g_n
//
// What bounds it on the H100: bytes. It reads g (N x E) and k index/distance
// pairs per query and writes M x E; at the gv1 train shapes (3 x 17920
// queries, E 288, k 8, M 531) that is about 64 MB, 19 us at 3.35 TB/s. The
// pull design below reads each g row once per neighbour (k times), mostly
// from L2, in exchange for needing no atomics.
//
// Design, deterministic by construction (no float atomics, the same bits on
// every call), in two stages that share nothing with M's size in shared
// memory (no cap on M):
//  1. An inverse index of the flat (B, N, k) neighbour list: for every key
//     b M + m, its entries e = (b N + n) k + j in ascending order. A stable
//     counting sort: each block sorts one tile of kTile entries by the
//     unique composite (key, position in the tile) in shared memory (bitonic
//     network), which gives every entry its rank among the tile's entries of
//     its key and each (key, tile) its count; a per-key scan over the tiles
//     and one scan over the keys turn the counts into offsets; a placement
//     pass writes perm[offsets[key] + tile base + rank] = e.
//  2. Summing: the sorted entries are cut into chunks of kChunk. A block
//     forms its chunk's normalised weights from kd, then walks the chunk in
//     order, threads over the E channels, adding w * g_n for each run of one
//     key. A run that lies wholly in the chunk is written to dfeats; the run
//     a chunk starts with, if its key began in an earlier chunk, goes to the
//     chunk's head slot, and the run it ends with, if its key goes on past
//     the chunk, to its tail slot. A last pass adds, for every key cut across
//     chunks, its first chunk's tail and the later chunks' heads in chunk
//     order, and zeroes the keys no query names. A key held by many queries
//     is spread over many blocks instead of making one block long.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;         // entries per counting-sort tile (< 2^16).
constexpr int kSortThreads = 1024;  // one compare-exchange pair per thread.
constexpr int kChunk = 64;          // sorted entries per summing block.
constexpr int kSumThreads = 128;
constexpr int kCols = 4;            // channels per thread and pass: E <= 512 in one.
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int entry_key(const int* __restrict__ ki, int e, int N,
                                         int M, int KS, int k) {
  const int bn = e / k, j = e - bn * k;
  return (bn / N) * M + ki[(size_t)bn * KS + j];
}

__global__ void __launch_bounds__(kSortThreads)
    index_tile_kernel(const int* __restrict__ ki, int* __restrict__ cnt,
                      int* __restrict__ lrank, int total, int N, int M, int KS,
                      int k, int T) {
  __shared__ unsigned long long s[kTile];
  __shared__ int head[kTile];
  const int t = blockIdx.x, base = t * kTile;
  const int n_in = min(kTile, total - base);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x)
    s[i] = i < n_in ? ((unsigned long long)entry_key(ki, base + i, N, M, KS, k) << 16) |
                          (unsigned)i
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
__global__ void index_key_scan_kernel(int* __restrict__ cnt,
                                      int* __restrict__ keytot, int keys, int T) {
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

__global__ void index_place_kernel(const int* __restrict__ ki,
                                   const int* __restrict__ cnt,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ lrank,
                                   int* __restrict__ perm, int total, int N, int M,
                                   int KS, int k, int T) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int key = entry_key(ki, e, N, M, KS, k);
  perm[offsets[key] + cnt[(size_t)key * T + e / kTile] + lrank[e]] = e;
}

__global__ void __launch_bounds__(kSumThreads)
    interp_bwd_sum_kernel(const int* __restrict__ ki, const float* __restrict__ kd,
                          const float* __restrict__ g, const int* __restrict__ perm,
                          const int* __restrict__ offsets, float* __restrict__ dfeats,
                          float* __restrict__ head, float* __restrict__ tail,
                          int total, int N, int M, int E, int KS, int k, float eps) {
  __shared__ float wsh[kChunk];
  __shared__ int rsh[kChunk], ksh[kChunk];
  const int c = blockIdx.x, lo = c * kChunk, hi = lo + kChunk;
  const int cnt = min(kChunk, total - lo);
  const int tid = threadIdx.x;
  if (tid < cnt) {
    const int e = perm[lo + tid];
    const int bn = e / k, j = e - bn * k;
    const float* d = kd + (size_t)bn * KS;
    float den = 0.f, wj = 0.f;
    for (int i = 0; i < k; ++i) {
      const float w = 1.0f / (sqrtf(fmaxf(d[i], 0.f)) + eps);
      den += w;
      if (i == j) wj = w;
    }
    wsh[tid] = wj / den;
    rsh[tid] = bn;
    ksh[tid] = (bn / N) * M + ki[(size_t)bn * KS + j];
  }
  __syncthreads();
  for (int c0 = 0; c0 < E; c0 += kSumThreads * kCols) {
    float acc[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[t] = 0.f;
    int key = ksh[0];
    // Writes the finished run of `key` (block-uniform branch).
    auto flush = [&]() {
      const int s = offsets[key], f = offsets[key + 1];
      float* dst = (s >= lo && f <= hi) ? dfeats + (size_t)key * E
                   : s < lo            ? head + (size_t)c * E
                                       : tail + (size_t)c * E;
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int col = c0 + tid + t * kSumThreads;
        if (col < E) dst[col] = acc[t];
        acc[t] = 0.f;
      }
    };
    for (int i0 = 0; i0 < cnt; i0 += 4) {
      float v[4][kCols];  // four rows' loads in flight before their adds.
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* row = g + (size_t)rsh[min(i0 + u, cnt - 1)] * E;
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int col = c0 + tid + t * kSumThreads;
          v[u][t] = (i0 + u < cnt && col < E) ? row[col] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // in entry order.
        if (i0 + u >= cnt) break;
        if (ksh[i0 + u] != key) {
          flush();
          key = ksh[i0 + u];
        }
        const float w = wsh[i0 + u];
#pragma unroll
        for (int t = 0; t < kCols; ++t) acc[t] += w * v[u][t];
      }
    }
    flush();
  }
}

// Per key: zeros when no entry names it; the sum of its chunk partials, in
// chunk order, when its run is cut across chunks.
__global__ void __launch_bounds__(kSumThreads)
    interp_bwd_finish_kernel(const int* __restrict__ offsets,
                             const float* __restrict__ head,
                             const float* __restrict__ tail,
                             float* __restrict__ dfeats, int E) {
  const int key = blockIdx.x;
  const int s = offsets[key], f = offsets[key + 1];
  float* dst = dfeats + (size_t)key * E;
  if (f == s) {
    for (int col = threadIdx.x; col < E; col += blockDim.x) dst[col] = 0.f;
    return;
  }
  const int cs = s / kChunk, ce = (f - 1) / kChunk;
  if (cs == ce) return;
  for (int col = threadIdx.x; col < E; col += blockDim.x) {
    float acc = tail[(size_t)cs * E + col];
    for (int ch = cs + 1; ch <= ce; ++ch) acc += head[(size_t)ch * E + col];
    dst[col] = acc;
  }
}

inline int n_tiles(long long total) { return (int)((total + kTile - 1) / kTile); }
inline int n_chunks(long long total) { return (int)((total + kChunk - 1) / kChunk); }

}  // namespace

// Workspace of o4d_interp_bwd: int32 and f32 element counts. The int32
// workspace starts with offsets (B M + 1) and perm (B N k): the inverse index.
extern "C" void o4d_interp_bwd_workspace(int B, int N, int M, int E, int k,
                                         long long* ints, long long* floats) {
  const long long total = (long long)B * N * k, keys = (long long)B * M;
  *ints = (keys + 1) + total + keys + total + keys * n_tiles(total);
  *floats = 2LL * n_chunks(total) * E;
}

// ki (B, N, KS) int32, kd (B, N, KS) f32 (first k columns used); g (B, N, E)
// f32; iws / fws: the workspace (o4d_interp_bwd_workspace); dfeats (B, M, E)
// f32, every element written. B N k must stay below 2^31.
extern "C" int o4d_interp_bwd(const void* ki, const void* kd, const void* g,
                              void* iws, void* fws, void* dfeats, int B, int N,
                              int M, int E, int KS, int k, float eps,
                              void* stream) {
  if (B <= 0 || M <= 0 || E <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || N < 0) return (int)cudaErrorInvalidValue;
  const long long total_ll = (long long)B * N * k;
  if (total_ll >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int total = (int)total_ll, keys = B * M, T = n_tiles(total);
  cudaStream_t s = (cudaStream_t)stream;
  int* offsets = (int*)iws;
  int* perm = offsets + keys + 1;
  int* keytot = perm + total;
  int* lrank = keytot + keys;
  int* cnt = lrank + total;
  float* head = (float*)fws;
  float* tail = head + (size_t)n_chunks(total) * E;
  const int* kip = (const int*)ki;
  cudaError_t err;
  if (total > 0) {
    err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)keys * T, s);
    if (err != cudaSuccess) return (int)err;
    index_tile_kernel<<<T, kSortThreads, 0, s>>>(kip, cnt, lrank, total, N, M, KS, k, T);
    index_key_scan_kernel<<<(keys + 7) / 8, 256, 0, s>>>(cnt, keytot, keys, T);
  } else {
    err = cudaMemsetAsync(keytot, 0, sizeof(int) * (size_t)keys, s);
    if (err != cudaSuccess) return (int)err;
  }
  index_offsets_kernel<<<1, kScanThreads, 0, s>>>(keytot, offsets, keys);
  if (total > 0) {
    index_place_kernel<<<(total + 255) / 256, 256, 0, s>>>(kip, cnt, offsets, lrank, perm,
                                                           total, N, M, KS, k, T);
    interp_bwd_sum_kernel<<<n_chunks(total), kSumThreads, 0, s>>>(
        kip, (const float*)kd, (const float*)g, perm, offsets, (float*)dfeats, head, tail,
        total, N, M, E, KS, k, eps);
  }
  interp_bwd_finish_kernel<<<keys, kSumThreads, 0, s>>>(offsets, head, tail,
                                                        (float*)dfeats, E);
  return (int)cudaGetLastError();
}
