// Shared neighbour-row gather for Hopper, and its VJP, two entries:
//   o4d_gather  replaces occlusions4d_tpu/ops/pallas_attention.py::
//               _gather_kernel (:814): the fused decoder's producer of the raw
//               [feats | pos] rows that the interpolation and both attention
//               layers read when the abstract cloud is large (M >= 1024);
//   o4d_scatter replaces _scatter_kernel (:837): the gather's backward, the
//               sum of the consumers' row cotangents added to the key rows.
//
// Functions (f32):
//   gather:  g[b, j, n, :] = fv[b, ki[b, n, j], :]   for j < k, fv = [feats2 | pos2]
//            (a copy; bit-equal to its plain version)
//   scatter: dfv[b, m, :] = sum over (j < k, n) with ki[b, n, j] = m of
//            dg[b, j, n, :]
//
// What bounds them on the H100: bytes. At a cv1 decode chunk (32768 queries,
// k 14, C 291) the gather writes 534 MB and reads the 2.5 MB key matrix
// (L2-resident) and the indices: about 0.16 ms at 3.35 TB/s. Design: one warp
// per output row (b, j, n), its lanes striding the row's C floats, so reads of
// the source row and writes of the output row are each one contiguous run.
// Rows are C * 4 = 1164 bytes apart at cv1, not 16-byte aligned, so the copy
// uses scalar loads; offsets are size_t (g holds 133 M floats per cv1 chunk).
//
// The scatter reads all of dg once (841 MB at one cv1 train frame, 3 x 14 x
// 17203 rows: 0.25 ms) and writes the small dfv. The TPU sums it as a one-hot
// matmul over a sequential grid; here it is a gather in reverse: the wrapper
// builds an inverse index (a stable sort of the key of every dg row, so each
// key's rows come in ascending row order, plus per-key offsets), and one block
// per key row (b, m) adds its rows in that order, threads over the channels,
// and writes dfv[b, m] once. No atomics and no scratch: the result is
// bit-reproducible from call to call. Key skew (many queries sharing a near
// key) makes one block long, not the sum wrong; four rows' loads are issued
// before their adds to keep more bytes in flight per block.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float* __restrict__ fv, const int* __restrict__ ki,
                  float* __restrict__ g, int B, int N, int M, int C, int KS,
                  int k) {
  const size_t row = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const size_t rows = (size_t)B * k * N;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int n = (int)(row % N);
  const size_t bj = row / N;
  const int j = (int)(bj % k), b = (int)(bj / k);
  const int idx = ki[((size_t)b * N + n) * KS + j];
  const float* src = fv + ((size_t)b * M + idx) * C;
  float* dst = g + row * C;
  for (int c = lane; c < C; c += 32) dst[c] = src[c];
}

constexpr int kScatterThreads = 128;
constexpr int kScatterCols = 4;  // columns per thread and pass: C <= 512 in one.

__global__ void __launch_bounds__(kScatterThreads)
    scatter_kernel(const float* __restrict__ dg, const int* __restrict__ rows,
                   const int* __restrict__ offsets, float* __restrict__ dfv, int C) {
  const int key = blockIdx.x, tid = threadIdx.x;
  const int begin = offsets[key], end = offsets[key + 1];
  for (int c0 = 0; c0 < C; c0 += kScatterThreads * kScatterCols) {
    float acc[kScatterCols];
#pragma unroll
    for (int t = 0; t < kScatterCols; ++t) acc[t] = 0.f;
    int i = begin;
    for (; i + 4 <= end; i += 4) {
      float v[4][kScatterCols];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* src = dg + (size_t)rows[i + u] * C;
#pragma unroll
        for (int t = 0; t < kScatterCols; ++t) {
          const int c = c0 + tid + t * kScatterThreads;
          v[u][t] = c < C ? src[c] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)  // in row order.
#pragma unroll
        for (int t = 0; t < kScatterCols; ++t) acc[t] += v[u][t];
    }
    for (; i < end; ++i) {
      const float* src = dg + (size_t)rows[i] * C;
#pragma unroll
      for (int t = 0; t < kScatterCols; ++t) {
        const int c = c0 + tid + t * kScatterThreads;
        if (c < C) acc[t] += src[c];
      }
    }
#pragma unroll
    for (int t = 0; t < kScatterCols; ++t) {
      const int c = c0 + tid + t * kScatterThreads;
      if (c < C) dfv[(size_t)key * C + c] = acc[t];
    }
  }
}

}  // namespace

// fv (B, M, C) f32; ki (B, N, KS) int32 (first k columns used);
// g (B, k, N, C) f32.
extern "C" int o4d_gather(const void* fv, const void* ki, void* g, int B, int N,
                          int M, int C, int KS, int k, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * k * N;
  const size_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fv, (const int*)ki, (float*)g, B, N, M, C, KS, k);
  return (int)cudaGetLastError();
}

// dg: rows of C f32; rows (int32) and offsets (keys + 1, int32): the inverse
// index, key x owning rows[offsets[x] : offsets[x + 1]] (ops/attention.py::
// scatter_index); dfv (keys, C) f32, every row written.
extern "C" int o4d_scatter(const void* dg, const void* rows, const void* offsets,
                           void* dfv, int keys, int C, void* stream) {
  if (keys <= 0 || C <= 0) return 0;
  scatter_kernel<<<keys, kScatterThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dg, (const int*)rows, (const int*)offsets, (float*)dfv, C);
  return (int)cudaGetLastError();
}
