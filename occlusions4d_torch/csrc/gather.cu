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
//   o4d_gather_bf16, the bf16 compute mode (precision='fast'): the same rows
//            rounded to bf16 (to nearest even) as they are copied, stored as
//            f32, as the TPU kernel stores them (_gather_call pins f32). The
//            bf16 consumers (o4d_interp_g_bf16, o4d_attn_g_bf16) read f32
//            rows: bf16 storage would halve the rows' bytes, but the whole
//            gather is a small share of a cv1 chunk's decode (PERF.md), and
//            f32 keeps one row loader for both modes.
//   scatter: dfv[b, m, :] = sum over (j < k, n) with ki[b, n, j] = m of
//            dg[b, j, n, :]
//   o4d_scatter_bf16, the bf16 compute mode (the train step's
//            fused_decoder_dtype='bf16'; _scatter_kernel's _mm2 rounds the
//            rows, the VJP casts the sum to the gather source's bf16): each
//            dg row rounded to bf16 before the per-key sum, the sum to bf16
//            after it (stored as f32); the same stages and bytes.
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
// matmul over a sequential grid; here it is a gather in reverse, on the card
// end to end: the inverse index of the rows (every key's dg rows in
// ascending row order) by the counting sort of csrc/inverse_index.cuh, then
// per-key sums over chunks of 64 sorted rows, a key cut across chunks
// finished by adding its chunk partials in chunk order. No atomics, no host
// sort: the result is bit-reproducible from call to call, and a key that
// owns thousands of rows (key skew: a near key shared by many queries) is
// spread over as many blocks instead of one long block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "inverse_index.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// RND: the bf16 mode (each value rounded to bf16 as it is copied).
template <bool RND>
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
  for (int c = lane; c < C; c += 32)
    dst[c] = RND ? __bfloat162float(__float2bfloat16_rn(src[c])) : src[c];
}

template <bool RND>
int gather(const void* fv, const void* ki, void* g, int B, int N, int M, int C, int KS, int k,
           void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * k * N;
  const size_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  gather_kernel<RND><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fv, (const int*)ki, (float*)g, B, N, M, C, KS, k);
  return (int)cudaGetLastError();
}

// Entry p = (b k + j) N + n of the scatter: row (b, j, n) of dg (B, KE, N, C).
struct ScatterRows {
  static constexpr bool kWeighted = false;
  struct Entry {
    const float* src;
  };
  const float* dg;
  int N, KE, k;
  long long C;
  __device__ Entry entry(int p, float*) const {
    const int bj = p / N, n = p - bj * N, b = bj / k, j = bj - b * k;
    return Entry{dg + (((size_t)b * KE + j) * N + n) * C};
  }
  __device__ float value(const Entry& x, int c) const { return __ldg(x.src + c); }
};

}  // namespace

// fv (B, M, C) f32; ki (B, N, KS) int32 (first k columns used);
// g (B, k, N, C) f32.
extern "C" int o4d_gather(const void* fv, const void* ki, void* g, int B, int N,
                          int M, int C, int KS, int k, void* stream) {
  return gather<false>(fv, ki, g, B, N, M, C, KS, k, stream);
}

// o4d_gather in the bf16 mode (the same arguments; g holds bf16 values).
extern "C" int o4d_gather_bf16(const void* fv, const void* ki, void* g, int B, int N,
                               int M, int C, int KS, int k, void* stream) {
  return gather<true>(fv, ki, g, B, N, M, C, KS, k, stream);
}

// Workspace of the scatter entries: int32 and f32 element counts. The int32
// workspace starts with offsets (B M + 1) and perm (B k N): the inverse
// index, key x owning the entries perm[offsets[x] : offsets[x + 1]], entry
// p = (b k + j) N + n being row (b, j, n) of dg.
extern "C" void o4d_scatter_workspace(int B, int N, int M, int k, int C,
                                      long long* ints, long long* floats) {
  const long long total = (long long)B * k * N, keys = (long long)B * M;
  *ints = o4d_index::index_ints(total, keys);
  *floats = o4d_index::sum_floats(total, C);
}

// The inverse index alone, into iws (layout at o4d_scatter_workspace).
extern "C" int o4d_scatter_index(const void* ki, void* iws, int B, int N, int M,
                                 int KS, int k, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || (long long)B * k * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const o4d_index::Entries x{(const int*)ki, N, M, KS, k, true};
  return (int)o4d_index::build(x, B * k * N, B * M, (int*)iws, (cudaStream_t)stream);
}

namespace {

template <bool RND>
int scatter(const void* dg, const void* ki, void* iws, void* fws, void* dfv, int B, int N,
            int M, int KE, int KS, int k, int C, void* stream) {
  if (B <= 0 || M <= 0 || C <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || k > KE || N < 0 ||
      (long long)B * KE * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int total = B * k * N, keys = B * M;
  const o4d_index::Entries x{(const int*)ki, N, M, KS, k, true};
  cudaError_t e = o4d_index::build(x, total, keys, (int*)iws, s);
  if (e != cudaSuccess) return (int)e;
  const ScatterRows rows{(const float*)dg, N, KE, k, C};
  return (int)o4d_index::sum<ScatterRows, false, RND>(rows, x, (const int*)iws,
                                                      (float*)fws, (float*)dfv, total, keys,
                                                      C, s);
}

}  // namespace

// dg (B, KE, N, C) f32 (rows j < k used); ki (B, N, KS) int32; iws / fws the
// workspace (o4d_scatter_workspace); dfv (B, M, C) f32, every row written.
extern "C" int o4d_scatter(const void* dg, const void* ki, void* iws, void* fws,
                           void* dfv, int B, int N, int M, int KE, int KS, int k,
                           int C, void* stream) {
  return scatter<false>(dg, ki, iws, fws, dfv, B, N, M, KE, KS, k, C, stream);
}

// o4d_scatter in the bf16 mode (the same arguments; dfv holds bf16 values).
extern "C" int o4d_scatter_bf16(const void* dg, const void* ki, void* iws, void* fws,
                                void* dfv, int B, int N, int M, int KE, int KS, int k,
                                int C, void* stream) {
  return scatter<true>(dg, ki, iws, fws, dfv, B, N, M, KE, KS, k, C, stream);
}
