// Shared neighbour-row gather for Hopper, and its VJP, two entries:
//   o4d_gather  replaces occlusions4d_tpu/ops/pallas_attention.py::
//               _gather_kernel (:814): the fused decoder's producer of the raw
//               [feats | pos] rows that the interpolation and both attention
//               layers read when the abstract cloud is large (M >= 1024);
//   o4d_scatter replaces _scatter_kernel (:837): the gather's backward, the
//               sum of the consumers' row cotangents added to the key rows;
//   o4d_scatter_interp  the decoder route's counterpart of _scatter_kernel
//               and _interp_g_bwd_kernel (:1294) together: the scatter with
//               the gathered interpolation's row cotangent folded in, so that
//               term is never written as a dense (B, KE, N, C) tensor.
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
//
// The fold: the gathered interpolation's cotangent of row (b, j, n) is
// (w_nj / sum_i w_ni) go[b, n] in its first E channels for j < k_interp and
// zero elsewhere (841 MB of mostly zeros at one cv1 train frame, which
// autograd would add to the attention layers' dg before the scatter). A
// pre-pass forms the (B, N, k) normalised weights; the scatter block adds, per
// row in the same order, dg's value plus w go[b, n], rounded as that sum of
// two tensors would be: the result equals o4d_scatter of (dg + the
// o4d_interp_g_bwd rows) bit for bit, and it reads go (B N E floats, mostly
// from L2) instead of writing and re-reading the dense term.
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

// The gathered interpolation's term, folded into the scatter (o4d_scatter_interp):
// row r of dg (B, KE, N, C) is (b, j, n); for j < k its first E channels also
// receive wn[b, n, j] * go[b, n, :].
struct Fold {
  const float* wn;  // (B, N, k) normalised weights.
  const float* go;  // (B, N, E).
  int N, KE, E, k;
};

// Normalised interpolation weights, one thread per query: the arithmetic of
// csrc/interp.cu's interp_g_bwd_kernel, so the fold adds the very values
// o4d_interp_g_bwd writes.
__global__ void interp_weights_kernel(const float* __restrict__ kd,
                                      float* __restrict__ wn, int BN, int KS, int k,
                                      float eps) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= BN) return;
  float w[32], den = 0.f;
  for (int j = 0; j < k; ++j) {
    w[j] = 1.0f / (sqrtf(fmaxf(kd[(size_t)q * KS + j], 0.f)) + eps);
    den += w[j];
  }
  for (int j = 0; j < k; ++j) wn[(size_t)q * k + j] = w[j] / den;
}

// One row of the scatter's input: dg's row r and, folded, the
// interpolation's term of that row (w go[b, n], or none for j >= k).
struct RowRef {
  const float* src;  // dg's row (null: no dg).
  const float* go;   // go[b, n] (null: no interpolation term).
  float w;
};

template <bool FOLD>
__device__ __forceinline__ RowRef row_ref(const float* dg, int r, int C, const Fold& f) {
  RowRef x{dg + (size_t)r * C, nullptr, 0.f};
  if (FOLD) {
    if (dg == nullptr) x.src = nullptr;
    const int n = r % f.N, bj = r / f.N, j = bj % f.KE;
    if (j < f.k) {
      const size_t q = (size_t)(bj / f.KE) * f.N + n;
      x.w = f.wn[q * f.k + j];
      x.go = f.go + q * f.E;
    }
  }
  return x;
}

// dg + (w go), each rounded on its own: the bits of adding o4d_interp_g_bwd's
// rows to dg before o4d_scatter.
template <bool FOLD>
__device__ __forceinline__ float row_value(const RowRef& x, int c, int C, int E) {
  float v = ((!FOLD || x.src != nullptr) && c < C) ? x.src[c] : 0.f;
  if (FOLD && x.go != nullptr && c < E) v = __fadd_rn(v, __fmul_rn(x.w, x.go[c]));
  return v;
}

template <bool FOLD>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_kernel(const float* __restrict__ dg, const int* __restrict__ rows,
                   const int* __restrict__ offsets, float* __restrict__ dfv, int C,
                   Fold f) {
  const int key = blockIdx.x, tid = threadIdx.x;
  const int begin = offsets[key], end = offsets[key + 1];
  for (int c0 = 0; c0 < C; c0 += kScatterThreads * kScatterCols) {
    float acc[kScatterCols];
#pragma unroll
    for (int t = 0; t < kScatterCols; ++t) acc[t] = 0.f;
    int i = begin;
    for (; i + 4 <= end; i += 4) {
      float v[4][kScatterCols];  // four rows' loads in flight before their adds.
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const RowRef x = row_ref<FOLD>(dg, rows[i + u], C, f);
#pragma unroll
        for (int t = 0; t < kScatterCols; ++t)
          v[u][t] = row_value<FOLD>(x, c0 + tid + t * kScatterThreads, C, f.E);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)  // in row order.
#pragma unroll
        for (int t = 0; t < kScatterCols; ++t) acc[t] += v[u][t];
    }
    for (; i < end; ++i) {
      const RowRef x = row_ref<FOLD>(dg, rows[i], C, f);
#pragma unroll
      for (int t = 0; t < kScatterCols; ++t) {
        const int c = c0 + tid + t * kScatterThreads;
        if (c < C) acc[t] += row_value<FOLD>(x, c, C, f.E);
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
  scatter_kernel<false><<<keys, kScatterThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dg, (const int*)rows, (const int*)offsets, (float*)dfv, C, Fold{});
  return (int)cudaGetLastError();
}

// The scatter with the gathered interpolation's backward folded in: dfv as
// o4d_scatter of dg (B, KE, N, C) (dg may be null: no other consumer of the
// rows, zeros), plus, for every row (b, j < k, n), (w_nj / sum_i w_ni)
// go[b, n] in its first E channels. kd (B, N, KS) f32 (first k columns
// used); go (B, N, E) f32; wn (B, N, k) f32 scratch; rows / offsets: the
// inverse index of the rows of dg (ops/attention.py::scatter_index).
extern "C" int o4d_scatter_interp(const void* dg, const void* rows,
                                  const void* offsets, const void* kd,
                                  const void* go, void* wn, void* dfv, int keys,
                                  int C, int B, int N, int KE, int KS, int E, int k,
                                  float eps, void* stream) {
  if (keys <= 0 || C <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || k > KE || E > C || B <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int BN = B * N;
  interp_weights_kernel<<<(BN + 127) / 128, 128, 0, s>>>((const float*)kd, (float*)wn,
                                                         BN, KS, k, eps);
  scatter_kernel<true><<<keys, kScatterThreads, 0, s>>>(
      (const float*)dg, (const int*)rows, (const int*)offsets, (float*)dfv, C,
      Fold{(const float*)wn, (const float*)go, N, KE, E, k});
  return (int)cudaGetLastError();
}
