// Shared neighbour-row gather for Hopper. Replaces
// occlusions4d_tpu/ops/pallas_attention.py::_gather_kernel (:814): the fused
// decoder's producer of the raw [feats | pos] rows that the interpolation and
// both attention layers read when the abstract cloud is large (M >= 1024).
//
// Function (f32, a copy; bit-equal to its plain version):
//   g[b, j, n, :] = fv[b, ki[b, n, j], :]      for j < k, fv = [feats2 | pos2]
//
// What bounds it on the H100: bytes. At a cv1 decode chunk (32768 queries,
// k 14, C 291) it writes 534 MB and reads the 2.5 MB key matrix (L2-resident)
// and the indices: about 0.16 ms at 3.35 TB/s. Design: one warp per output
// row (b, j, n), its lanes striding the row's C floats, so reads of the
// source row and writes of the output row are each one contiguous run. Rows
// are C * 4 = 1164 bytes apart at cv1, not 16-byte aligned, so the copy uses
// scalar loads; offsets are size_t (g holds 133 M floats per cv1 chunk).

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
