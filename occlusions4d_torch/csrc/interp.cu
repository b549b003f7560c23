// Inverse-distance kNN feature interpolation for Hopper. Replaces
// occlusions4d_tpu/ops/pallas_attention.py::_interp_kernel (:554), in its
// use_idx form: the neighbours come from the kNN kernel (knn_extract).
//
// Function, per query n over its first k neighbours j (ascending):
//   w_j   = 1 / (sqrt(max(kd_j, 0)) + eps)          (kd: squared distance)
//   out_n = (sum_j w_j f[ki_j]) / (sum_j w_j)
//
// What bounds it on the H100: bytes. Each query reads k index/distance pairs
// and k feature rows (the key set is small and stays in L2) and writes one
// E-wide row; at the decoder's 32768 x 288 chunk the output write dominates
// (37.7 MB per chunk). Design: one thread block per query; the k weights are
// formed once in shared memory, then the threads stride over the E channels so
// that both the gathered feature reads and the output write are coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void interp_kernel(const int* __restrict__ ki,
                              const float* __restrict__ kd,
                              const float* __restrict__ feats,
                              float* __restrict__ out, int N, int M, int E,
                              int KS, int k, float eps) {
  __shared__ float w[32];
  __shared__ int id[32];
  __shared__ float den;
  const int n = blockIdx.x, b = blockIdx.y;
  const size_t row = (size_t)b * N + n;
  if (threadIdx.x < k) {
    w[threadIdx.x] = 1.0f / (sqrtf(fmaxf(kd[row * KS + threadIdx.x], 0.f)) + eps);
    id[threadIdx.x] = ki[row * KS + threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) s += w[j];
    den = s;
  }
  __syncthreads();
  const float* fb = feats + (size_t)b * M * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) acc += w[j] * fb[(size_t)id[j] * E + e];
    out[row * E + e] = acc / den;
  }
}

}  // namespace

// ki (B, N, KS) int32, kd (B, N, KS) f32 (first k columns used);
// feats (B, M, E) f32; out (B, N, E) f32.
extern "C" int o4d_interp(const void* ki, const void* kd, const void* feats,
                          void* out, int B, int N, int M, int E, int KS, int k,
                          float eps, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (k < 1 || k > 32 || k > KS) return (int)cudaErrorInvalidValue;
  dim3 grid(N, B);
  interp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ki, (const float*)kd, (const float*)feats, (float*)out, N, M,
      E, KS, k, eps);
  return (int)cudaGetLastError();
}
