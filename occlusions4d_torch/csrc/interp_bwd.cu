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
// queries, E 288, k 8, M 531) that is about 64 MB, 19 us at 3.35 TB/s.
// Design, deterministic by construction (no float atomics): the grid is
// (G slots, B, E / 32 channel slices); one warp owns a slot's channel slice
// and walks its queries (n = slot, slot + G, ...) in order, adding each
// neighbour's weighted row into an M x 32 partial held in shared memory.
// Every lane owns one channel, so no two threads ever add to the same
// address. The partials go to a scratch array and a second kernel sums the G
// slots of each example in a fixed order, so two calls give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;  // channels per block, one per lane.

__global__ void __launch_bounds__(kSlice)
    interp_bwd_kernel(const int* __restrict__ ki, const float* __restrict__ kd,
                      const float* __restrict__ g, float* __restrict__ part,
                      int N, int M, int E, int KS, int k, int G, float eps) {
  extern __shared__ float acc[];  // (M, kSlice)
  const int slot = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int e = blockIdx.z * kSlice + lane;
  for (int m = 0; m < M; ++m) acc[m * kSlice + lane] = 0.f;
  float w[32];
  int id[32];
  for (int n = slot; n < N; n += G) {
    const size_t row = (size_t)b * N + n;
    float den = 0.f;
    for (int j = 0; j < k; ++j) {
      w[j] = 1.0f / (sqrtf(fmaxf(kd[row * KS + j], 0.f)) + eps);
      id[j] = ki[row * KS + j];
      den += w[j];
    }
    const float gv = e < E ? g[row * E + e] : 0.f;
    for (int j = 0; j < k; ++j) acc[id[j] * kSlice + lane] += (w[j] / den) * gv;
  }
  if (e < E) {
    float* out = part + ((size_t)b * G + slot) * M * E;
    for (int m = 0; m < M; ++m) out[(size_t)m * E + e] = acc[m * kSlice + lane];
  }
}

// dfeats[b, m, e] = sum over the example's G slots, in slot order.
__global__ void interp_bwd_reduce(const float* __restrict__ part,
                                  float* __restrict__ dfeats, int B, int M, int E,
                                  int G) {
  const size_t per_b = (size_t)M * E;
  const size_t total = (size_t)B * per_b;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / per_b, o = i % per_b;
    const float* p = part + b * G * per_b + o;
    float s = 0.f;
    for (int x = 0; x < G; ++x) s += p[(size_t)x * per_b];
    dfeats[i] = s;
  }
}

}  // namespace

// Shared memory of one block: an M x 32 partial.
extern "C" long long o4d_interp_bwd_smem_bytes(int M) {
  return (long long)M * kSlice * (long long)sizeof(float);
}

// ki (B, N, KS) int32, kd (B, N, KS) f32 (first k columns used); g (B, N, E)
// f32; scratch (B * G * M * E) f32; dfeats (B, M, E) f32 (fully written).
extern "C" int o4d_interp_bwd(const void* ki, const void* kd, const void* g,
                              void* scratch, void* dfeats, int B, int N, int M,
                              int E, int KS, int k, int G, float eps,
                              void* stream) {
  if (B <= 0 || M <= 0 || E <= 0) return 0;
  if (k < 1 || k > 32 || k > KS || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)M * kSlice * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      interp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G, B, (E + kSlice - 1) / kSlice);
  interp_bwd_kernel<<<grid, kSlice, smem, s>>>(
      (const int*)ki, (const float*)kd, (const float*)g, (float*)scratch, N, M,
      E, KS, k, G, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * M * E;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 4096
                               ? (total + threads - 1) / threads
                               : 4096);
  interp_bwd_reduce<<<blocks, threads, 0, s>>>((const float*)scratch,
                                              (float*)dfeats, B, M, E, G);
  return (int)cudaGetLastError();
}
